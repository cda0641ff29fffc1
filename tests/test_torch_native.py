"""The port's native host components (``video_features_tpu_torch/native``)
against the JAX package's and against cv2.

- the two C++ preprocess chains: ``np.array_equal`` to the JAX package's
  ``native`` chains (one source, byte for byte) at a downscale, an
  upscale and a non-square size, and equal at 1 and 4 threads; against
  the PIL chains within the JAX package's own bounds
  (``tests/test_native.py``): ImageNet mean < 0.01, max < 0.08; CLIP
  mean < 0.02, max < 0.15;
- the libav decoder, in one subprocess (an overrun aborts the process it
  happens in, never a pytest worker): clips 240 high at widths 320 to
  432, each frame retrieved into a buffer with a 256-byte sentinel tail
  that must come back untouched, the frames byte-equal to cv2's, the
  frame count and fps equal, and ``uni_12`` equal;
- ``--decoder`` and ``--host_preprocess``: an unknown backend refused, an
  explicit ``native`` with a forced build error raising and naming it,
  ``auto`` then opening cv2;
- end to end on a small CLIP (2 layers, 64 wide) and ResNet-18 at
  ``--host_preprocess native``: the port (decoder native) against the
  JAX package (decoder cv2) within 1e-4, the tolerance of those families'
  port tests; the port's native run against its PIL run within relative
  L2 0.05 (the JAX package's ``test_extract_clip_native_preprocess``);
- the fan-out's frame cache decoding with the config's decoder, and the
  feature cache's digest, which separates ``host_preprocess`` and not
  ``decoder``.
"""

import contextlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from video_features_tpu import native as jax_native
from video_features_tpu.config import ExtractionConfig as JaxConfig
from video_features_tpu.models.clip import model as jax_model
from video_features_tpu.models.clip.extract_clip import ExtractCLIP as JaxExtractCLIP
from video_features_tpu.models.resnet import convert as jax_convert
from video_features_tpu.models.resnet.extract_resnet import ExtractResNet as JaxExtractResNet
from video_features_tpu_torch import cli, native
from video_features_tpu_torch.config import (
    ExtractionConfig,
    parse_args,
    parse_serve_args,
    sanity_check,
)
from video_features_tpu_torch.extract.cache import config_digest
from video_features_tpu_torch.extract.plan import SharedFrameCache
from video_features_tpu_torch.io import video as vio
from video_features_tpu_torch.models.clip import model as port_model
from video_features_tpu_torch.models.clip.extract_clip import ExtractCLIP
from video_features_tpu_torch.models.resnet.extract_resnet import ExtractResNet
from video_features_tpu_torch.ops.preprocess import (
    CLIP_MEAN,
    CLIP_STD,
    imagenet_preprocess,
    normalize_chw,
    pil_center_crop,
    pil_resize,
    to_float_chw,
)
from video_features_tpu_torch.runtime.faults import CorruptVideoError
from video_features_tpu_torch.utils.synth import synth_video

from test_torch_clip import SMALL, openai_state_dict
from test_torch_resnet import _numpy_sd, seeded_resnet
from torch_threads import one_torch_thread  # noqa: F401 - an autouse fixture

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL = 1e-4
NATIVE_VS_PIL_REL_L2 = 0.05
PIL_BOUNDS = {"imagenet": (0.01, 0.08), "clip": (0.02, 0.15)}
SWEEP_WIDTHS = (320, 330, 340, 342, 418, 420, 424, 426, 428, 432)
SENTINEL = 256
FT = "CLIP-ViT-B/32"

pytestmark = pytest.mark.skipif(
    not native.available(), reason=f"no C++ toolchain: {native.build_error()}"
)


def _frames(n, h, w, seed=0):
    """Blocky seeded frames: 8x8 cells of random colour, so a resize has
    edges and flats to get right."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, size=(n, -(-h // 8), -(-w // 8), 3), dtype=np.uint8)
    return np.ascontiguousarray(np.kron(base, np.ones((1, 8, 8, 1), np.uint8))[:, :h, :w])


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@contextlib.contextmanager
def forced_build_error(name: str, message: str):
    """The native library ``name`` reads as failed to build, with
    ``message``, for the scope."""
    libs, errors = dict(native._libs), dict(native._errors)
    native._libs.pop(name, None)
    native._errors[name] = message
    try:
        yield
    finally:
        native._libs.clear()
        native._libs.update(libs)
        native._errors.clear()
        native._errors.update(errors)


# --- the preprocess chains ------------------------------------------------

CHAINS = {
    "imagenet": (native.imagenet_preprocess_batch, jax_native.imagenet_preprocess_batch),
    "clip": (native.clip_preprocess_batch, jax_native.clip_preprocess_batch),
}
SIZES = {"downscale": (240, 320), "upscale": (112, 100), "non_square": (360, 202)}


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_preprocess_equal_to_jax_and_thread_invariant(chain, size):
    ours, theirs = CHAINS[chain]
    frames = _frames(5, *SIZES[size], seed=len(size))
    out = ours(frames, threads=1)
    assert out.shape == (5, 3, 224, 224) and out.dtype == np.float32
    assert np.isfinite(out).all()
    assert np.array_equal(out, theirs(frames, threads=1))
    assert np.array_equal(out, ours(frames, threads=4))


def _pil_clip(frame):
    from PIL import Image

    img = pil_center_crop(pil_resize(frame, 224, interpolation=Image.BICUBIC), 224)
    return normalize_chw(to_float_chw(img), CLIP_MEAN, CLIP_STD)


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_preprocess_within_pil_bounds(chain):
    frames = _frames(3, 240, 320) if chain == "imagenet" else _frames(3, 360, 640)
    pil = imagenet_preprocess if chain == "imagenet" else _pil_clip
    diff = np.abs(CHAINS[chain][0](frames) - np.stack([pil(f) for f in frames]))
    mean_bound, max_bound = PIL_BOUNDS[chain]
    assert diff.mean() < mean_bound and diff.max() < max_bound


@pytest.mark.parametrize("call", [
    lambda: native.imagenet_preprocess_batch(np.zeros((2, 8, 8), np.uint8)),
    lambda: native.clip_preprocess_batch(np.zeros((2, 8, 8, 4), np.uint8)),
    lambda: native.imagenet_preprocess_batch(np.zeros((1, 8, 8, 3), np.uint8), resize_to=100),
    lambda: native.clip_preprocess_batch(np.zeros((1, 0, 8, 3), np.uint8)),
], ids=["ndim", "channels", "resize_below_crop", "empty"])
def test_preprocess_rejects_bad_shapes(call):
    with pytest.raises(ValueError):
        call()


def test_libraries_are_the_ports_own_builds():
    for name, libs, built in (("preprocess", (), native.available()),
                              ("decoder", native.DECODER_LIBS, native.decoder_available())):
        path = native.library_path(name, libs)
        assert path.parent == ROOT / "video_features_tpu_torch" / "_build"
        assert path.name.startswith(f"lib{name}-") and path.exists() == built
    src = pathlib.Path(native.__file__).parent
    assert (src / "preprocess.cpp").read_bytes() == (
        ROOT / "video_features_tpu" / "native" / "preprocess.cpp").read_bytes()


def test_a_library_that_does_not_load_is_rebuilt(monkeypatch, tmp_path):
    """A tree copied with its ``_build/`` from another host can hold a
    library of the current name that does not load here: one rebuild."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    stale = native.library_path("preprocess")
    stale.write_bytes(b"not an ELF object")
    with forced_build_error("preprocess", ""):
        native._errors.pop("preprocess")
        assert native._load("preprocess") is not None
        assert stale.read_bytes()[:4] == b"\x7fELF"
        out = native.clip_preprocess_batch(_frames(1, 64, 64))
    assert np.array_equal(out, native.clip_preprocess_batch(_frames(1, 64, 64)))


# --- the decoder: the width sweep in one subprocess ------------------------

SWEEP = r"""
import json, sys
import cv2
import numpy as np
from video_features_tpu_torch import native
from video_features_tpu_torch.io import video as vio

SENTINEL = int(sys.argv[1])
for path in sys.argv[2:]:
    cap = cv2.VideoCapture(path)
    reader = native.NativeVideoReader(path)
    h, w = reader.height, reader.width
    row = {"path": path, "width": w, "height": h, "frames": 0, "max_diff": 0,
           "tail_touched": 0, "native_fps": reader.fps,
           "cv2_fps": cap.get(cv2.CAP_PROP_FPS),
           "native_count": reader.frame_count,
           "cv2_count": int(cap.get(cv2.CAP_PROP_FRAME_COUNT))}
    while reader.grab() >= 0:
        buf = np.full(h * w * 3 + SENTINEL, 0xA5, np.uint8)
        reader.retrieve_into(buf)
        row["tail_touched"] += int((buf[-SENTINEL:] != 0xA5).sum())
        ok, ref = cap.read()
        if not ok:
            row["cv2_ended_early"] = True
            break
        ref = cv2.cvtColor(ref, cv2.COLOR_BGR2RGB)
        frame = buf[:-SENTINEL].reshape(h, w, 3)
        row["max_diff"] = max(row["max_diff"], int(np.abs(frame.astype(int) - ref).max()))
        row["frames"] += 1
    row["cv2_more"] = bool(cap.read()[0])
    reader.close()
    cap.release()
    opened = dict(native.readers_opened)
    nat = vio.extract_frames(path, "uni_12", "native")
    ref = vio.extract_frames(path, "uni_12", "cv2")
    row["uni_12_equal"] = (nat[1:] == ref[1:] and len(nat[0]) == len(ref[0]) == 12
                           and all(np.array_equal(a, b) for a, b in zip(nat[0], ref[0])))
    row["readers"] = {k: native.readers_opened[k] - opened[k] for k in opened}
    print(json.dumps(row), flush=True)
"""


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """{width: the sweep's row}, from one subprocess over all the clips."""
    if not native.decoder_available():
        pytest.skip(f"no libav to build the decoder: {native.decoder_build_error()}")
    root = tmp_path_factory.mktemp("sweep")
    clips = [synth_video(str(root / f"w{w}.mp4"), n_frames=20, width=w, height=240, seed=w)
             for w in SWEEP_WIDTHS]
    proc = subprocess.run(
        [sys.executable, "-c", SWEEP, str(SENTINEL), *clips], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    rows = [json.loads(line) for line in proc.stdout.splitlines()]
    return {row["width"]: row for row in rows}


@pytest.mark.parametrize("width", SWEEP_WIDTHS)
def test_decoder_byte_equal_to_cv2_with_tail_untouched(sweep, width):
    row = sweep[width]
    assert row["height"] == 240 and row["frames"] == 20
    assert row["tail_touched"] == 0, f"{row['tail_touched']} sentinel bytes written"
    assert row["max_diff"] == 0
    assert not row["cv2_more"] and "cv2_ended_early" not in row
    assert row["native_fps"] == row["cv2_fps"] == 25.0
    assert row["native_count"] == row["cv2_count"] == 20
    assert row["uni_12_equal"]
    assert row["readers"] == {"native": 2, "cv2": 2}  # probe + decode each


# --- --decoder and --host_preprocess --------------------------------------

def test_decoder_knob_rejects_unknown(tmp_path):
    with pytest.raises(ValueError, match="gstreamer"):
        vio.set_decoder("gstreamer")
    with pytest.raises(ValueError, match="gstreamer"):
        sanity_check(ExtractionConfig(decoder="gstreamer"))
    with pytest.raises(ValueError, match="host_preprocess"):
        sanity_check(ExtractionConfig(host_preprocess="opencv"))
    with pytest.raises(SystemExit):
        parse_args(["--feature_type", FT, "--decoder", "gstreamer"])
    cfg = parse_args(["--feature_type", FT, "--extract_method", "uni_3"])
    assert (cfg.decoder, cfg.host_preprocess) == ("auto", "pil")
    served = parse_serve_args(["--feature_types", FT, "--extract_method", "uni_3", "--cpu",
                               "--decoder", "native", "--host_preprocess", "native"])
    assert (served.extraction.decoder, served.extraction.host_preprocess) == ("native", "native")
    with pytest.raises(SystemExit):
        parse_serve_args(["--feature_types", FT, "--host_preprocess", "opencv"])


def test_explicit_native_decoder_raises_naming_the_build_error(sample_video):
    native.reset_reader_counts()
    with forced_build_error("decoder", "forced: no libavcodec here"):
        with pytest.raises(RuntimeError, match="forced: no libavcodec here"):
            vio.probe(sample_video, "native")
        assert vio.probe(sample_video, "auto") == vio.probe(sample_video, "cv2")
        assert native.readers_opened == {"native": 0, "cv2": 2}
    assert vio.probe(sample_video, "auto") == (25.0, 60)
    assert native.readers_opened["native"] == (1 if native.decoder_available() else 0)


def test_explicit_native_decoder_refuses_junk(tmp_path):
    if not native.decoder_available():
        pytest.skip(f"no libav: {native.decoder_build_error()}")
    junk = tmp_path / "junk.mp4"
    junk.write_bytes(b"not a video")
    with pytest.raises(CorruptVideoError, match="native decoder could not open"):
        vio.probe(str(junk), "native")
    with pytest.raises(CorruptVideoError, match="cannot open video"):
        vio.probe(str(junk), "auto")  # auto falls back to cv2, which refuses too


@pytest.mark.parametrize("cls,ft,extra", [
    (ExtractCLIP, FT, {"extract_method": "uni_3"}),
    (ExtractResNet, "resnet18", {}),
], ids=["clip", "resnet18"])
def test_host_preprocess_native_raises_at_setup_naming_the_build_error(
        sample_video, cls, ft, extra):
    cfg = ExtractionConfig(feature_type=ft, host_preprocess="native", cpu=True,
                           video_paths=[sample_video], allow_random_init=True, **extra)
    with forced_build_error("preprocess", "forced: no g++ here"):
        with pytest.raises(RuntimeError, match="forced: no g\\+\\+ here"):
            cls(cfg, external_call=True)
        # the knob acts only under --preprocess host
        assert not cls(cfg.replace(preprocess="device"), external_call=True)._native_decided()
    assert cls(cfg, external_call=True)._native_decided()


# --- end to end ------------------------------------------------------------

@pytest.fixture(scope="module")
def clip_342(tmp_path_factory):
    """A clip 342 wide: the JAX package's decoder drifts in its last six
    columns there; the port's must not."""
    root = tmp_path_factory.mktemp("e2e")
    return synth_video(str(root / "w342.mp4"), n_frames=40, width=342, height=240, seed=7)


@pytest.fixture
def small_tower(monkeypatch):
    monkeypatch.setitem(port_model.CONFIGS, FT, port_model.CLIPVisionConfig(**SMALL))
    monkeypatch.setitem(jax_model.CONFIGS, FT, jax_model.CLIPVisionConfig(**SMALL))


def test_clip_native_matches_jax_and_pil(clip_342, tmp_path, small_tower):
    weights = str(tmp_path / "clip_small.npz")
    np.savez(weights, **openai_state_dict())
    common = dict(feature_type=FT, video_paths=[clip_342], extract_method="uni_12",
                  weights_path=weights, cpu=True)

    def port(host_preprocess, decoder):
        ex = ExtractCLIP(ExtractionConfig(**common, host_preprocess=host_preprocess,
                                          decoder=decoder), external_call=True)
        return ex()[0][FT]

    native.reset_reader_counts()
    ours = port("native", "native")
    if native.decoder_available():
        assert native.readers_opened == {"native": 2, "cv2": 0}
    ref = JaxExtractCLIP(JaxConfig(**common, host_preprocess="native", decoder="cv2"),
                         external_call=True)([0])[0][FT]
    assert ours.shape == ref.shape == (12, SMALL["embed_dim"])
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)
    pil = port("pil", "cv2")
    assert _rel_l2(ours, pil) < NATIVE_VS_PIL_REL_L2
    assert not np.array_equal(ours, pil)  # the native chain did run


def test_resnet18_native_matches_jax_and_pil(clip_342, tmp_path):
    model = seeded_resnet("resnet18", seed=3)
    weights = tmp_path / "resnet18.pth"
    torch.save(model.state_dict(), weights)
    common = dict(feature_type="resnet18", video_paths=[clip_342], extraction_fps=5.0,
                  batch_size=5, cpu=True)

    def port(host_preprocess, decoder):
        cli.main(["--feature_type", "resnet18", "--cpu", "--video_paths", clip_342,
                  "--weights_path", str(weights), "--extraction_fps", "5", "--batch_size", "5",
                  "--host_preprocess", host_preprocess, "--decoder", decoder,
                  "--on_extraction", "save_numpy", "--output_path", str(tmp_path / host_preprocess),
                  "--tmp_path", str(tmp_path / "tmp")])
        (out,) = (tmp_path / host_preprocess).rglob("*.npy")
        return np.load(out)

    ours = port("native", "native")
    jax_ex = JaxExtractResNet(JaxConfig(**common, host_preprocess="native", decoder="cv2"),
                              external_call=True)
    jax_ex._host_params = jax_convert.convert_state_dict(_numpy_sd(model), "resnet18")
    ref = jax_ex([0])[0]["resnet18"]
    assert ours.shape == ref.shape == (8, 512)
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)
    pil = port("pil", "auto")
    assert _rel_l2(ours, pil) < NATIVE_VS_PIL_REL_L2
    assert not np.array_equal(ours, pil)


# --- the caches ------------------------------------------------------------

@pytest.mark.parametrize("decoder", ["native", "cv2"])
def test_shared_frame_cache_decodes_with_the_config_decoder(sample_video, decoder):
    if decoder == "native" and not native.decoder_available():
        pytest.skip(f"no libav: {native.decoder_build_error()}")
    native.reset_reader_counts()
    cache = SharedFrameCache(64 << 20)
    clip = cache.acquire(sample_video, decoder)
    assert native.readers_opened == {"native": int(decoder == "native"),
                                     "cv2": int(decoder == "cv2")}
    direct = [f for f, _ in vio.stream_frames(sample_video, None, "cv2")]
    assert len(clip.frames) == len(direct) == 60
    assert all(np.array_equal(a, b) for a, b in zip(clip.frames, direct))
    assert cache.acquire(sample_video, "cv2") is clip  # a hit: nothing decoded
    assert sum(native.readers_opened.values()) == 2


def test_digest_separates_host_preprocess_not_decoder():
    base = ExtractionConfig(feature_type=FT, extract_method="uni_12")
    assert base.host_preprocess == "pil"
    assert config_digest(base) != config_digest(base.replace(host_preprocess="native"))
    for decoder in ("cv2", "native"):
        assert config_digest(base) == config_digest(base.replace(decoder=decoder))
