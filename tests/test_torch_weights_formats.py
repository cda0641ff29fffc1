"""``--weights_path`` in the JAX package's converted formats.

- ``models/common/flax_msgpack.py`` against Flax itself: Flax's
  ``msgpack_serialize`` output (fp32, fp16, bf16, int, bool and scalar
  leaves, chunked leaves too) reads back bit for bit, and the port's
  ``save_msgpack`` writes the very bytes Flax writes, which Flax's
  ``msgpack_restore`` reads back bit for bit. A complex leaf and an
  unknown dtype are refused, naming the leaf;
- each family's ``params_to_jax`` equals the JAX package's
  ``convert_state_dict`` of the same reference-layout state dict, leaf
  for leaf (keys, shapes, dtypes, bytes: every converter only moves
  layout, so the tolerance is 0), and the port's ``load_params`` of that
  tree, written by Flax, gives back the seeded state dict bit for bit;
- orbax directories written by the JAX package's ``save_orbax``, read by
  the port's own codec (``tests/test_torch_orbax.py`` holds it to orbax
  and tensorstore): CLIP, ResNet, and I3D's directory of reference names
  holding an orbax ``i3d_rgb.pt`` beside a ``.pt`` ``i3d_flow.pt``;
- the tiny CLIP tower through ``ExtractCLIP`` from ``.msgpack`` and orbax
  against the ``.pt`` run (tolerance 0: the same weights, the same
  graph), and on a mesh of two CPU rows from orbax against the one-device
  ``.pt`` run (1e-5, the mesh tests' bound);
- ``python -m video_features_tpu_torch.convert_weights`` against
  ``scripts/convert_weights.py`` on ResNet-18: the same bytes, and the
  same tree through the JAX package's ``load_params``;
- an orbax directory read with ``tensorstore``, ``orbax`` and
  ``zstandard`` hidden, and the converter's refusals of a ``dst`` before
  it reads ``src``: an existing orbax ``dst`` (its format inferred or
  given) and a file-like suffix without ``--format``.
"""

import functools
import importlib.util
import pathlib
import sys

import flax.serialization
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_features_tpu.models.clip import convert as jax_clip_convert
from video_features_tpu.models.common import weights as jax_weights
from video_features_tpu.models.i3d import convert as jax_i3d_convert
from video_features_tpu.models.pwc import convert as jax_pwc_convert
from video_features_tpu.models.r21d import convert as jax_r21d_convert
from video_features_tpu.models.raft import convert as jax_raft_convert
from video_features_tpu.models.resnet import convert as jax_resnet_convert
from video_features_tpu.models.vggish import convert as jax_vggish_convert
from video_features_tpu_torch import convert_weights
from video_features_tpu_torch.config import ExtractionConfig
from video_features_tpu_torch.models.clip import convert as clip_convert
from video_features_tpu_torch.models.clip import model as clip_model
from video_features_tpu_torch.models.clip.extract_clip import ExtractCLIP
from video_features_tpu_torch.models.common import flax_msgpack
from video_features_tpu_torch.models.common.weights import load_params
from video_features_tpu_torch.models.i3d import convert as i3d_convert
from video_features_tpu_torch.models.i3d import extract_i3d
from video_features_tpu_torch.models.i3d.model import I3D
from video_features_tpu_torch.models.i3d.model import init_weights as i3d_init
from video_features_tpu_torch.models.pwc import convert as pwc_convert
from video_features_tpu_torch.models.pwc.model import PWCNet
from video_features_tpu_torch.models.pwc.model import init_weights as pwc_init
from video_features_tpu_torch.models.r21d import convert as r21d_convert
from video_features_tpu_torch.models.raft import convert as raft_convert
from video_features_tpu_torch.models.resnet import convert as resnet_convert
from video_features_tpu_torch.models.vggish import convert as vggish_convert
from video_features_tpu_torch.models.vggish.model import VGGish
from video_features_tpu_torch.models.vggish.model import init_weights as vggish_init
from video_features_tpu_torch.parallel import sharding

from test_torch_i3d import seeded_i3d
from test_torch_r21d import seeded_r21d
from test_torch_raft import seeded_raft
from test_torch_resnet import seeded_resnet

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
FT = "CLIP-ViT-B/32"
TINY = dict(patch_size=16, width=64, layers=2, heads=2, embed_dim=32, image_size=32)
MESH_ATOL = 1e-5


def _flax_tree(rng):
    return {"params": {
        "dense": {"kernel": rng.randn(3, 4).astype(np.float32),
                  "bias": rng.randn(4).astype(np.float16)},
        "bf16": np.asarray(jnp.asarray(rng.randn(5, 2), jnp.bfloat16)),
        "count": np.arange(-3, 4, dtype=np.int32),
        "steps": np.arange(300, dtype=np.uint8).reshape(3, 100),
        "mask": rng.rand(6) > 0.5,
        "scale": np.float32(2.5),
        "wide": rng.randn(40, 70).astype(np.float32),
    }}


def _same(got, want, path=""):
    """``got`` (the port's reader) equals ``want`` (Flax's) leaf for leaf:
    keys in order, types, shapes, dtypes and bytes; a bf16 leaf comes back
    as a torch bfloat16 tensor with Flax's bits."""
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif want.dtype == jnp.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == want.shape, path
        assert got.view(torch.int16).numpy().tobytes() == np.asarray(want).tobytes(), path
    else:
        assert type(got) is type(want) and got.dtype == want.dtype, path
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), path


@pytest.mark.parametrize("chunk", [None, 64], ids=["whole", "chunked"])
def test_reader_reads_flax_output_bitwise(monkeypatch, chunk):
    if chunk:  # 'wide' (11200 B) and 'steps' (300 B) split into chunks of 64 bytes
        monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", chunk)
    blob = flax.serialization.msgpack_serialize(_flax_tree(np.random.RandomState(0)))
    if chunk:
        assert flax_msgpack.CHUNKED.encode() in blob
    _same(flax_msgpack.loads(blob), flax.serialization.msgpack_restore(blob))


@pytest.mark.parametrize("chunk", [None, 64], ids=["whole", "chunked"])
def test_save_msgpack_writes_what_flax_writes(monkeypatch, tmp_path, chunk):
    if chunk:
        monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", chunk)
    flax_tree = _flax_tree(np.random.RandomState(1))
    ours = flax_msgpack.loads(flax.serialization.msgpack_serialize(flax_tree))
    path = tmp_path / "w.msgpack"
    flax_msgpack.save_msgpack(ours, str(path))
    blob = path.read_bytes()
    assert blob == flax.serialization.msgpack_serialize(flax_tree)
    assert not (tmp_path / "w.msgpack.tmp").exists()
    back = flax.serialization.msgpack_restore(blob)
    _same(flax_msgpack.loads(blob), back)
    for k, want in flax_tree["params"].items():
        got = back["params"][k]
        if isinstance(want, dict):
            assert all(got[n].tobytes() == want[n].tobytes() for n in want)
        else:
            assert np.asarray(got).dtype == want.dtype and np.asarray(got).tobytes() == (
                np.asarray(want).tobytes())


@pytest.mark.parametrize("leaf,message", [
    (1 + 2j, "leaf /params/w/odd: a complex number is not read"),
    (np.ones(3, np.float64), "leaf /params/w/odd: dtype 'float64' is not read"),
], ids=["complex", "float64"])
def test_reader_refuses_complex_and_unknown_dtypes_naming_the_leaf(leaf, message):
    blob = flax.serialization.msgpack_serialize({"params": {"w": {"odd": leaf}}})
    with pytest.raises(flax_msgpack.MsgpackFormatError, match=message.replace("(", r"\(")):
        flax_msgpack.loads(blob)


# --- one case a family: params_to_jax, and load_params of Flax's file --------------

def _clip():
    return clip_model.init_weights(clip_model.VisionTransformer(
        clip_model.CLIPVisionConfig(**TINY)), seed=3)


def _vggish():
    """VGGish with its convs as they are and a narrow head under the same
    names: the full head is 50M-parameter matrices, which only make the
    layout moves slow (the converters read names, never widths)."""
    model = VGGish()
    model.embeddings = torch.nn.Sequential(
        torch.nn.Linear(512 * 6 * 4, 64), torch.nn.ReLU(), torch.nn.Linear(64, 64),
        torch.nn.ReLU(), torch.nn.Linear(64, 128), torch.nn.ReLU())
    return vggish_init(model, seed=3)


def _pwc():
    return pwc_init(PWCNet(), seed=3)


# family: (seeded port module, the port's converters, the JAX converter of the
# reference layout, that layout from the port's state dict)
FAMILIES = {
    "clip": (_clip, clip_convert, clip_convert.params_from_jax,
             functools.partial(jax_clip_convert.convert_state_dict, layers=TINY["layers"]),
             lambda sd: {f"visual.{k}": v for k, v in sd.items()}),
    "resnet50": (functools.partial(seeded_resnet, "resnet50", 3), resnet_convert,
                 functools.partial(resnet_convert.params_from_jax, arch="resnet50"),
                 functools.partial(jax_resnet_convert.convert_state_dict, arch="resnet50"), dict),
    "r21d_rgb": (functools.partial(seeded_r21d, 3), r21d_convert, r21d_convert.params_from_jax,
                 jax_r21d_convert.convert_state_dict, dict),
    "vggish": (_vggish, vggish_convert, vggish_convert.params_from_jax,
               jax_vggish_convert.convert_state_dict, dict),
    "raft": (functools.partial(seeded_raft, 3), raft_convert, raft_convert.params_from_jax,
             jax_raft_convert.convert_state_dict, dict),
    "pwc": (_pwc, pwc_convert, pwc_convert.params_from_jax, jax_pwc_convert.convert_state_dict,
            dict),
    "i3d": (lambda: seeded_i3d(2, 3), i3d_convert, i3d_convert.params_from_jax,
            jax_i3d_convert.convert_state_dict, dict),
}


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _fail_convert(sd):
    raise AssertionError("a converted tree went through the state-dict converter")


def _equal_state(got, sd):
    """Bit for bit on every tensor but BatchNorm's ``num_batches_tracked``
    counters, which no checkpoint format carries."""
    got, want = ({k: v for k, v in d.items() if not k.endswith("num_batches_tracked")}
                 for d in (got, sd))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("family", list(FAMILIES))
def test_params_to_jax_is_the_jax_converter_and_loads_back(tmp_path, family):
    seeded, convert, from_jax, jax_convert, reference_layout = FAMILIES[family]
    sd = seeded().state_dict()
    ours = convert.params_to_jax(sd)
    _same(ours, jax_convert(reference_layout(_numpy(sd))))
    path = tmp_path / f"{family}.msgpack"
    path.write_bytes(flax.serialization.msgpack_serialize({"params": ours}))
    _equal_state(load_params(str(path), _fail_convert, from_jax), sd)


# --- orbax, written by the JAX package's save_orbax ---------------------------------

@pytest.mark.parametrize("family", ["clip", "resnet18"])
def test_orbax_from_the_jax_package_loads_bitwise(tmp_path, family):
    if family == "clip":
        sd, from_jax = _clip().state_dict(), clip_convert.params_from_jax
        jax_params = jax_clip_convert.convert_state_dict(
            {f"visual.{k}": v for k, v in _numpy(sd).items()}, TINY["layers"])
    else:
        sd = seeded_resnet("resnet18", 4).state_dict()
        from_jax = functools.partial(resnet_convert.params_from_jax, arch="resnet18")
        jax_params = jax_resnet_convert.convert_state_dict(_numpy(sd), "resnet18")
    path = tmp_path / "orbax"
    jax_weights.save_orbax(jax_params, str(path))
    _equal_state(load_params(str(path), _fail_convert, from_jax), sd)


def test_i3d_directory_with_an_orbax_rgb_and_a_pt_flow(monkeypatch, tmp_path, sample_video):
    monkeypatch.setattr(extract_i3d, "I3D", functools.partial(I3D, channel_div=8))
    rgb = i3d_init(I3D(3, channel_div=8), seed=5).state_dict()
    flow = i3d_init(I3D(2, channel_div=8), seed=6).state_dict()
    jax_weights.save_orbax(jax_i3d_convert.convert_state_dict(_numpy(rgb)),
                           str(tmp_path / "i3d_rgb.pt"))
    torch.save(flow, tmp_path / "i3d_flow.pt")
    ex = extract_i3d.ExtractI3D(ExtractionConfig(
        feature_type="i3d", flow_type="pwc", streams=["rgb", "flow"], video_paths=[sample_video],
        weights_path=str(tmp_path), output_path=str(tmp_path / "o"),
        tmp_path=str(tmp_path / "t")), external_call=True)
    assert (tmp_path / "i3d_rgb.pt").is_dir()
    _equal_state(ex._model("rgb").state_dict(), rgb)
    _equal_state(ex._model("flow").state_dict(), flow)


# --- the tiny CLIP tower through ExtractCLIP ----------------------------------------

@pytest.fixture(scope="module")
def clip_files(tmp_path_factory):
    """The tiny tower's seeded weights as a ``.pt`` (OpenAI names), a
    ``.msgpack`` (``params_to_jax`` + ``save_msgpack``) and an orbax
    directory (the JAX package's ``save_orbax``)."""
    d = tmp_path_factory.mktemp("clip_weights")
    sd = _clip().state_dict()
    with torch.no_grad():  # nonzero biases: a bias dropped on the way would show
        g = torch.Generator().manual_seed(7)
        sd = {k: v + 0.1 * torch.randn(v.shape, generator=g) for k, v in sd.items()}
    torch.save({f"visual.{k}": v for k, v in sd.items()}, d / "clip.pt")
    flax_msgpack.save_msgpack(clip_convert.params_to_jax(sd), str(d / "clip.msgpack"))
    jax_weights.save_orbax(clip_convert.params_to_jax(sd), str(d / "clip_orbax"))
    return {fmt: str(d / name) for fmt, name in
            (("pt", "clip.pt"), ("msgpack", "clip.msgpack"), ("orbax", "clip_orbax"))}


@pytest.fixture
def tiny_clip(monkeypatch):
    monkeypatch.setitem(clip_model.CONFIGS, FT, clip_model.CLIPVisionConfig(**TINY))


def _clip_features(video, tmp_path, weights, device=CPU):
    ex = ExtractCLIP(ExtractionConfig(
        feature_type=FT, video_paths=[video], extract_method="uni_4", weights_path=weights,
        decoder="cv2", output_path=str(tmp_path / "o"), tmp_path=str(tmp_path / "t")),
        external_call=True)
    (feats,) = ex(device=device)
    return feats[FT]


@pytest.mark.parametrize("fmt", ["msgpack", "orbax"])
def test_clip_from_converted_weights_matches_the_pt_run(sample_video, tmp_path, clip_files,
                                                        tiny_clip, fmt):
    want = _clip_features(sample_video, tmp_path, clip_files["pt"])
    got = _clip_features(sample_video, tmp_path, clip_files[fmt])
    assert got.shape == (4, TINY["embed_dim"]) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


def test_clip_mesh_from_orbax_matches_the_one_device_pt_run(sample_video, tmp_path, clip_files,
                                                            tiny_clip):
    want = _clip_features(sample_video, tmp_path, clip_files["pt"])
    got = _clip_features(sample_video, tmp_path, clip_files["orbax"],
                         device=sharding.make_mesh([CPU] * 2))
    np.testing.assert_allclose(got, want, atol=MESH_ATOL)


# --- the converter CLI --------------------------------------------------------------

def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_convert_weights_script",
                                                  ROOT / "scripts" / "convert_weights.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_converter_cli_writes_what_the_jax_script_writes(monkeypatch, tmp_path, capsys):
    src = tmp_path / "resnet18.pth"
    torch.save(seeded_resnet("resnet18", 2).state_dict(), src)
    ours, theirs = tmp_path / "port.msgpack", tmp_path / "jax.msgpack"
    assert convert_weights.main(["--feature_type", "resnet18", str(src), str(ours)]) == 0
    assert capsys.readouterr().out == f"{src} -> {ours}: 11.7M params\n"
    monkeypatch.setattr(sys, "argv", ["convert_weights.py", "--feature_type", "resnet18",
                                      str(src), str(theirs)])
    _jax_script().main()
    assert ours.read_bytes() == theirs.read_bytes()
    unused = lambda sd: None  # noqa: E731 - a .msgpack never reaches it
    _same(jax_weights.load_params(str(ours), unused),
          jax_weights.load_params(str(theirs), unused))


# --- the refusals -------------------------------------------------------------------

def test_orbax_without_tensorstore_is_refused_by_name(monkeypatch, clip_files):
    """No refusal: with ``tensorstore``, ``orbax`` and ``zstandard`` hidden,
    the orbax directory loads the ``.pt``'s weights bit for bit."""
    for name in ("tensorstore", "orbax", "orbax.checkpoint", "zstandard"):
        monkeypatch.setitem(sys.modules, name, None)
    want = load_params(clip_files["pt"], functools.partial(clip_convert.convert_state_dict,
                                                           layers=TINY["layers"]),
                       clip_convert.params_from_jax)
    _equal_state(load_params(clip_files["orbax"], _fail_convert, clip_convert.params_from_jax),
                 want)


@pytest.mark.parametrize("dst,extra,message", [
    ("weights_dir", [], "orbax dst already exists"),
    ("weights.ckpt", ["--format", "orbax"], "orbax dst already exists"),
    ("weights.msgpak", [], "has a file-like suffix but isn't .msgpack"),
], ids=["inferred-orbax", "format-orbax", "suffix-typo"])
def test_converter_cli_refuses_dst_before_loading(tmp_path, dst, extra, message):
    missing = tmp_path / "never_read.pth"  # dst is checked first: src is never opened
    if "exists" in message:  # an existing dst: a directory, or a file under --format
        (tmp_path / dst).mkdir() if not extra else (tmp_path / dst).write_bytes(b"kept")
    before = sorted(tmp_path.iterdir())
    with pytest.raises(SystemExit, match=message):
        convert_weights.main(["--feature_type", "resnet18", *extra, str(missing),
                              str(tmp_path / dst)])
    assert sorted(tmp_path.iterdir()) == before
