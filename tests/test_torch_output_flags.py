"""The port's output and model flags against the JAX package's:
``--on_extraction save_jpg``, ``--show_pred`` on RAFT/PWC,
``--fps_retarget reencode``, ``--uint8_transfer`` and ``--conv3d_impl``,
and the ``sanity_check`` decisions on these flags.

Tolerances:

- ``flow_quantize_uint8_np`` and the ``save_jpg`` files: equal, byte for
  byte (the same quantization, and PIL's JPEG encoder on both sides);
- the flow ``--show_pred`` frames equal; the flow's colour wheel within
  one uint8 level, as the two packages' flows agree to ~1e-5 px
  (``test_torch_pwc``, ``test_torch_raft``) and the wheel floors;
- ``--fps_retarget reencode``: the same ffmpeg command (the staging name
  aside, which carries the thread in the port), with ``_run`` mocked:
  there is no ffmpeg binary here;
- ``--uint8_transfer off``: R(2+1)D's features equal to ``on``'s,
  ``kinetics_preprocess`` starts with the same fp32 cast;
- ``Conv3dCompat``: ``decomposed`` within 1e-5 of ``direct`` and each
  within 1e-5 of the JAX ``Conv3DCompat`` on unit-scale inputs and
  LeCun-normal weights (outputs of unit scale; fp32 sums in other orders
  over at most 7 x 7 x 7 x 5 taps).
"""

import os
import pathlib
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_features_tpu import config as jax_config
from video_features_tpu.config import ExtractionConfig as JaxConfig
from video_features_tpu.io import ffmpeg as jax_ffmpeg
from video_features_tpu.io import sink as jax_sink
from video_features_tpu.models.common import layers as jax_layers
from video_features_tpu.models.pwc import convert as jax_pwc_convert
from video_features_tpu.models.pwc.extract_pwc import ExtractPWC as JaxExtractPWC
from video_features_tpu.models.raft import convert as jax_raft_convert
from video_features_tpu.models.raft.extract_raft import ExtractRAFT as JaxExtractRAFT
from video_features_tpu.ops import preprocess as jax_pre
from video_features_tpu.utils import flow_viz as jax_flow_viz
from video_features_tpu_torch import config
from video_features_tpu_torch.config import ExtractionConfig
from video_features_tpu_torch.io import ffmpeg, sink
from video_features_tpu_torch.models.common import layers
from video_features_tpu_torch.models.i3d.extract_i3d import ExtractI3D
from video_features_tpu_torch.models.pwc.extract_pwc import ExtractPWC
from video_features_tpu_torch.models.pwc.model import PWCNet
from video_features_tpu_torch.models.pwc.model import init_weights as pwc_init
from video_features_tpu_torch.models.r21d import extract_r21d
from video_features_tpu_torch.models.r21d.extract_r21d import ExtractR21D
from video_features_tpu_torch.models.r21d.model import R2Plus1D
from video_features_tpu_torch.models.raft.extract_raft import ExtractRAFT
from video_features_tpu_torch.ops.preprocess import flow_quantize_uint8_np
from video_features_tpu_torch.utils import flow_viz
from video_features_tpu_torch.utils.synth import synth_video

from test_torch_raft import seeded_raft
from torch_threads import one_torch_thread  # noqa: F401 - an autouse fixture

CONV_ATOL = 1e-5


# --- save_jpg --------------------------------------------------------------

def _flow(seed=0, t=3, h=32, w=40):
    flow = np.random.RandomState(seed).uniform(-25, 25, (t, 2, h, w)).astype(np.float32)
    flow[0, 0, 0, :4] = [20.0, -20.0, 20.5, 0.0]  # +20 maps to 256 before the clip
    return flow


def test_flow_quantize_matches_jax():
    flow = _flow()
    ours = flow_quantize_uint8_np(flow)
    np.testing.assert_array_equal(ours, jax_pre.flow_quantize_uint8_np(flow))
    assert ours.dtype == np.uint8 and list(ours[0, 0, 0, :4]) == [255, 0, 255, 128]


def test_save_jpg_files_equal_the_jax_sinks(tmp_path):
    feats = {"pwc": _flow(), "fps": np.array(25.0), "timestamps_ms": np.arange(4.0)}
    for mod, name in ((sink, "port"), (jax_sink, "jax")):
        assert mod.action_on_extraction(feats, "/videos/clip.mp4", str(tmp_path / name),
                                        "save_jpg") == []
    ours = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.jpg"))
    ref = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.jpg"))
    assert ours == ref and len(ours) == 6
    assert str(ours[0]) == os.path.join("clip", "flow_x_00000.jpg")
    for rel in ours:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    assert sink.expected_output_files(["pwc"], "clip.mp4", str(tmp_path), "save_jpg") == []
    for mod in (sink, jax_sink):
        with pytest.raises(ValueError, match="needs \\(T, 2, H, W\\) flow"):
            mod.action_on_extraction({"pwc": np.zeros((3, 8, 8), np.float32)}, "clip.mp4",
                                     str(tmp_path / "bad"), "save_jpg")


# --- --show_pred on the flow extractors ---------------------------------------

def _recorder(viz, seen):
    def record(flow, frame):
        seen.append(np.concatenate([frame.astype(np.uint8), viz.flow_to_image(flow)], axis=0))
    return record


@pytest.mark.parametrize("feature_type", ["pwc", "raft"])
def test_flow_show_pred_images_match_jax(feature_type, sample_video, tmp_path, monkeypatch):
    """One image per pair, the pair's first frame over its flow, as the JAX
    package draws it; ``show_flow_on_frame`` (the display) is replaced by
    a recorder in both packages."""
    if feature_type == "pwc":
        model = pwc_init(PWCNet(), seed=4)
        side, port_cls, jax_cls, convert = 64, ExtractPWC, JaxExtractPWC, jax_pwc_convert
    else:
        model = seeded_raft()
        side, port_cls, jax_cls, convert = 100, ExtractRAFT, JaxExtractRAFT, jax_raft_convert
    weights = tmp_path / "w.pt"
    torch.save(model.state_dict(), weights)
    ours, ref = [], []
    monkeypatch.setattr(flow_viz, "show_flow_on_frame", _recorder(flow_viz, ours))
    monkeypatch.setattr(jax_flow_viz, "show_flow_on_frame", _recorder(jax_flow_viz, ref))
    common = dict(feature_type=feature_type, video_paths=[sample_video], extraction_fps=2.5,
                  side_size=side, batch_size=4, show_pred=True, cpu=True,
                  tmp_path=str(tmp_path / "tmp"))
    (flow,) = port_cls(config.sanity_check(ExtractionConfig(weights_path=str(weights), **common)),
                       external_call=True)()
    jax_ex = jax_cls(JaxConfig(decoder="cv2", **common), external_call=True)
    jax_ex._host_params = convert.convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    (jax_flow,) = jax_ex([0])
    # 60 frames at 25 fps -> 6 at 2.5 fps -> 5 pairs, one image each
    assert len(ours) == len(ref) == len(flow[feature_type]) == 5
    h = ref[0].shape[0] // 2
    for a, b in zip(ours, ref):
        assert a.shape == b.shape and np.isfinite(a).all()
        np.testing.assert_array_equal(a[:h], b[:h])
        assert np.abs(a[h:].astype(int) - b[h:].astype(int)).max() <= 1


# --- --fps_retarget reencode ------------------------------------------------

def _fake_ffmpeg(monkeypatch, mod, calls):
    """``mod``'s ffmpeg found, and its ``_run`` copying the input to the
    output: the re-encode's file without a binary."""
    def run(cmd, timeout_s=None):
        calls.append((list(cmd), timeout_s))
        shutil.copyfile(cmd[cmd.index("-i") + 1], cmd[-1])

    monkeypatch.setattr(mod, "require_ffmpeg", lambda: "/usr/bin/ffmpeg")
    monkeypatch.setattr(mod, "_run", run)


def test_fps_retarget_reencode_command_and_span(sample_video, tmp_path, monkeypatch):
    ours, ref = [], []
    _fake_ffmpeg(monkeypatch, ffmpeg, ours)
    _fake_ffmpeg(monkeypatch, jax_ffmpeg, ref)
    got = ffmpeg.reencode_video_with_diff_fps(sample_video, str(tmp_path / "p"), 5.0, 7.0)
    want = jax_ffmpeg.reencode_video_with_diff_fps(sample_video, str(tmp_path / "j"), 5.0, 7.0)
    assert os.path.basename(got) == os.path.basename(want) and os.path.exists(got)
    (cmd, timeout), (ref_cmd, ref_timeout) = ours[0], ref[0]
    assert cmd[:-1] == ref_cmd[:-1] and timeout == ref_timeout == 7.0
    assert cmd[-1].startswith(got + ".part") and not os.path.exists(cmd[-1])

    # through the extractor: the decode runs on the re-encoded file with no
    # selection fps (the mocked re-encode keeps all 60 frames: 59 pairs),
    # under a 'reencode' span, with --decode_timeout as ffmpeg's deadline
    ours.clear()
    ex = ExtractPWC(config.sanity_check(ExtractionConfig(
        feature_type="pwc", video_paths=[sample_video], extraction_fps=5.0, side_size=64,
        batch_size=8, fps_retarget="reencode", decode_timeout=9.0, allow_random_init=True,
        cpu=True, tmp_path=str(tmp_path / "tmp"))), external_call=True)
    (out,) = ex()
    assert out["pwc"].shape == (59, 2, 64, 85) and float(out["fps"]) == 5.0
    assert len(ours) == 1 and ours[0][1] == 9.0
    assert ours[0][0][ours[0][0].index("-i") + 1] == sample_video
    spans = [s for s in ex.telemetry.spans() if s.get("stage") == "reencode"]
    assert len(spans) == 1 and spans[0]["video"] == sample_video


# --- --uint8_transfer ---------------------------------------------------------

@pytest.fixture
def small_r21d(monkeypatch):
    """R(2+1)D-18 with one block a stage: the same layers, a quarter of the
    work."""
    monkeypatch.setattr(R2Plus1D.__init__, "__defaults__", ((1, 1, 1, 1), 400))


def test_uint8_transfer_off_equals_on(tmp_path, small_r21d, monkeypatch):
    """Solo forwards and a fused group of two clips, each at both settings."""
    clips = [synth_video(str(tmp_path / f"r{i}.mp4"), n_frames=32, width=64, height=48, seed=i)
             for i in range(2)]
    placed = []
    real = extract_r21d.place_batch
    monkeypatch.setattr(extract_r21d, "place_batch",
                        lambda x, device: placed.append(np.asarray(x).dtype) or real(x, device))
    out = {}
    for transfer in ("on", "off"):
        cfg = ExtractionConfig(feature_type="r21d_rgb", video_paths=clips, cpu=True,
                               allow_random_init=True, uint8_transfer=transfer, video_batch=2,
                               decode_workers=1)
        ex = ExtractR21D(config.sanity_check(cfg), external_call=True)
        model = ex.warmup(torch.device("cpu"))
        out[transfer] = ex() + [ex.forward(model, ex.prepare(c)) for c in clips]
        assert placed.pop() == (np.float32 if transfer == "off" else np.uint8)
    for a, b in zip(out["on"], out["off"]):
        assert a["r21d_rgb"].shape == (2, 512)
        np.testing.assert_array_equal(a["r21d_rgb"], b["r21d_rgb"])


def test_uint8_transfer_off_counts_four_bytes_in_the_fused_cap(tmp_path, monkeypatch):
    clip = synth_video(str(tmp_path / "r.mp4"), n_frames=32, width=64, height=48)
    stack_bytes = 2 * 16 * 48 * 64 * 3  # two 16-frame uint8 stacks
    monkeypatch.setattr(ExtractR21D, "AGG_MAX_BYTES", 2 * stack_bytes)
    keys = {}
    for transfer in ("on", "off"):
        ex = ExtractR21D(ExtractionConfig(feature_type="r21d_rgb", video_paths=[clip], cpu=True,
                                          uint8_transfer=transfer), external_call=True)
        keys[transfer] = ex.agg_key(ex.prepare(clip))
    assert keys == {"on": (16, 48, 64, 3), "off": None}


# --- --conv3d_impl ------------------------------------------------------------

# (kernel, stride, padding, input (T, H, W)): I3D's convolutions (TF SAME
# padding applied before the conv, so padding 0 here) and R(2+1)D's
CONV_CASES = [
    ((7, 7, 7), (2, 2, 2), (0, 0, 0), (16, 23, 23)),  # I3D stem
    ((1, 1, 1), (1, 1, 1), (0, 0, 0), (5, 9, 9)),  # I3D 1x1x1 branches
    ((3, 3, 3), (1, 1, 1), (0, 0, 0), (6, 9, 11)),  # I3D 3x3x3 branches
    ((1, 7, 7), (1, 2, 2), (0, 3, 3), (4, 17, 15)),  # R(2+1)D stem, spatial
    ((3, 1, 1), (1, 1, 1), (1, 0, 0), (5, 7, 7)),  # R(2+1)D temporal
    ((3, 1, 1), (2, 1, 1), (1, 0, 0), (8, 7, 7)),  # R(2+1)D downsampling temporal
    ((1, 3, 3), (1, 2, 2), (0, 1, 1), (4, 9, 9)),  # R(2+1)D downsampling spatial
    ((1, 1, 1), (2, 2, 2), (0, 0, 0), (8, 9, 9)),  # R(2+1)D shortcut
]


@pytest.mark.parametrize("kernel,stride,padding,thw", CONV_CASES)
@pytest.mark.parametrize("bias", [False, True])
def test_conv3d_compat_matches_direct_and_jax(kernel, stride, padding, thw, bias):
    rng = np.random.RandomState(sum(kernel) + sum(stride))
    conv = layers.Conv3dCompat(5, 6, kernel, stride, padding, bias=bias)
    with torch.no_grad():  # LeCun-normal, as the models' init: unit-scale outputs
        conv.weight.copy_(torch.from_numpy(rng.normal(
            0, conv.weight[0].numel() ** -0.5, conv.weight.shape).astype(np.float32)))
        if bias:
            conv.bias.copy_(torch.from_numpy(rng.normal(0, 0.2, 6).astype(np.float32)))
    x = rng.uniform(-1, 1, (2, 5) + thw).astype(np.float32)
    got = {}
    for impl in ("direct", "decomposed"):
        conv.impl = impl
        with torch.no_grad():
            got[impl] = conv(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got["decomposed"], got["direct"], atol=CONV_ATOL, rtol=0)
    params = {"kernel": jnp.asarray(conv.weight.detach().numpy().transpose(2, 3, 4, 1, 0))}
    if bias:
        params["bias"] = jnp.asarray(conv.bias.detach().numpy())
    for impl in ("direct", "decomposed"):
        ref = jax_layers.Conv3DCompat(
            features=6, kernel=kernel, stride=stride, padding=[(p, p) for p in padding],
            use_bias=bias, impl=impl,
        ).apply({"params": params}, jnp.asarray(x.transpose(0, 2, 3, 4, 1)))
        ref = np.asarray(ref).transpose(0, 4, 1, 2, 3)
        assert got[impl].shape == ref.shape
        np.testing.assert_allclose(got[impl], ref, atol=CONV_ATOL, rtol=0)


@pytest.mark.parametrize("env,want", [(None, "direct"), ("direct", "direct"),
                                      ("decomposed", "decomposed"), ("bogus", None)])
def test_conv3d_impl_env_matches_jax(env, want, monkeypatch):
    if env is None:
        monkeypatch.delenv("VFT_CONV3D_IMPL", raising=False)
    else:
        monkeypatch.setenv("VFT_CONV3D_IMPL", env)
    if want is None:
        for fn in (layers.conv3d_impl, jax_layers.conv3d_impl):
            with pytest.raises(ValueError, match="direct\\|decomposed"):
                fn()
        return
    assert layers.conv3d_impl() == jax_layers.conv3d_impl() == want


def test_conv3d_impl_threads_per_extractor(sample_video, small_r21d, monkeypatch):
    """Each extractor's --conv3d_impl reaches its own models only and never
    the process env; 'auto' leaves the choice to VFT_CONV3D_IMPL at each
    call. R(2+1)D's features agree across the two lowerings."""
    monkeypatch.delenv("VFT_CONV3D_IMPL", raising=False)

    def convs(ex):
        state = ex.warmup(torch.device("cpu"))
        modules = state.values() if isinstance(state, dict) else [state]
        return [m for mod in modules for m in mod.modules()
                if isinstance(m, layers.Conv3dCompat)]

    def make(cls, ft, impl):
        return cls(ExtractionConfig(feature_type=ft, video_paths=[sample_video], cpu=True,
                                    allow_random_init=True, conv3d_impl=impl),
                   external_call=True)

    exs = {impl: make(ExtractI3D, "i3d", impl) for impl in ("decomposed", "direct", "auto")}
    r21d = {impl: make(ExtractR21D, "r21d_rgb", impl) for impl in ("direct", "decomposed")}
    for impl, want in (("decomposed", "decomposed"), ("direct", "direct"), ("auto", None)):
        assert exs[impl].conv_impl == want
        assert {m.impl for m in convs(exs[impl])} == {want}
    assert len(convs(exs["direct"])) == 2 * 58  # every 3D convolution of both streams
    assert "VFT_CONV3D_IMPL" not in os.environ
    feats = {impl: ex()[0]["r21d_rgb"] for impl, ex in r21d.items()}
    assert {m.impl for m in convs(r21d["decomposed"])} == {"decomposed"}
    np.testing.assert_allclose(feats["decomposed"], feats["direct"],
                               atol=CONV_ATOL * np.abs(feats["direct"]).max(), rtol=0)


# --- sanity_check decisions against the JAX package's --------------------------

SANITY_CASES = [
    ("i3d", "--flow_type", "flow"),
    ("i3d", "--flow_type", "flow", "--streams", "rgb"),
    ("i3d", "--flow_type", "flow", "--preprocess", "device"),
    ("i3d", "--flow_type", "flow", "--flow_paths", "f"),
    ("i3d", "--flow_type", "flow", "--flow_paths", ""),
    ("i3d", "--flow_type", "flow", "--video_dir", "v", "--flow_dir", "f"),
    ("i3d", "--video_dir", ""),
    ("i3d", "--flow_dir", " "),
    ("pwc", "--on_extraction", "save_jpg"),
    ("raft", "--on_extraction", "save_jpg"),
    ("i3d", "--on_extraction", "save_jpg"),
    ("resnet18", "--on_extraction", "save_jpg"),
    ("pwc", "--on_extraction", "save_png"),
    ("i3d", "--show_pred"),
    ("raft", "--show_pred"),
    ("pwc", "--show_pred"),
    ("pwc", "--show_pred", "--preprocess", "device"),
    ("raft", "--show_pred", "--preprocess", "device"),
    ("i3d", "--show_pred", "--preprocess", "device"),
    ("resnet50", "--show_pred"),
    ("r21d_rgb", "--show_pred"),
    ("vggish", "--show_pred"),
    ("resnet18", "--show_pred", "--device_ids", "0", "1"),
    ("pwc", "--fps_retarget", "reencode", "--extraction_fps", "5"),
    ("raft", "--fps_retarget", "reencode"),
    ("resnet50", "--fps_retarget", "reencode", "--extraction_fps", "5"),
    ("i3d", "--fps_retarget", "reencode", "--extraction_fps", "5"),
    ("r21d_rgb", "--fps_retarget", "reencode"),
    ("pwc", "--fps_retarget", "nearest"),
    ("pwc", "--fps_retarget", "ffmpeg"),
    ("r21d_rgb", "--uint8_transfer", "off"),
    ("r21d_rgb", "--uint8_transfer", "maybe"),
    ("i3d", "--conv3d_impl", "decomposed"),
    ("r21d_rgb", "--conv3d_impl", "direct"),
    ("i3d", "--conv3d_impl", "auto"),
    ("i3d", "--conv3d_impl", "winograd"),
]


def _decision(parse, argv):
    try:
        parse(argv)
    except SystemExit:
        return "argparse"
    except (ValueError, AssertionError):
        return "refused"
    return "accepted"


@pytest.mark.parametrize("case", SANITY_CASES, ids=lambda c: " ".join(c) or "none")
def test_sanity_check_decisions_match_jax(case, tmp_path, capsys):
    ft, *flags = case
    argv = ["--feature_type", ft, "--video_paths", "v.mp4", "--output_path",
            str(tmp_path / "o"), "--tmp_path", str(tmp_path / "t"), *flags]
    ours = _decision(config.parse_batch_args, argv)
    assert ours == _decision(jax_config.parse_batch_args, argv)
    capsys.readouterr()  # argparse's usage lines


def test_show_pred_is_refused_for_clip_only():
    """``--show_pred`` for CLIP is accepted by both packages, which parse
    it to the same config (the prediction pins to one device); the run's
    printed output is ``test_clip_show_pred_prints_nothing_as_jax``'s."""
    argv = ["--feature_type", "CLIP-ViT-B/32", "--show_pred", "--video_paths", "v.mp4",
            "--device_ids", "0", "1"]
    ours = config.parse_batch_args(argv)[0]
    ref = jax_config.parse_batch_args(argv)[0]
    assert ours.show_pred is ref.show_pred is True
    assert ours.device_ids == ref.device_ids == [0]
    assert (ours.feature_type, ours.extract_method, ours.on_extraction) == \
        (ref.feature_type, ref.extract_method, ref.on_extraction)
    cfg = config.sanity_check(ExtractionConfig(feature_type="resnet18", show_pred=True,
                                               device_ids=[0, 1]))
    assert cfg.device_ids == [0]


def test_clip_show_pred_prints_nothing_as_jax(tmp_path, sample_video, monkeypatch, capsys):
    """The small CLIP tower with ``--show_pred`` through both packages:
    each prints what it prints without the flag (nothing per video), and
    the features are those of the run without it."""
    from video_features_tpu.models.clip import model as jax_model
    from video_features_tpu.models.clip.extract_clip import ExtractCLIP as JaxExtractCLIP
    from video_features_tpu_torch.models.clip import model as port_model
    from video_features_tpu_torch.models.clip.extract_clip import ExtractCLIP

    from test_torch_clip import SMALL, openai_state_dict

    ft = "CLIP-ViT-B/32"
    monkeypatch.setitem(port_model.CONFIGS, ft, port_model.CLIPVisionConfig(**SMALL))
    monkeypatch.setitem(jax_model.CONFIGS, ft, jax_model.CLIPVisionConfig(**SMALL))
    weights = str(tmp_path / "clip_small.npz")
    np.savez(weights, **openai_state_dict())
    flags = dict(feature_type=ft, video_paths=[sample_video], extract_method="uni_3",
                 weights_path=weights, cpu=True)
    printed, feats = {}, {}
    for show in (False, True):
        ex = ExtractCLIP(config.sanity_check(ExtractionConfig(show_pred=show, **flags)),
                         external_call=True)
        capsys.readouterr()
        feats[("port", show)] = ex([0], device=torch.device("cpu"))[0][ft]
        printed[("port", show)] = capsys.readouterr().out
        jex = JaxExtractCLIP(jax_config.sanity_check(JaxConfig(show_pred=show, decoder="cv2",
                                                               **flags)), external_call=True)
        capsys.readouterr()
        feats[("jax", show)] = np.asarray(jex([0])[0][ft])
        printed[("jax", show)] = capsys.readouterr().out
    for pkg in ("port", "jax"):
        assert printed[(pkg, True)] == printed[(pkg, False)]
        np.testing.assert_array_equal(feats[(pkg, True)], feats[(pkg, False)])
    assert printed[("port", True)] == printed[("jax", True)] == ""


def test_pairs_do_not_reach_the_serve_configs(tmp_path):
    """The serve daemon's per-model config drops the batch input flags, as
    the JAX package's does."""
    from video_features_tpu_torch.config import parse_serve_args
    from video_features_tpu_torch.serve.daemon import ExtractorPool

    scfg = parse_serve_args(["--feature_types", "i3d", "--cpu", "--flow_paths", "f",
                             "--video_dir", "v", "--flow_dir", "g", "--conv3d_impl",
                             "decomposed", "--output_path", str(tmp_path / "o")])
    cfg = ExtractorPool(scfg.extraction, 2)._serving_config("i3d")
    assert (cfg.flow_paths, cfg.video_dir, cfg.flow_dir) == (None, None, None)
    assert cfg.conv3d_impl == "decomposed" and cfg.video_paths == []
    assert pathlib.Path(cfg.output_path) == tmp_path / "o"
