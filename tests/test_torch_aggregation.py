"""Cross-video aggregation (``--video_batch``) in the port's async loop.

For every family, ``--video_batch 3`` over 4 inputs (a full group and a
partial one) gives the features of ``--video_batch 1``; CLIP and PWC
also agree with the JAX package at the same flags. Results come back in
input order across mixed shape keys and over-cap opt-outs, and a video
over the prefetch cap decodes at dispatch; a fused
dispatch or fetch that fails re-runs its members alone with the JAX
package's ``group_fallback`` record; a sticky device error in a fused
group stops the run with one ``worker_death``.

Small sizes keep this cheap: a 2-layer CLIP tower, one 2-frame-stack
R(2+1)D with one block a stage, RAFT at 2 iterations, and for I3D small
stand-in towers and flow nets behind the real stack chains (the real
networks' fused shapes are checked on the card by ``chip_smoke.py``).
Tolerances: fused and solo run the same fp32 arithmetic on batches of
other sizes, so only the sum order of a GEMM or convolution can differ.
"""

import pathlib

import numpy as np
import pytest
import torch

from video_features_tpu.config import ExtractionConfig as JaxConfig
from video_features_tpu.models.clip import model as jax_model
from video_features_tpu.models.clip.extract_clip import ExtractCLIP as JaxExtractCLIP
from video_features_tpu.models.pwc import convert as jax_pwc_convert
from video_features_tpu.models.pwc.extract_pwc import ExtractPWC as JaxExtractPWC
from video_features_tpu.runtime import faults as jax_faults
from video_features_tpu_torch.config import ExtractionConfig
from video_features_tpu_torch.extract.registry import build_extractor
from video_features_tpu_torch.models.clip import model as port_model
from video_features_tpu_torch.models.clip.extract_clip import ExtractCLIP
from video_features_tpu_torch.models.i3d.extract_i3d import ExtractI3D
from video_features_tpu_torch.models.r21d.extract_r21d import ExtractR21D
from video_features_tpu_torch.models.r21d.model import R2Plus1D
from video_features_tpu_torch.models.r21d.model import init_weights as r21d_init
from video_features_tpu_torch.models.raft.extract_raft import ExtractRAFT
from video_features_tpu_torch.models.raft.model import RAFT
from video_features_tpu_torch.runtime import faults
from video_features_tpu_torch.utils.synth import synth_video, synth_wav

from test_torch_clip import SMALL, openai_state_dict
from test_torch_pwc import FLOW_ATOL, _seeded_state_dict
from torch_threads import one_torch_thread  # noqa: F401 - an autouse fixture

FT = "CLIP-ViT-B/32"
STICKY = "CUDA error: an illegal memory access was encountered"
# fused vs solo: the same fp32 arithmetic, other batch sizes
ATOL = 1e-5
# against the JAX package (test_torch_extract.py, test_torch_pwc.py)
JAX_ATOL = 1e-4


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("agg_media")
    return [synth_video(str(d / f"v{i}.mp4"), n_frames=10 + 2 * i, width=64, height=48, seed=i)
            for i in range(4)]


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("agg_audio")
    return [synth_wav(str(d / f"a{i}.wav"), seconds=sec, sample_rate=16000, seed=i)
            for i, sec in enumerate((1.0, 2.0, 1.5, 3.0))]


@pytest.fixture
def small_tower(monkeypatch):
    monkeypatch.setitem(port_model.CONFIGS, FT, port_model.CLIPVisionConfig(**SMALL))
    monkeypatch.setitem(jax_model.CONFIGS, FT, jax_model.CLIPVisionConfig(**SMALL))


class TinyTower(torch.nn.Module):
    """I3D's interface, (B, T, 224, 224, C) -> ((B, 8), logits): a seeded
    projection of each stack's per-channel mean and spread."""

    def __init__(self, channels):
        super().__init__()
        self.proj = torch.nn.Linear(2 * channels, 8)
        with torch.no_grad():
            g = torch.Generator().manual_seed(channels)
            self.proj.weight.copy_(torch.randn(self.proj.weight.shape, generator=g))
            self.proj.bias.zero_()

    def forward(self, x):
        stats = torch.cat([x.mean(dim=(1, 2, 3)), x.std(dim=(1, 2, 3))], dim=-1)
        return self.proj(stats), None


class TinyFlow(torch.nn.Module):
    """A flow net's interface, (B, T+1, H, W, 3) -> (B, T, H, W, 2): the
    frame-to-frame change of two channels."""

    def __init__(self):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.tensor(0.25))

    def forward(self, frames):
        return self.scale * (frames[:, 1:, ..., :2] - frames[:, :-1, ..., 1:])


def _tiny_i3d(self, kind):
    if kind in ("rgb", "flow"):
        return TinyTower(3 if kind == "rgb" else 2)
    return TinyFlow()  # pwc or raft


def _small_r21d(self, device):
    return r21d_init(R2Plus1D(layers=(1, 1, 1, 1))).to(device).eval()


def _raft_2_iterations(self):
    return RAFT(iters=2)


# family -> (config fields, patches, the inputs' fixture)
FAMILIES = {
    "clip": (dict(feature_type=FT, extract_method="uni_3"), [], "clips"),
    "resnet": (dict(feature_type="resnet18", batch_size=2, extraction_fps=8.0), [], "clips"),
    "r21d": (dict(feature_type="r21d_rgb", stack_size=2, step_size=2, extraction_fps=8.0),
             [(ExtractR21D, "_build", _small_r21d)], "clips"),
    "vggish": (dict(feature_type="vggish"), [], "wavs"),
    "vggish_torch": (dict(feature_type="vggish_torch"), [], "wavs"),
    "pwc": (dict(feature_type="pwc", side_size=48, batch_size=2, extraction_fps=10.0), [],
            "clips"),
    "raft": (dict(feature_type="raft", side_size=48, batch_size=2, extraction_fps=10.0),
             [(ExtractRAFT, "_model", _raft_2_iterations)], "clips"),
    "i3d_pwc": (dict(feature_type="i3d", flow_type="pwc", stack_size=10, step_size=20,
                     batch_size=2), [(ExtractI3D, "_model", _tiny_i3d)], "clips"),
    "i3d_raft": (dict(feature_type="i3d", flow_type="raft", stack_size=10, step_size=20,
                      batch_size=2), [(ExtractI3D, "_model", _tiny_i3d)], "clips"),
}


def _run(inputs, tmp_path, **kw):
    kw.setdefault("allow_random_init", True)
    kw.setdefault("decode_workers", 2)
    cfg = ExtractionConfig(video_paths=list(inputs), cpu=True, tmp_path=str(tmp_path / "tmp"),
                           output_path=str(tmp_path / "out"), **kw)
    ex = build_extractor(cfg, external_call=True)
    return ex, ex(device=torch.device("cpu"))


def _assert_same(got, want, atol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].shape == w[k].shape, k
            np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_video_batch_3_matches_solo(family, request, tmp_path, monkeypatch, small_tower):
    fields, patches, inputs = FAMILIES[family]
    for cls, name, fn in patches:
        monkeypatch.setattr(cls, name, fn)
    inputs = request.getfixturevalue(inputs)
    calls = []
    _, solo = _run(inputs, tmp_path / "solo", **fields)
    ex = build_extractor(ExtractionConfig(video_paths=list(inputs), cpu=True, video_batch=3,
                                          allow_random_init=True, tmp_path=str(tmp_path / "tmp"),
                                          **fields), external_call=True)
    real = type(ex).fetch_group

    def counted(self, handle):
        dicts = real(self, handle)
        calls.append(len(dicts))
        return dicts

    monkeypatch.setattr(type(ex), "fetch_group", counted)
    fused = ex(device=torch.device("cpu"))
    assert calls == [3, 1]  # a full group, then the partial one flushed
    _assert_same(fused, solo, ATOL)
    key = next(k for k in solo[0] if k not in ("fps", "timestamps_ms"))
    assert all(np.isfinite(d[key]).all() and d[key].size for d in fused)


def test_clip_matches_jax_at_video_batch_3(clips, tmp_path, small_tower):
    weights = str(tmp_path / "clip_small.npz")
    np.savez(weights, **openai_state_dict())
    _, ours = _run(clips, tmp_path / "port", feature_type=FT, extract_method="uni_3",
                   video_batch=3, weights_path=weights, inflight_groups=1)
    ref = JaxExtractCLIP(JaxConfig(
        feature_type=FT, video_paths=list(clips), extract_method="uni_3", video_batch=3,
        weights_path=weights, cpu=True, decoder="cv2", tmp_path=str(tmp_path / "jtmp"),
        output_path=str(tmp_path / "j")), external_call=True)()
    _assert_same(ours, ref, JAX_ATOL)


def test_pwc_matches_jax_at_video_batch_3(clips, tmp_path):
    sd = _seeded_state_dict(seed=4)
    weights = tmp_path / "pwc_net_sintel.pt"
    torch.save({f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}, weights)
    flags = dict(feature_type="pwc", side_size=48, batch_size=2, extraction_fps=10.0,
                 video_batch=3)
    _, ours = _run(clips, tmp_path / "port", weights_path=str(weights), **flags)
    jax_ex = JaxExtractPWC(JaxConfig(video_paths=list(clips), cpu=True, decoder="cv2",
                                     allow_random_init=True, tmp_path=str(tmp_path / "jtmp"),
                                     output_path=str(tmp_path / "j"), **flags),
                           external_call=True)
    jax_ex._host_params = jax_pwc_convert.convert_state_dict(sd)
    ref = jax_ex()
    assert ours[0]["pwc"].shape == ref[0]["pwc"].shape == (3, 2, 48, 64)
    _assert_same(ours, ref, FLOW_ATOL)


def test_order_kept_across_shape_keys_and_opt_outs(tmp_path, monkeypatch, small_tower):
    """fix_10 samples 3-12 frames of these clips: buckets 8, 16 and 24 are
    three shape keys, and a cap of 16 frames sends the 24-bucket video
    down the solo path, ahead of the groups still filling."""
    clips = [synth_video(str(tmp_path / f"c{i}.mp4"), n_frames=n, width=64, height=48, seed=i)
             for i, n in enumerate((8, 30, 10, 55, 32))]
    monkeypatch.setattr(ExtractCLIP, "AGG_MAX_FRAMES", 16)
    fields = dict(feature_type=FT, extract_method="fix_10")
    _, solo = _run(clips, tmp_path / "solo", **fields)
    ex, fused = _run(clips, tmp_path / "fused", video_batch=2, **fields)
    assert [d[FT].shape[0] for d in solo] == [3, 12, 4, 22, 12]
    assert [ex.agg_key(ex.prepare(c)) is None for c in clips] == [False, False, False, True, False]
    _assert_same(fused, solo, ATOL)


@pytest.mark.parametrize("family", ["pwc", "i3d_pwc"])
def test_over_cap_videos_decode_at_dispatch(family, clips, tmp_path, monkeypatch):
    """A video over the prefetch cap is handed over undecoded (flow:
    streamed window by window; I3D: decoded at dispatch), takes the solo
    path, and gives the features of an eager prepare."""
    fields, patches, _ = FAMILIES[family]
    for cls, name, fn in patches:
        monkeypatch.setattr(cls, name, fn)
    _, want = _run(clips, tmp_path / "eager", **fields)
    ex = build_extractor(ExtractionConfig(video_paths=list(clips), cpu=True, video_batch=3,
                                          allow_random_init=True, **fields), external_call=True)
    monkeypatch.setattr(type(ex), "_prefetch_frame_cap", lambda self, *a, **kw: 1)
    payload = ex.prepare(clips[0])
    assert isinstance(payload[0], str) and ex.agg_key(payload) is None
    _assert_same(ex(device=torch.device("cpu")), want, ATOL)


def _fail_first(monkeypatch, cls, name, exc):
    real, calls = getattr(cls, name), []

    def flaky(self, *a):
        calls.append(1)
        if len(calls) == 1:
            raise exc
        return real(self, *a)

    monkeypatch.setattr(cls, name, flaky)


def _clip_save_cfg(cls, clips, out, **kw):
    return cls(feature_type=FT, video_paths=list(clips), extract_method="uni_3", cpu=True,
               allow_random_init=True, on_extraction="save_numpy", video_batch=2,
               output_path=str(out), tmp_path=str(out) + "_tmp", **kw)


def _fallbacks(events):
    return [{k: e[k] for k in ("phase", "size", "videos", "message")}
            for e in events if e.get("event") == "group_fallback"]


@pytest.mark.parametrize("phase", ["dispatch", "fetch"])
def test_fused_failure_falls_back_to_solo_as_in_jax(clips, tmp_path, monkeypatch, small_tower,
                                                    phase, capsys):
    exc = RuntimeError(f"injected fused-{phase} failure")
    _fail_first(monkeypatch, ExtractCLIP, f"{phase}_group", exc)
    _fail_first(monkeypatch, JaxExtractCLIP, f"{phase}_group", exc)
    cfg = _clip_save_cfg(ExtractionConfig, clips, tmp_path / "port")
    build_extractor(cfg)(device=torch.device("cpu"))
    jax_cfg = _clip_save_cfg(JaxConfig, clips, tmp_path / "jax", decoder="cv2", preflight="off")
    JaxExtractCLIP(jax_cfg)()
    ours = faults.merge_manifest(cfg.output_path)
    ref = jax_faults.merge_manifest(jax_cfg.output_path)
    assert _fallbacks(ours["events"]) == _fallbacks(ref["events"]) == [{
        "phase": phase, "size": 2, "videos": clips[:2],
        "message": f"RuntimeError: injected fused-{phase} failure"}]
    assert (ours["done"], ours["failed"]) == (ref["done"], ref["failed"]) == (4, 0)
    assert "falling back to per-video dispatch" in capsys.readouterr().out
    _, clean = _run(clips, tmp_path / "clean", feature_type=FT, extract_method="uni_3")
    for c, want in zip(clips, clean):
        (saved,) = pathlib.Path(cfg.output_path).rglob(pathlib.Path(c).stem + "_*.npy")
        np.testing.assert_allclose(np.load(saved), want[FT], atol=ATOL, rtol=0)


@pytest.mark.parametrize("phase", ["dispatch", "fetch"])
def test_sticky_error_in_a_fused_group_stops_the_run(clips, tmp_path, monkeypatch, small_tower,
                                                     phase):
    _fail_first(monkeypatch, ExtractCLIP, f"{phase}_group", RuntimeError(STICKY))
    cfg = _clip_save_cfg(ExtractionConfig, clips, tmp_path / "out")
    build_extractor(cfg)(device=torch.device("cpu"))
    summary = faults.merge_manifest(cfg.output_path)
    assert {v: s["status"] for v, s in summary["videos"].items()} == {
        clips[0]: "failed", clips[1]: "failed"}  # the group; the rest unattempted
    assert len(summary["worker_deaths"]) == 1 and summary["worker_deaths"][0]["phase"] == phase
    assert not _fallbacks(summary["events"])
