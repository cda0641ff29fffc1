"""``--preprocess device`` through the port's extractors.

Every family the JAX package admits to the flag is held to the port's own
host path: CLIP and ResNet within ``E2E_DRIFT`` = 5e-3 (absolute, the
JAX package's budget, ``tests/test_device_preprocess.py:41``); the flow
nets and I3D within 5e-3 relative L2 with a ``--side_size`` resize, and
RAFT and PWC without one equal to the host path (the identity taps give
the model the host's ``InputPadder.pad`` input bit for bit). CLIP is also
held to the JAX package's device path (1e-4, the tolerance of
``test_torch_aggregation.py``). A ``--video_batch 2`` group of two source
resolutions sharing one bucket gives its solo runs, a ResNet video over
its prefetch cap streams to the prepared path's features, and a gated CLIP
run records the JAX package's ``delta_gated`` event.

Small sizes keep this cheap: a 2-layer CLIP tower, RAFT at 2 iterations,
I3D with the stand-in towers of ``test_torch_aggregation.py`` behind the
real stack chains, and clips of 64x48 to 100x96 pixels. Every JAX config
passes ``decoder="cv2"``: the JAX package's native decoder can abort the
whole process on a decode thread.
"""

import numpy as np
import pytest
import torch

from video_features_tpu.config import ExtractionConfig as JaxConfig
from video_features_tpu.models.clip import model as jax_model
from video_features_tpu.models.clip.extract_clip import ExtractCLIP as JaxExtractCLIP
from video_features_tpu.runtime import faults as jax_faults
from video_features_tpu_torch.config import ExtractionConfig, sanity_check
from video_features_tpu_torch.extract.registry import build_extractor
from video_features_tpu_torch.models.clip import model as port_model
from video_features_tpu_torch.models.i3d.extract_i3d import ExtractI3D
from video_features_tpu_torch.models.raft.extract_raft import ExtractRAFT
from video_features_tpu_torch.models.resnet.extract_resnet import ExtractResNet
from video_features_tpu_torch.runtime import faults
from video_features_tpu_torch.utils.synth import synth_video

from test_torch_aggregation import TinyFlow, TinyTower, _raft_2_iterations, _tiny_i3d
from test_torch_clip import SMALL, openai_state_dict
from torch_threads import one_torch_thread  # noqa: F401 - an autouse fixture

FT = "CLIP-ViT-B/32"
E2E_DRIFT = 5e-3
JAX_ATOL = 1e-4
# fused vs solo: the same fp32 arithmetic on batches of other sizes
FUSED_ATOL = 1e-5


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """Three resolutions sharing the (64, 128) bucket (the first and the
    last also share PWC's 40x66 grid at --side_size 40), and one of
    another."""
    d = tmp_path_factory.mktemp("devpre_media")
    return [synth_video(str(d / "a.mp4"), n_frames=10, width=100, height=60, seed=0),
            synth_video(str(d / "b.mp4"), n_frames=12, width=90, height=64, seed=1),
            synth_video(str(d / "c.mp4"), n_frames=11, width=64, height=48, seed=2),
            synth_video(str(d / "d.mp4"), n_frames=9, width=101, height=61, seed=3)]


@pytest.fixture
def small_tower(monkeypatch):
    monkeypatch.setitem(port_model.CONFIGS, FT, port_model.CLIPVisionConfig(**SMALL))
    monkeypatch.setitem(jax_model.CONFIGS, FT, jax_model.CLIPVisionConfig(**SMALL))


def _run(inputs, tmp_path, **kw):
    kw.setdefault("allow_random_init", True)
    cfg = sanity_check(ExtractionConfig(video_paths=list(inputs), cpu=True,
                                        tmp_path=str(tmp_path / "tmp"),
                                        output_path=str(tmp_path / "out"), **kw))
    return build_extractor(cfg, external_call=True)(device=torch.device("cpu"))


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _keys(d):
    return [k for k in d if k not in ("fps", "timestamps_ms")]


def _assert_close(got, want, atol=None, rel=None, equal=False):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        np.testing.assert_array_equal(g["timestamps_ms"], w["timestamps_ms"])
        for k in _keys(w):
            assert g[k].shape == w[k].shape and np.isfinite(g[k]).all(), k
            if equal:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            elif rel is not None:
                assert _rel_l2(g[k], w[k]) <= rel, (k, _rel_l2(g[k], w[k]))
            else:
                np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def clip_weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("devpre_w") / "clip_small.npz")
    np.savez(path, **openai_state_dict())
    return path


def test_clip_device_matches_host_and_jax(mixed, tmp_path, small_tower, clip_weights):
    flags = dict(feature_type=FT, extract_method="uni_4", weights_path=clip_weights)
    host = _run(mixed, tmp_path / "host", **flags)
    dev = _run(mixed, tmp_path / "dev", preprocess="device", **flags)
    _assert_close(dev, host, atol=E2E_DRIFT)
    ref = JaxExtractCLIP(JaxConfig(
        video_paths=list(mixed), preprocess="device", cpu=True, decoder="cv2",
        tmp_path=str(tmp_path / "jtmp"), output_path=str(tmp_path / "j"), **flags),
        external_call=True)()
    _assert_close(dev, ref, atol=JAX_ATOL)


# family -> (config fields, patches, tolerance against the host path)
FAMILIES = {
    "clip": (dict(feature_type=FT, extract_method="uni_4"), [], dict(atol=E2E_DRIFT)),
    "resnet": (dict(feature_type="resnet18", batch_size=4, extraction_fps=5.0), [],
               dict(atol=E2E_DRIFT)),
    "pwc": (dict(feature_type="pwc", side_size=40, batch_size=2, extraction_fps=5.0), [],
            dict(rel=E2E_DRIFT)),
    "raft": (dict(feature_type="raft", side_size=40, batch_size=2, extraction_fps=5.0),
             [(ExtractRAFT, "_model", _raft_2_iterations)], dict(rel=E2E_DRIFT)),
    "i3d_pwc": (dict(feature_type="i3d", flow_type="pwc", stack_size=10, step_size=10,
                     batch_size=2), [(ExtractI3D, "_model", _tiny_i3d)], dict(rel=E2E_DRIFT)),
    "i3d_raft": (dict(feature_type="i3d", flow_type="raft", stack_size=10, step_size=10,
                      batch_size=2), [(ExtractI3D, "_model", _tiny_i3d)], dict(rel=E2E_DRIFT)),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_device_matches_host(family, mixed, tmp_path, monkeypatch, small_tower):
    fields, patches, tol = FAMILIES[family]
    for cls, name, fn in patches:
        monkeypatch.setattr(cls, name, fn)
    host = _run(mixed, tmp_path / "host", **fields)
    dev = _run(mixed, tmp_path / "dev", preprocess="device", **fields)
    _assert_close(dev, host, **tol)


@pytest.mark.parametrize("family", ["raft", "pwc"])
def test_flow_identity_contract_equals_host(family, mixed, tmp_path, monkeypatch):
    """No --side_size: the device flows equal the host flows."""
    fields, patches, _ = FAMILIES[family]
    for cls, name, fn in patches:
        monkeypatch.setattr(cls, name, fn)
    fields = dict(fields, side_size=None, extraction_fps=None)
    host = _run(mixed[:2], tmp_path / "host", **fields)
    dev = _run(mixed[:2], tmp_path / "dev", preprocess="device", **fields)
    assert dev[0][family].shape == (9, 2, 60, 100)
    _assert_close(dev, host, equal=True)


@pytest.mark.parametrize("family", ["i3d_pwc", "i3d_raft"])
def test_i3d_crop_geometry_equals_host(family, tmp_path, monkeypatch):
    """A 330x256 clip needs no min-edge-256 resize, so the taps are the
    identity and any difference is geometry: RAFT's flow grid is 256x384
    with the image at column 27, where the host pads to 256x336 at column
    3, and both 224 crops must read the same pixels (the stand-in flow net
    is pointwise, so an off-by-one crop shows)."""
    fields, patches, _ = FAMILIES[family]
    for cls, name, fn in patches:
        monkeypatch.setattr(cls, name, fn)
    clip = [synth_video(str(tmp_path / "e.mp4"), n_frames=12, width=330, height=256, seed=4)]
    host = _run(clip, tmp_path / "host", **fields)
    dev = _run(clip, tmp_path / "dev", preprocess="device", **fields)
    _assert_close(dev, host, equal=True)


# two clips of other resolutions whose contracts agree: the bucket (CLIP,
# ResNet), and the flow grid (RAFT's 128-px floor; PWC's resized shape)
@pytest.mark.parametrize("family,pair", [("clip", (0, 1)), ("resnet", (0, 1)), ("pwc", (0, 3)),
                                         ("raft", (0, 1))])
def test_mixed_resolution_group_matches_solo(family, pair, mixed, tmp_path, monkeypatch,
                                             small_tower):
    """One ``--video_batch 2`` group of two source resolutions, each video
    with its own taps, gives the solo runs."""
    fields, patches, _ = FAMILIES[family]
    for cls, name, fn in patches:
        monkeypatch.setattr(cls, name, fn)
    clips = [mixed[i] for i in pair]
    cfg = ExtractionConfig(video_paths=clips, cpu=True, allow_random_init=True,
                           preprocess="device", video_batch=2, **fields)
    ex = build_extractor(cfg, external_call=True)
    keys = [ex.agg_key(ex.prepare(c)) for c in clips]
    assert keys[0] is not None and keys[0] == keys[1] and keys[0][0] == "dev"
    calls = []
    real = type(ex).fetch_group
    monkeypatch.setattr(type(ex), "fetch_group",
                        lambda self, h: calls.append(1) or real(self, h))
    fused = ex(device=torch.device("cpu"))
    assert calls == [1]
    solo = _run(clips, tmp_path / "solo", preprocess="device", **fields)
    _assert_close(fused, solo, atol=FUSED_ATOL)


def test_taps_are_placed_once_per_resolution(mixed, tmp_path, monkeypatch, small_tower):
    """Three videos of two source resolutions: two placements of taps,
    whatever the number of dispatches."""
    from video_features_tpu_torch.extract import base

    placed = []
    real = base.place_taps
    monkeypatch.setattr(base, "place_taps", lambda taps, device: placed.append(1) or real(
        taps, device))
    out = _run([mixed[0], mixed[2], mixed[0]], tmp_path, feature_type=FT,
               extract_method="uni_4", preprocess="device")
    assert len(out) == 3 and len(placed) == 2
    np.testing.assert_array_equal(out[0][FT], out[2][FT])


@pytest.mark.parametrize("preprocess", ["host", "device"])
def test_resnet_over_its_cap_streams(preprocess, mixed, tmp_path, monkeypatch):
    fields = dict(FAMILIES["resnet"][0], preprocess=preprocess, video_batch=2)
    prepared = _run(mixed, tmp_path / "prepared", **fields)
    monkeypatch.setattr(ExtractResNet, "_prefetch_frame_cap", lambda self, *a, **kw: 1)
    ex = build_extractor(ExtractionConfig(video_paths=list(mixed), cpu=True,
                                          allow_random_init=True, **fields), external_call=True)
    payload = ex.prepare(mixed[0])
    # the over-cap payload carries its resolved decode source (--fps_retarget)
    assert payload == ("stream", mixed[0], ex._fps_source(mixed[0]))
    assert ex.agg_key(payload) is None
    _assert_close(ex(device=torch.device("cpu")), prepared, atol=FUSED_ATOL)


def test_gated_clip_records_delta_gated_as_jax(mixed, tmp_path, small_tower, clip_weights):
    """A threshold no change reaches keeps frame 0 alone: every row is frame
    0's, and both packages write one ``delta_gated`` event a video."""
    flags = dict(feature_type=FT, extract_method="uni_4", weights_path=clip_weights,
                 preprocess="device", frame_delta_threshold=255.0, video_paths=mixed[:2],
                 cpu=True, on_extraction="save_numpy")
    cfg = ExtractionConfig(output_path=str(tmp_path / "port"), tmp_path=str(tmp_path / "t"),
                           **flags)
    build_extractor(sanity_check(cfg))(device=torch.device("cpu"))
    jax_cfg = JaxConfig(output_path=str(tmp_path / "jax"), tmp_path=str(tmp_path / "jt"),
                        decoder="cv2", preflight="off", **flags)
    JaxExtractCLIP(jax_cfg)()

    def gated(events):
        return sorted((e["video"], e["skipped"], e["total"]) for e in events
                      if e.get("event") == "delta_gated")

    ours = gated(faults.merge_manifest(cfg.output_path)["events"])
    assert ours == gated(jax_faults.merge_manifest(jax_cfg.output_path)["events"])
    assert ours == [(mixed[0], 3, 4), (mixed[1], 3, 4)]
    gated_rows = _run(mixed[:1], tmp_path / "g", feature_type=FT, extract_method="uni_4",
                      weights_path=clip_weights, frame_delta_threshold=255.0)[0][FT]
    ungated = _run(mixed[:1], tmp_path / "u", feature_type=FT, extract_method="uni_4",
                   weights_path=clip_weights, frame_delta_threshold=0.0)[0][FT]
    np.testing.assert_array_equal(gated_rows, np.repeat(ungated[:1], 4, axis=0))
