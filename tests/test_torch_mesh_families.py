"""``--sharding mesh`` for ResNet, R(2+1)D, VGGish, RAFT, PWC and I3D.

- ``parallel/sharding.py``'s new pieces: ``row_sizes``/``split_rows``
  (uneven blocks, rows that sit out), ``halo_split`` (its pairs are the
  global pairs, by Hypothesis over lengths 2-70 and ``data`` 1-8),
  ``temporal_halo`` (neighbours' frames, zeros at the global ends),
  ``gather_rows`` and ``replicate`` (one copy a distinct device);
- each family's extractor on a mesh of repeated CPU devices against the
  port's one-device run. The math of a row is the one-device math on
  fewer rows; the CPU convolutions block their work by batch size, so
  the results may differ in the last bits: held to ``ATOL`` (measured 0
  to 4e-7 here);
- PWC's cost volume runs once per level on each shard (its plain version
  here, counted at each call with the shard's pair count);
- each family against the JAX package at one mesh shape, through the
  converter route, and against the JAX package's own mesh run where its
  tests run one (RAFT, R(2+1)D, I3D rgb at ``stack_size`` 10 on 8 rows);
- the refusals that stand, against the JAX package's messages.

The I3D extractor cases against the port's one-device run use a narrow
I3D (``channel_div`` 8) to stay cheap; ``I3D.forward_sharded`` itself is
held against ``forward`` in ``test_torch_i3d_sequence_parallel.py``.
"""

import functools
import pathlib

import cv2
import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from video_features_tpu.config import ExtractionConfig as JaxConfig
from video_features_tpu.config import sanity_check as jax_sanity_check
from video_features_tpu.models.i3d import convert as jax_i3d_convert
from video_features_tpu.models.i3d.extract_i3d import ExtractI3D as JaxExtractI3D
from video_features_tpu.models.pwc import convert as jax_pwc_convert
from video_features_tpu.models.pwc.extract_pwc import ExtractPWC as JaxExtractPWC
from video_features_tpu.models.r21d import convert as jax_r21d_convert
from video_features_tpu.models.r21d.extract_r21d import ExtractR21D as JaxExtractR21D
from video_features_tpu.models.raft import convert as jax_raft_convert
from video_features_tpu.models.raft import extract_raft as jax_raft_extract
from video_features_tpu.models.raft import model as jax_raft_model
from video_features_tpu.models.raft.extract_raft import ExtractRAFT as JaxExtractRAFT
from video_features_tpu.models.resnet import convert as jax_resnet_convert
from video_features_tpu.models.resnet.extract_resnet import ExtractResNet as JaxExtractResNet
from video_features_tpu.models.vggish.extract_vggish import ExtractVGGish as JaxExtractVGGish
from video_features_tpu.parallel import scheduler as jax_scheduler
from video_features_tpu.parallel.sharding import make_mesh as jax_make_mesh
from video_features_tpu_torch.config import ExtractionConfig, sanity_check
from video_features_tpu_torch.extract.registry import build_extractor
from video_features_tpu_torch.models.i3d import extract_i3d
from video_features_tpu_torch.models.i3d.model import I3D
from video_features_tpu_torch.models.pwc import model as pwc_model
from video_features_tpu_torch.models.pwc.model import PWCNet
from video_features_tpu_torch.models.pwc.model import init_weights as pwc_init
from video_features_tpu_torch.models.r21d.model import R2Plus1D
from video_features_tpu_torch.models.raft.model import RAFT
from video_features_tpu_torch.models.vggish.model import VGGish
from video_features_tpu_torch.models.vggish.model import init_weights as vggish_init
from video_features_tpu_torch.parallel import scheduler, sharding
from video_features_tpu_torch.utils.synth import synth_wav

from test_torch_i3d import seeded_i3d
from test_torch_r21d import seeded_r21d
from test_torch_raft import seeded_raft
from test_torch_resnet import seeded_resnet
from torch_threads import one_torch_thread  # noqa: F401 - an autouse fixture

CPU = torch.device("cpu")
ATOL = 1e-5
# the port against the JAX package, each family's bound of its own test
# file: ResNet and R(2+1)D 1e-4, RAFT's flow 1e-4 of its scale, PWC's
# flow 1e-4, VGGish 1e-5 of the embedding's L2, I3D rgb at the JAX
# package's own mesh tolerance (tests/test_parallel.py)
JAX_ATOL = {"resnet18": 1e-4, "r21d_rgb": 1e-4, "pwc": 1e-4, "i3d": 2e-4}
RAFT_RTOL = 1e-4
VGGISH_RTOL = 1e-5


def _cpus(n):
    return [CPU] * n


def _mesh(n):
    return sharding.make_mesh(_cpus(n))


# --- the pieces ------------------------------------------------------------------

@pytest.mark.parametrize("n,data,block,want", [
    (16, 2, 1, [8, 8]),
    (10, 4, 1, [3, 3, 3, 1]),
    (5, 8, 1, [1, 1, 1, 1, 1, 0, 0, 0]),
    (64, 3, 8, [24, 24, 16]),
    (10, 8, 8, [8, 2, 0, 0, 0, 0, 0, 0]),
    (65, 8, 8, [16, 16, 16, 16, 1, 0, 0, 0]),
])
def test_split_rows_uneven_blocks_and_rows_that_sit_out(n, data, block, want):
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    parts, sizes = sharding.split_rows(x, _mesh(data), block)
    assert sizes == sharding.row_sizes(n, data, block) == want
    assert [p.shape[0] for p in parts] == [s for s in want if s]
    assert all(s % block == 0 for s in [s for s in want if s][:-1])
    back = sharding.gather_rows(parts, CPU, sizes)
    np.testing.assert_array_equal(back.numpy(), x)
    with pytest.raises(ValueError, match="gather_rows"):
        sharding.gather_rows(parts[:-1], CPU, sizes)


@settings(max_examples=150, deadline=None)
@given(frames=st.integers(2, 70), data=st.integers(1, 8), block=st.sampled_from([1, 8]))
def test_halo_split_pairs_are_the_global_pairs(frames, data, block):
    x = np.arange(frames, dtype=np.int64)[:, None]
    parts, sizes = sharding.halo_split(x, sharding.make_mesh(_cpus(data)), block)
    ran = [s for s in sizes if s]
    assert sum(sizes) == frames - 1 and len(sizes) == data
    assert sizes[:len(ran)] == ran  # the rows that sit out are the last ones
    assert all(s % block == 0 for s in ran[:-1])
    assert [p.shape[0] for p in parts] == [s + 1 for s in ran]
    pairs = [(int(a), int(b)) for p in parts for a, b in zip(p[:-1, 0], p[1:, 0])]
    assert pairs == [(i, i + 1) for i in range(frames - 1)]
    assert int(parts[-1][-1, 0]) == frames - 1  # the last row: no extra frame


@pytest.mark.parametrize("lengths,lo,hi", [
    ([8, 8], 2, 3), ([4, 1, 2], 2, 3), ([3, 3, 3], 1, 1), ([8, 1], 0, 1), ([2, 2, 5], 0, 1),
    ([5], 2, 3),
])
@pytest.mark.parametrize("ends", [True, False])
def test_temporal_halo_takes_neighbours_and_zeros_at_the_ends(lengths, lo, hi, ends):
    t = sum(lengths)
    x = torch.arange(1, 2 * t + 1, dtype=torch.float32).reshape(1, 2, t, 1, 1)
    parts = list(torch.split(x, lengths, dim=2))
    padded = torch.nn.functional.pad(x, (0, 0, 0, 0, lo, hi)) if ends else x
    got = sharding.temporal_halo(parts, lo, hi, ends=ends)
    start = 0
    for p, g in zip(parts, got):
        a = start + (0 if ends else -min(lo, start))
        b = start + p.shape[2] + (lo + hi if ends else min(hi, t - start - p.shape[2]))
        torch.testing.assert_close(g, padded[:, :, a:b], rtol=0, atol=0)
        start += p.shape[2]


def test_replicate_holds_one_copy_a_distinct_device():
    built = []

    def build(device):
        built.append(device)
        return torch.nn.Linear(4, 3).to(device)

    reps = sharding.replicate(build, _mesh(3))
    assert built == [CPU] and len(reps.copies) == 1
    assert reps.rows == [reps.copies[0]] * 3 and reps.device == CPU
    x = np.random.default_rng(0).standard_normal((7, 4)).astype(np.float32)
    with torch.inference_mode():
        got = reps.run(x)
        want = reps.copies[0](torch.from_numpy(x))
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


# --- the extractors: a mesh against one device -------------------------------------

@pytest.fixture(scope="module")
def audio(tmp_path_factory):
    return synth_wav(str(tmp_path_factory.mktemp("audio") / "tone.wav"), seconds=5.0, seed=3)


@pytest.fixture
def small_r21d(monkeypatch):
    monkeypatch.setattr(R2Plus1D.__init__, "__defaults__", ((1, 1, 1, 1), 400))


@pytest.fixture
def fast_raft(monkeypatch):
    monkeypatch.setattr(RAFT.__init__, "__defaults__", (2,))


@pytest.fixture
def narrow_i3d(monkeypatch):
    monkeypatch.setattr(extract_i3d, "I3D", functools.partial(I3D, channel_div=8))


def _cfg(ft, path, tmp_path, **kw):
    return ExtractionConfig(feature_type=ft, video_paths=[path], allow_random_init=True,
                            decoder="cv2", output_path=str(tmp_path / "o"),
                            tmp_path=str(tmp_path / "t"), **kw)


def _one_and_mesh(ft, path, tmp_path, data, **kw):
    one = build_extractor(sanity_check(_cfg(ft, path, tmp_path, **kw)),
                          external_call=True)(device=CPU)
    ex = build_extractor(sanity_check(_cfg(ft, path, tmp_path, sharding="mesh", **kw)),
                         external_call=True)
    return one, ex(device=_mesh(data))


def _assert_same(one, got, keys):
    assert len(one) == len(got) == 1
    for k in keys:
        assert one[0][k].shape == got[0][k].shape and one[0][k].size
        np.testing.assert_allclose(got[0][k], one[0][k], atol=ATOL, rtol=0)
    for k in ("fps", "timestamps_ms"):
        if k in one[0]:
            np.testing.assert_array_equal(got[0][k], one[0][k])


@pytest.mark.parametrize("ft,data,kw", [
    ("resnet18", 2, dict(extraction_fps=5.0, batch_size=5)),
    ("resnet18", 3, dict(extraction_fps=5.0, batch_size=5)),
    ("resnet18", 2, dict(extraction_fps=5.0, batch_size=3, video_batch=2, decode_workers=1)),
    ("r21d_rgb", 2, dict(extraction_fps=10.0, stack_size=8, step_size=8, batch_size=2)),
    ("r21d_rgb", 3, dict(extraction_fps=10.0, stack_size=8, step_size=8, batch_size=2,
                         video_batch=2, decode_workers=1)),
    ("vggish", 2, {}),
    ("vggish_torch", 4, dict(video_batch=2, decode_workers=1)),
], ids=["resnet18-2", "resnet18-3", "resnet18-fused", "r21d-2", "r21d-fused-3", "vggish-2",
        "vggish_torch-fused-4"])
def test_data_parallel_family_on_a_mesh_matches_one_device(ft, data, kw, sample_video, audio,
                                                            tmp_path, small_r21d):
    path = audio if ft.startswith("vggish") else sample_video
    one, got = _one_and_mesh(ft, path, tmp_path, data, **kw)
    _assert_same(one, got, [ft])


@pytest.fixture
def k2_calls(monkeypatch):
    """Each cost volume PWC computes, as (pairs, device); the plain
    version runs as before."""
    calls = []
    real = pwc_model.local_correlation

    def counted(f1, f2, *a, **kw):
        calls.append((f1.shape[0], f1.device))
        return real(f1, f2, *a, **kw)

    monkeypatch.setattr(pwc_model, "local_correlation", counted)
    return calls


@pytest.mark.parametrize("data,kw,per_window", [
    (2, {}, [2, 2]),
    (4, {}, [1, 1, 1, 1]),
    (3, dict(preprocess="device"), [2, 2]),
], ids=["pwc-2", "pwc-4", "pwc-device-3"])
def test_pwc_on_a_mesh_runs_the_cost_volume_per_shard(data, kw, per_window, sample_video,
                                                      tmp_path, k2_calls):
    """12 frames at 5 fps in windows of 4 pairs (the tail window of 3
    pairs padded to 4): each window's 5 frames split over the rows with
    their halo frame, and each row computes its 5 cost volumes at its own
    pair count."""
    common = dict(extraction_fps=5.0, side_size=64, batch_size=4, **kw)
    one = build_extractor(sanity_check(_cfg("pwc", sample_video, tmp_path, **common)),
                          external_call=True)(device=CPU)
    assert [n for n, _ in k2_calls] == [4] * 5 * 3
    k2_calls.clear()
    got = build_extractor(sanity_check(_cfg("pwc", sample_video, tmp_path, sharding="mesh",
                                            **common)), external_call=True)(device=_mesh(data))
    _assert_same(one, got, ["pwc"])
    assert got[0]["pwc"].shape == (11, 2, 64, 85)
    want = [n for _ in range(3) for n in per_window for _ in range(5)]
    assert [n for n, _ in k2_calls] == want
    assert {d for _, d in k2_calls} == {CPU}


@pytest.mark.parametrize("ft,data,kw", [
    ("raft", 3, dict(extraction_fps=5.0, side_size=64, batch_size=4)),
    ("raft", 2, dict(extraction_fps=5.0, side_size=64, batch_size=4, preprocess="device")),
    ("pwc", 2, dict(extraction_fps=5.0, side_size=64, batch_size=3, video_batch=2,
                    decode_workers=1)),
], ids=["raft-3", "raft-device-2", "pwc-fused-2"])
def test_flow_family_on_a_mesh_matches_one_device(ft, data, kw, sample_video, tmp_path,
                                                  fast_raft):
    one, got = _one_and_mesh(ft, sample_video, tmp_path, data, **kw)
    _assert_same(one, got, [ft])


@pytest.fixture(scope="module")
def flow_jpegs(sample_video, tmp_path_factory):
    """20 flow_x/flow_y JPEG pairs in a dir named by the clip's stem."""
    d = tmp_path_factory.mktemp("mesh_flow") / pathlib.Path(sample_video).stem
    d.mkdir()
    rng = np.random.RandomState(1)
    for i in range(20):
        for axis in ("x", "y"):
            cv2.imwrite(str(d / f"flow_{axis}_{i:05d}.jpg"),
                        rng.randint(0, 256, size=(240, 320), dtype=np.uint8))
    return str(d)


@pytest.mark.parametrize("data,kw", [
    (8, dict(flow_type="pwc")),
    (3, dict(flow_type="raft", preprocess="device")),
    (2, dict(flow_type="flow", stack_size=16, step_size=4)),
], ids=["pwc-8", "raft-device-3", "disk-flow-2"])
def test_i3d_on_a_mesh_matches_one_device(data, kw, sample_video, flow_jpegs, tmp_path,
                                          narrow_i3d, fast_raft, k2_calls):
    """Both streams of one 10-pair stack (12 frames at 5 fps), or with disk
    flow two 16-frame stacks of the 20 flow images: each stream's time
    blocks of 8 (a 10-frame stack at ``data`` 8 or 3 runs on two rows,
    8 + 2, the other rows sit out); RAFT with ``--preprocess device``, its
    taps and crop offsets on each row."""
    kw = dict(dict(stack_size=10, step_size=10, extraction_fps=5.0), **kw)
    if kw["flow_type"] == "flow":
        kw.pop("extraction_fps")
        kw["flow_paths"] = [flow_jpegs]
    one, got = _one_and_mesh("i3d", sample_video, tmp_path, data, **kw)
    _assert_same(one, got, ["rgb", "flow"])
    assert got[0]["rgb"].shape == ((2, 128) if kw["flow_type"] == "flow" else (1, 128))
    if kw["flow_type"] == "pwc":  # one device: 5 at N=10; the mesh: 5 a row, N=8 and N=2
        assert [n for n, _ in k2_calls] == [10] * 5 + [8] * 5 + [2] * 5


# --- against the JAX package ---------------------------------------------------------

def _np_sd(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _jax_ex(cls, ft, path, tmp_path, params, **kw):
    ex = cls(JaxConfig(feature_type=ft, video_paths=[path], cpu=True, decoder="cv2",
                       allow_random_init=True, output_path=str(tmp_path / "jax"),
                       tmp_path=str(tmp_path / "tmp"), **kw), external_call=True)
    ex.progress.disable = True
    ex._host_params = params
    return ex


def test_resnet_mesh_matches_jax(sample_video, tmp_path):
    model = seeded_resnet("resnet18", seed=3)
    weights = tmp_path / "resnet18.pth"
    torch.save(model.state_dict(), weights)
    kw = dict(extraction_fps=5.0, batch_size=5)
    (ours,) = build_extractor(sanity_check(_cfg("resnet18", sample_video, tmp_path,
                                                sharding="mesh", weights_path=str(weights),
                                                **kw)), external_call=True)(device=_mesh(3))
    (ref,) = _jax_ex(JaxExtractResNet, "resnet18", sample_video, tmp_path,
                     jax_resnet_convert.convert_state_dict(_np_sd(model), "resnet18"), **kw)([0])
    assert ours["resnet18"].shape == ref["resnet18"].shape == (12, 512)
    np.testing.assert_allclose(ours["resnet18"], ref["resnet18"], atol=JAX_ATOL["resnet18"],
                               rtol=0)


def test_r21d_mesh_matches_the_jax_mesh(sample_video, tmp_path):
    """``tests/test_parallel.py``'s R(2+1)D mesh run (``batch_size`` 4, the
    stack batch over 'data') on the JAX side, over 2 rows on both: 24
    frames at 10 fps in 3 stacks of 8, padded to 4."""
    model = seeded_r21d(seed=1)
    weights = tmp_path / "r2plus1d_18.pth"
    torch.save(model.state_dict(), weights)
    kw = dict(extraction_fps=10.0, stack_size=8, step_size=8, batch_size=4)
    (ours,) = build_extractor(sanity_check(_cfg("r21d_rgb", sample_video, tmp_path,
                                                sharding="mesh", weights_path=str(weights),
                                                **kw)), external_call=True)(device=_mesh(2))
    ex = _jax_ex(JaxExtractR21D, "r21d_rgb", sample_video, tmp_path,
                 jax_r21d_convert.convert_state_dict(_np_sd(model)), **kw)
    (ref,) = ex([0], device=jax_make_mesh(jax.devices()[:2], model=1))
    assert ours["r21d_rgb"].shape == ref["r21d_rgb"].shape == (3, 512)
    np.testing.assert_allclose(ours["r21d_rgb"], ref["r21d_rgb"], atol=JAX_ATOL["r21d_rgb"],
                               rtol=0)


def test_vggish_mesh_matches_jax(audio, tmp_path):
    model = vggish_init(VGGish(), seed=3)
    weights = str(tmp_path / "vggish.npz")
    np.savez(weights, **_np_sd(model))
    (ours,) = build_extractor(sanity_check(_cfg("vggish", audio, tmp_path, sharding="mesh",
                                                weights_path=weights)),
                              external_call=True)(device=_mesh(2))
    (ref,) = JaxExtractVGGish(JaxConfig(feature_type="vggish", video_paths=[audio], cpu=True,
                                        weights_path=weights, tmp_path=str(tmp_path / "tmp"),
                                        output_path=str(tmp_path / "jax")),
                              external_call=True)([0])
    a, b = ours["vggish"], ref["vggish"]
    assert a.shape == b.shape == (5, 128)
    assert np.linalg.norm(a - b) <= VGGISH_RTOL * np.linalg.norm(b)


def test_pwc_mesh_matches_jax(sample_video, tmp_path):
    sd = _np_sd(pwc_init(PWCNet(), seed=4))
    weights = tmp_path / "pwc_net_sintel.pt"
    torch.save({f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}, weights)
    kw = dict(extraction_fps=2.5, side_size=64, batch_size=4)
    (ours,) = build_extractor(sanity_check(_cfg("pwc", sample_video, tmp_path, sharding="mesh",
                                                weights_path=str(weights), **kw)),
                              external_call=True)(device=_mesh(2))
    (ref,) = _jax_ex(JaxExtractPWC, "pwc", sample_video, tmp_path,
                     jax_pwc_convert.convert_state_dict(sd), **kw)([0])
    assert ours["pwc"].shape == ref["pwc"].shape == (5, 2, 64, 85)
    np.testing.assert_allclose(ours["pwc"], ref["pwc"], atol=JAX_ATOL["pwc"], rtol=0)


def test_raft_mesh_matches_the_jax_mesh(sample_video, tmp_path, monkeypatch):
    """``tests/test_parallel.py``'s RAFT mesh run (``batch_size`` 8, the
    frame axis over 'data'), here over 6 frames at 2.5 fps and 4 rows on
    both sides: 5 pairs in one window; both networks at 3 update
    iterations (the extractors' builds patched), as ``test_torch_raft``
    holds the model at."""
    monkeypatch.setattr(RAFT.__init__, "__defaults__", (3,))
    monkeypatch.setattr(jax_raft_extract, "build", functools.partial(jax_raft_model.build, 3))
    model = seeded_raft(iters=3)
    weights = tmp_path / "raft-sintel.pth"
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()}, weights)
    kw = dict(extraction_fps=2.5, side_size=128, batch_size=8)
    (ours,) = build_extractor(sanity_check(_cfg("raft", sample_video, tmp_path, sharding="mesh",
                                                weights_path=str(weights), **kw)),
                              external_call=True)(device=_mesh(4))
    ex = _jax_ex(JaxExtractRAFT, "raft", sample_video, tmp_path,
                 jax_raft_convert.convert_state_dict(_np_sd(model)), **kw)
    (ref,) = ex([0], device=jax_make_mesh(jax.devices()[:4], model=1))
    a, b = ours["raft"], ref["raft"]
    assert a.shape == b.shape == (5, 2, 128, 170)
    np.testing.assert_allclose(a, b, atol=RAFT_RTOL * np.abs(b).max(), rtol=0)


def test_i3d_rgb_mesh_matches_the_jax_mesh(sample_video, tmp_path):
    """``tests/test_parallel.py``'s I3D mesh run: the rgb stream of a
    ``stack_size`` 10 stack on 8 rows (here one stack, 12 frames at 5
    fps; the port's blocks are 8 + 2 frames, the other six rows sit out),
    held at that test's tolerance."""
    model = seeded_i3d(3, seed=6)
    weights = tmp_path / "weights"
    weights.mkdir()
    torch.save(model.state_dict(), weights / "i3d_rgb.pt")
    kw = dict(flow_type="pwc", streams=["rgb"], stack_size=10, step_size=10,
              extraction_fps=5.0)
    (ours,) = build_extractor(sanity_check(_cfg("i3d", sample_video, tmp_path, sharding="mesh",
                                                weights_path=str(weights), **kw)),
                              external_call=True)(device=_mesh(8))
    ex = _jax_ex(JaxExtractI3D, "i3d", sample_video, tmp_path,
                 {"rgb": jax_i3d_convert.convert_state_dict(_np_sd(model))}, **kw)
    (ref,) = ex([0], device=jax_make_mesh(jax.devices(), model=1))
    assert ours["rgb"].shape == ref["rgb"].shape == (1, 1024)
    np.testing.assert_allclose(ours["rgb"], ref["rgb"], atol=JAX_ATOL["i3d"], rtol=0)


# --- refusals: the JAX package's messages --------------------------------------------

@pytest.mark.parametrize("ft,port_cls,jax_cls,kw", [
    ("resnet50", "ExtractResNet", JaxExtractResNet, dict(mesh_model=2)),
    ("r21d_rgb", "ExtractR21D", JaxExtractR21D, dict(mesh_model=2)),
    ("vggish", "ExtractVGGish", JaxExtractVGGish, dict(mesh_model=2)),
    ("pwc", "ExtractPWC", JaxExtractPWC, dict(mesh_context=True)),
], ids=["resnet50-tp", "r21d-tp", "vggish-tp", "pwc-context"])
def test_mesh_refusals_that_stand_match_jax(ft, port_cls, jax_cls, kw, sample_video, tmp_path):
    common = dict(feature_type=ft, video_paths=[sample_video], allow_random_init=True,
                  sharding="mesh", output_path=str(tmp_path / "o"),
                  tmp_path=str(tmp_path / "t"), **kw)
    ours = build_extractor(ExtractionConfig(**common), external_call=True)
    assert type(ours).__name__ == port_cls and ours.mesh_capable
    with pytest.raises(ValueError) as mine:
        scheduler.mesh_feature_extraction(ours, _cpus(2))
    ref = jax_cls(JaxConfig(**common), external_call=True)
    with pytest.raises(ValueError) as theirs:
        jax_scheduler.mesh_feature_extraction(ref, jax.devices()[:2])
    assert str(mine.value) == str(theirs.value)


def test_device_preprocess_on_a_resnet_mesh_is_refused_as_in_jax():
    kw = dict(feature_type="resnet50", sharding="mesh", preprocess="device")
    with pytest.raises(ValueError) as ours:
        sanity_check(ExtractionConfig(**kw))
    with pytest.raises(ValueError) as ref:
        jax_sanity_check(JaxConfig(**kw))
    assert str(ours.value) == str(ref.value)
    for ft in ("raft", "pwc", "i3d"):  # admitted for the sequence-parallel families
        sanity_check(ExtractionConfig(feature_type=ft, sharding="mesh", preprocess="device"))
