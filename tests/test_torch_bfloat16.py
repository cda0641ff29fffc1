"""``--dtype bfloat16`` in the port against the JAX package's bf16 graphs.

Every family the JAX package admits (``LOW_PRECISION_MODEL_FAMILIES``)
runs its mixed-precision graph in the port: the same tensors in bf16, the
same pinned fp32, the same parameters left out of the cast, fp32
features. One set of seeded weights reaches both packages through the
existing converters; the JAX side runs as its own tests run it
(``cast_floats_for_compute`` plus the model's ``dtype=jnp.bfloat16``,
Pallas K1 in interpret mode under ``--attn flash``).

Drift is relative L2 in float64 (``analysis/parity.py::rel_drift``, the
port's copy). Tolerances, each read from ``config.PARITY_CEILINGS``
through the port's ``analysis/parity.py::max_rel_drift`` (the JAX
package's committed ``analysis/parity_budget.json``, held equal to it
below), none looser:

- each family's forward at small or full width (CLIP 2 layers x 64 wide
  with each of the three attention cores, ResNet-18 at 64x64, R(2+1)D-18
  at 8x32x32, I3D-rgb at 10x224x224, RAFT at 128x128, PWC at 64x96):
  port bf16 against JAX bf16, and port bf16 against port fp32, both
  within the family's "model" ceiling (measured 8e-4 to 5.3e-3 on a CPU:
  two bf16 graphs round at other points, e.g. torch adds a linear's bias
  before its one rounding where XLA rounds the product first, so they
  differ by about what either differs from fp32);
- RAFT in the JAX test's contracting regime (its flow head's last conv
  scaled by 0.05, ``tests/test_raft.py::test_mixed_precision_flow_drift``:
  full random init over 20 iterations is chaotic and its drift says
  nothing about rounding): also the flow within half a uint8 flow level
  (0.078 px) of the JAX package's and ``flow_to_uint8`` within one level;
- end to end through the CLI on the CPU (CLIP 2 layers x 64 wide with
  ``--attn flash``, ``raft``, ``pwc``, I3D + RAFT's flow stream; RAFT at
  2 iterations to keep the file short): fp32 features at the fp32 run's
  shapes, drift within the "e2e" / "e2e_flow" ceiling and above zero;
- ``--video_batch 3`` against solo, both bf16: ``atol=1e-3, rtol=1e-2``
  (the JAX package's ``test_clip_bf16_aggregated_matches_bf16_solo``);
  a fused group's solo fallback equals the solo bf16 run within 1e-6
  (the same solo arithmetic), far from the fp32 run;
- the device preprocess's bf16 output against the JAX package's
  ``device_preprocess_frames(..., out_dtype=jnp.bfloat16)``: one uint8
  level plus one bf16 rounding on at most 1e-3 of the values, as the
  fp32 case of ``test_torch_device_preprocess.py``.

Spies show K1 (the flash attention wrapper) getting bf16 q/k/v in CLIP's
bf16 graph and K2 (the cost volume) getting fp32 inputs in PWC's.
"""

import copy
import functools
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_features_tpu import config as jax_config
from video_features_tpu.analysis.parity import load_parity_budget
from video_features_tpu.config import ExtractionConfig as JaxConfig
from video_features_tpu.models.clip import convert as jax_clip_convert
from video_features_tpu.models.clip import model as jax_clip
from video_features_tpu.models.clip.extract_clip import ExtractCLIP as JaxExtractCLIP
from video_features_tpu.models.common.weights import cast_floats_for_compute
from video_features_tpu.models.i3d import convert as jax_i3d_convert
from video_features_tpu.models.i3d import model as jax_i3d
from video_features_tpu.models.pwc import convert as jax_pwc_convert
from video_features_tpu.models.pwc import model as jax_pwc
from video_features_tpu.models.r21d import convert as jax_r21d_convert
from video_features_tpu.models.r21d import model as jax_r21d
from video_features_tpu.models.raft import convert as jax_raft_convert
from video_features_tpu.models.raft import model as jax_raft
from video_features_tpu.models.resnet import convert as jax_resnet_convert
from video_features_tpu.models.resnet import model as jax_resnet
from video_features_tpu.ops import preprocess as jax_pre
from video_features_tpu.ops.attention import blockwise_attention as jax_blockwise
from video_features_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from video_features_tpu_torch import cli
from video_features_tpu_torch.analysis.parity import max_rel_drift, rel_drift
from video_features_tpu_torch import config as port_config
from video_features_tpu_torch.config import ExtractionConfig, sanity_check
from video_features_tpu_torch.extract.registry import build_extractor
from video_features_tpu_torch.models.clip import model as port_clip
from video_features_tpu_torch.models.clip.convert import convert_state_dict as clip_state_dict
from video_features_tpu_torch.models.clip.extract_clip import ExtractCLIP
from video_features_tpu_torch.models.common.weights import cast_for_compute
from video_features_tpu_torch.models.i3d import model as port_i3d
from video_features_tpu_torch.models.pwc import model as port_pwc
from video_features_tpu_torch.models.pwc.convert import convert_state_dict as pwc_state_dict
from video_features_tpu_torch.models.r21d import model as port_r21d
from video_features_tpu_torch.models.raft import model as port_raft
from video_features_tpu_torch.models.resnet import model as port_resnet
from video_features_tpu_torch.ops import correlation
from video_features_tpu_torch.ops import flash_attention as port_flash
from video_features_tpu_torch.ops import preprocess as port_pre
from video_features_tpu_torch.ops import resize as port_resize
from video_features_tpu_torch.ops.attention import attention, blockwise_attention
from video_features_tpu_torch.ops.window import spatial_bucket
from video_features_tpu_torch.utils.synth import synth_video

from test_torch_clip import SMALL, openai_state_dict
from test_torch_i3d import seeded_i3d
from test_torch_pwc import _seeded_state_dict as pwc_seeded_sd
from test_torch_r21d import seeded_r21d
from test_torch_raft import seeded_raft
from test_torch_resnet import seeded_resnet
from torch_threads import one_torch_thread  # noqa: F401 - an autouse fixture

BF16 = "bfloat16"
FT = "CLIP-ViT-B/32"
# RAFT's contracting regime: the JAX test's half uint8 flow level
# (40 px / 255 levels / 2) and its one-level quantizer budget
HALF_LEVEL_PX = 0.078
# --video_batch against solo, both bf16 (the JAX package's bound)
AGG_ATOL, AGG_RTOL = 1e-3, 1e-2
# a fused group's solo fallback against the solo run: the same arithmetic
FALLBACK_ATOL = 1e-6
# the device preprocess: one uint8 level, on at most this share of values
MAX_SHARE = 1e-3
CORES = {"fused": (attention, None),
         "flash": (port_flash.flash_attention, functools.partial(jax_flash, interpret=True)),
         "blockwise": (blockwise_attention, jax_blockwise)}


def _sd(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _np(x):
    return np.asarray(x, np.float32)


def _bf16(model, exclude):
    with torch.no_grad():
        return cast_for_compute(copy.deepcopy(model), torch.bfloat16, exclude=exclude)


@pytest.fixture
def small_tower(monkeypatch):
    monkeypatch.setitem(port_clip.CONFIGS, FT, port_clip.CLIPVisionConfig(**SMALL))


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("bf16_media")
    return [synth_video(str(d / f"v{i}.mp4"), n_frames=8 + 2 * i, width=64, height=48, seed=i)
            for i in range(3)]


# --- the flag, the admission table and the ceilings ------------------------

def test_ceilings_equal_the_committed_budget():
    budget = load_parity_budget()
    want = {(fam, dt, kind): spec["max_rel"]
            for fam, by_dtype in budget.items() if not fam.startswith("_")
            for dt, by_kind in by_dtype.items() for kind, spec in by_kind.items()}
    assert port_config.PARITY_CEILINGS == want
    assert port_config.LOW_PRECISION_MODEL_FAMILIES == jax_config.LOW_PRECISION_MODEL_FAMILIES
    for ft in port_config.FEATURE_TYPES:
        assert port_config.model_family(ft) == jax_config.model_family(ft)


@pytest.mark.parametrize("ft", ["vggish", "vggish_torch"])
def test_vggish_refuses_bfloat16(ft):
    with pytest.raises(ValueError, match="not admitted"):
        sanity_check(ExtractionConfig(feature_type=ft, dtype=BF16))
    with pytest.raises(ValueError, match="not admitted"):
        jax_config.sanity_check(JaxConfig(feature_type=ft, dtype=BF16))


def test_unknown_dtype_is_refused():
    with pytest.raises(ValueError, match="unknown dtype"):
        sanity_check(ExtractionConfig(feature_type=FT, extract_method="uni_2", dtype="float16"))
    with pytest.raises(SystemExit):
        cli.main(["--feature_type", FT, "--cpu", "--dtype", "float16", "--video_paths", "x.mp4"])


@pytest.mark.parametrize("ft", ["CLIP-ViT-B/16", "resnet50", "r21d_rgb", "i3d", "raft", "pwc"])
def test_admitted_families_pass(ft):
    assert sanity_check(ExtractionConfig(feature_type=ft, dtype=BF16)).dtype == BF16


# --- the cast: the same parameters as the JAX package's --------------------

def _clip_models():
    sd = openai_state_dict()
    model = port_clip.VisionTransformer(port_clip.CLIPVisionConfig(**SMALL))
    model.load_state_dict(clip_state_dict(sd, layers=SMALL["layers"]))
    return model.eval(), jax_clip_convert.convert_state_dict(sd, layers=SMALL["layers"])


def _cast_models(family):
    """(port model, its JAX param tree, the JAX exclude, the port exclude).
    RAFT and PWC: the JAX package casts at each conv instead of casting
    the tree, its ``upflow`` at fp32; the tree cast with that exclude is
    the same set of bf16 kernels."""
    if family == "clip":
        model, params = _clip_models()
        return model, params, ("proj",), port_clip.FP32_PARAMS
    if family == "resnet":
        m = seeded_resnet("resnet18", seed=1)
        return m, jax_resnet_convert.convert_state_dict(_sd(m), "resnet18"), ("fc",), \
            port_resnet.FP32_PARAMS
    if family == "r21d":
        m = seeded_r21d(seed=1)
        return m, jax_r21d_convert.convert_state_dict(_sd(m)), ("fc",), port_r21d.FP32_PARAMS
    if family == "i3d":
        m = seeded_i3d(3, seed=3)
        return m, jax_i3d_convert.convert_state_dict(_sd(m)), ("conv3d_0c_1x1",), \
            port_i3d.FP32_PARAMS
    if family == "raft":
        m = seeded_raft(iters=1)
        return m, jax_raft_convert.convert_state_dict(_sd(m)), (), port_raft.FP32_PARAMS
    m = port_pwc.PWCNet().eval()
    sd = pwc_seeded_sd()
    m.load_state_dict(pwc_state_dict(sd))
    return m, jax_pwc_convert.convert_state_dict(sd), ("upflow",), port_pwc.FP32_PARAMS


@pytest.mark.parametrize("family", ["clip", "resnet", "r21d", "i3d", "raft", "pwc"])
def test_cast_leaves_the_same_parameters_fp32(family):
    """The bf16 parameters hold as many elements as the JAX package's
    bf16 kernels (its biases are rounded at use, ours are cast beside
    their weight), and what stays fp32 is exactly the norms' 1-d
    parameters and the excluded heads."""
    model, params, jax_exclude, port_exclude = _cast_models(family)
    leaves = jax.tree_util.tree_leaves(cast_floats_for_compute(params, jnp.bfloat16,
                                                               exclude=jax_exclude))
    jax_bf16 = sum(x.size for x in leaves if x.dtype == jnp.bfloat16)
    cast = dict(_bf16(model, port_exclude).named_parameters())
    ours_bf16 = sum(p.numel() for p in cast.values() if p.dtype == torch.bfloat16 and p.dim() >= 2)
    assert ours_bf16 == jax_bf16 > 0
    for name, p in cast.items():
        parts = set(name.split("."))
        weight = cast.get(name[: -len("bias")] + "weight") if name.endswith("bias") else None
        want_bf16 = not parts & set(port_exclude) and (
            p.dim() >= 2 or (weight is not None and weight.dim() >= 2))
        assert (p.dtype == torch.bfloat16) == want_bf16, name
    assert all(b.dtype != torch.bfloat16 for b in cast_for_compute(model, torch.bfloat16).buffers())


# --- each family's graph: port bf16 against JAX bf16 and port fp32 ---------

def _run_clip(core):
    port_core, jax_core = CORES[core]
    model, params = _clip_models()
    for block in model.transformer.resblocks:
        block.attn.core = port_core
    x = np.random.RandomState(0).randn(3, 3, 224, 224).astype(np.float32)
    cfg = jax_clip.CLIPVisionConfig(**SMALL)
    ref = jax.jit(jax_clip.VisionTransformer(cfg, dtype=jnp.bfloat16, attn_core=jax_core).apply)(
        {"params": cast_floats_for_compute(params, jnp.bfloat16, exclude=("proj",))},
        jnp.asarray(x))
    with torch.inference_mode():
        f32 = model(torch.from_numpy(x))
        b16 = _bf16(model, port_clip.FP32_PARAMS)(torch.from_numpy(x))
    return "clip", f32, b16, ref


def _run_resnet():
    model = seeded_resnet("resnet18", seed=1)
    x = np.random.RandomState(2).randn(2, 3, 64, 64).astype(np.float32)
    params = jax_resnet_convert.convert_state_dict(_sd(model), "resnet18")
    ref, _ = jax.jit(jax_resnet.build("resnet18", dtype=jnp.bfloat16).apply)(
        {"params": cast_floats_for_compute(params, jnp.bfloat16, exclude=("fc",))},
        jnp.asarray(x))
    with torch.inference_mode():
        f32 = model(torch.from_numpy(x))[0]
        b16 = _bf16(model, port_resnet.FP32_PARAMS)(torch.from_numpy(x))[0]
    return "resnet", f32, b16, ref


def _run_r21d():
    model = seeded_r21d(seed=1)
    x = np.random.RandomState(2).randn(1, 8, 32, 32, 3).astype(np.float32)
    params = jax_r21d_convert.convert_state_dict(_sd(model))
    ref, _ = jax.jit(jax_r21d.build(dtype=jnp.bfloat16).apply)(
        {"params": cast_floats_for_compute(params, jnp.bfloat16, exclude=("fc",))},
        jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    with torch.inference_mode():
        f32 = model(xt)[0]
        b16 = _bf16(model, port_r21d.FP32_PARAMS)(xt)[0]
    return "r21d", f32, b16, ref


def _run_i3d():
    model = seeded_i3d(3, seed=3)
    x = np.random.RandomState(3).uniform(-1, 1, (1, 10, 224, 224, 3)).astype(np.float32)
    params = jax_i3d_convert.convert_state_dict(_sd(model))
    ref, _ = jax.jit(jax_i3d.build(dtype=jnp.bfloat16).apply)(
        {"params": cast_floats_for_compute(params, jnp.bfloat16, exclude=("conv3d_0c_1x1",))},
        jnp.asarray(x))
    with torch.inference_mode():
        f32 = model(torch.from_numpy(x))[0]
        b16 = _bf16(model, port_i3d.FP32_PARAMS)(torch.from_numpy(x))[0]
    return "i3d", f32, b16, ref


def _contracting_frames(size=128):
    """Two frames, the second the first moved by (3, 2) px: coherent
    motion, as in the JAX package's test."""
    base = np.random.RandomState(0).uniform(0, 255, size=(size + 8, size + 8)).astype(np.float32)
    f1, f2 = base[4 : 4 + size, 4 : 4 + size], base[1 : 1 + size, 2 : 2 + size]
    return np.stack([np.stack([f1] * 3, -1), np.stack([f2] * 3, -1)])


def _run_raft():
    model = seeded_raft(iters=20)
    with torch.no_grad():  # the contracting regime
        model.update_block.flow_head.conv2.weight.mul_(0.05)
        model.update_block.flow_head.conv2.bias.mul_(0.05)
    frames = _contracting_frames()
    # the JAX package keeps RAFT's parameters fp32 and casts at each conv
    ref = jax.jit(jax_raft.build(dtype=jnp.bfloat16).apply)(
        {"params": jax_raft_convert.convert_state_dict(_sd(model))}, jnp.asarray(frames))
    with torch.inference_mode():
        f32 = model(torch.from_numpy(frames))
        b16 = _bf16(model, port_raft.FP32_PARAMS)(torch.from_numpy(frames))
    return "raft", f32, b16, ref


def _run_pwc():
    sd = pwc_seeded_sd()
    model = port_pwc.PWCNet().eval()
    model.load_state_dict(pwc_state_dict(sd))
    frames = np.random.RandomState(2).uniform(0, 255, (3, 64, 96, 3)).astype(np.float32)
    ref = jax.jit(jax_pwc.build(dtype=jnp.bfloat16).apply)(
        {"params": jax_pwc_convert.convert_state_dict(sd)}, jnp.asarray(frames))
    with torch.inference_mode():
        f32 = model(torch.from_numpy(frames))
        b16 = _bf16(model, port_pwc.FP32_PARAMS)(torch.from_numpy(frames))
    return "pwc", f32, b16, ref


GRAPHS = {"clip-fused": functools.partial(_run_clip, "fused"),
          "clip-flash": functools.partial(_run_clip, "flash"),
          "clip-blockwise": functools.partial(_run_clip, "blockwise"),
          "resnet": _run_resnet, "r21d": _run_r21d, "i3d": _run_i3d, "raft": _run_raft,
          "pwc": _run_pwc}


@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_bf16_graph_matches_jax_within_the_model_ceiling(case):
    family, f32, b16, ref = GRAPHS[case]()
    ceiling = max_rel_drift(family, BF16, "model")
    assert f32.dtype == b16.dtype == torch.float32  # fp32 out either way
    f32, b16, ref = f32.numpy(), b16.numpy(), _np(ref)
    assert b16.shape == f32.shape == ref.shape
    vs_jax, vs_fp32 = rel_drift(b16, ref), rel_drift(b16, f32)
    assert vs_jax <= ceiling, (case, vs_jax, ceiling)
    assert 0 < vs_fp32 <= ceiling, (case, vs_fp32, ceiling)
    if family == "raft":
        assert np.abs(f32).max() < 20.0  # inside flow_to_uint8's clamp
        assert np.abs(b16 - ref).max() < HALF_LEVEL_PX
        ours = port_pre.flow_to_uint8(torch.from_numpy(b16)).numpy().astype(np.int16)
        theirs = np.asarray(jax_pre.flow_to_uint8(jnp.asarray(ref)), np.int16)
        assert np.abs(ours - theirs).max() <= 1


# --- which dtype reaches the kernels ---------------------------------------

def test_k1_gets_bf16_qkv_in_clip_bf16_graph(monkeypatch):
    seen = []
    real = port_flash.flash_attention_reference

    def spy(q, k, v, **kw):
        seen.append((q.dtype, k.dtype, v.dtype))
        return real(q, k, v, **kw)

    monkeypatch.setattr(port_flash, "flash_attention_reference", spy)
    model, _ = _clip_models()
    for block in model.transformer.resblocks:
        block.attn.core = port_flash.flash_attention
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 3, 224, 224).astype(np.float32))
    with torch.inference_mode():
        out = _bf16(model, port_clip.FP32_PARAMS)(x)
    assert out.dtype == torch.float32
    assert seen == [(torch.bfloat16,) * 3] * SMALL["layers"]


@pytest.mark.parametrize("method", ["auto", "plain"])
def test_k2_gets_fp32_in_pwc_bf16_graph(monkeypatch, method):
    seen = []
    real = correlation.local_correlation_reference

    def spy(f1, f2, max_displacement=4):
        seen.append((f1.dtype, f2.dtype))
        return real(f1, f2, max_displacement)

    monkeypatch.setattr(correlation, "local_correlation_reference", spy)
    model = _bf16(port_pwc.init_weights(port_pwc.PWCNet(corr_method=method), seed=1).eval(),
                  port_pwc.FP32_PARAMS)
    assert model.moduleTwo.moduleUpflow.weight.dtype == torch.float32
    assert model.moduleTwo.moduleOne[0].weight.dtype == torch.bfloat16
    frames = torch.from_numpy(np.random.RandomState(4).uniform(0, 255, (2, 64, 64, 3))
                              .astype(np.float32))
    with torch.inference_mode():
        flow = model(frames)
    assert flow.dtype == torch.float32 and flow.shape == (1, 64, 64, 2)
    assert seen == [(torch.float32, torch.float32)] * 5  # one cost volume a level


# --- end to end through the CLI ---------------------------------------------

E2E = {
    "clip": (FT, "e2e", ["--extract_method", "uni_4", "--attn", "flash"]),
    "raft": ("raft", "e2e", ["--extraction_fps", "5", "--side_size", "64", "--batch_size", "4"]),
    "pwc": ("pwc", "e2e", ["--extraction_fps", "5", "--side_size", "64", "--batch_size", "4"]),
    "i3d-raft": ("i3d", "e2e_flow", ["--flow_type", "raft", "--streams", "flow",
                                     "--extraction_fps", "5", "--stack_size", "10",
                                     "--step_size", "10"]),
}


@pytest.mark.parametrize("case", sorted(E2E))
def test_cli_bf16_end_to_end_within_the_e2e_ceiling(case, sample_video, tmp_path, monkeypatch,
                                                     small_tower):
    ft, kind, extra = E2E[case]
    monkeypatch.setattr(port_raft.RAFT.__init__, "__defaults__", (2,))  # 2 iterations

    def run(dtype):
        out = tmp_path / dtype
        cli.main(["--feature_type", ft, "--cpu", "--allow_random_init", "--dtype", dtype,
                  "--video_paths", sample_video, "--on_extraction", "save_numpy",
                  "--output_path", str(out), "--tmp_path", str(tmp_path / "tmp"), *extra])
        return {p.name: np.load(p) for p in sorted(out.rglob("*.npy"))}

    f32, b16 = run("float32"), run(BF16)
    assert sorted(b16) == sorted(f32) and f32
    family = port_config.model_family(ft)
    for name, feats in b16.items():
        assert feats.dtype == np.float32 and feats.shape == f32[name].shape
        drift = rel_drift(feats, f32[name])
        assert 0 < drift <= max_rel_drift(family, BF16, kind), (name, drift)


# --- the async loop: fused groups and their fallback ------------------------

def _clip_cfg(clips, out, **kw):
    return ExtractionConfig(feature_type=FT, video_paths=list(clips), extract_method="uni_3",
                            cpu=True, allow_random_init=True, output_path=str(out),
                            tmp_path=str(out) + "_tmp", **kw)


def test_clip_bf16_video_batch_matches_bf16_solo(clips, tmp_path, small_tower):
    solo = ExtractCLIP(_clip_cfg(clips, tmp_path / "s", dtype=BF16), external_call=True)()
    fused = ExtractCLIP(_clip_cfg(clips, tmp_path / "f", dtype=BF16, video_batch=3),
                        external_call=True)()
    f32 = ExtractCLIP(_clip_cfg(clips, tmp_path / "x"), external_call=True)()
    assert len(solo) == len(fused) == len(f32) == 3
    for s, f, x in zip(solo, fused, f32):
        assert f[FT].dtype == np.float32 and f[FT].shape == x[FT].shape
        np.testing.assert_allclose(f[FT], s[FT], atol=AGG_ATOL, rtol=AGG_RTOL)
        assert rel_drift(f[FT], x[FT]) > 0  # the fused group ran the bf16 graph


def test_clip_bf16_group_fallback_runs_bf16(clips, tmp_path, monkeypatch, small_tower):
    real, calls = ExtractCLIP.dispatch_group, []

    def flaky(self, *a):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected fused-dispatch failure")
        return real(self, *a)

    monkeypatch.setattr(ExtractCLIP, "dispatch_group", flaky)
    out = tmp_path / "fb"
    build_extractor(_clip_cfg(clips, out, dtype=BF16, video_batch=3,
                              on_extraction="save_numpy"))(device=torch.device("cpu"))
    monkeypatch.setattr(ExtractCLIP, "dispatch_group", real)
    solo = ExtractCLIP(_clip_cfg(clips, tmp_path / "s", dtype=BF16), external_call=True)()
    f32 = ExtractCLIP(_clip_cfg(clips, tmp_path / "x"), external_call=True)()
    saved = sorted(pathlib.Path(out).rglob("*.npy"))
    assert len(saved) == 3 and calls
    for path, s, x in zip(saved, solo, f32):  # both in input order, v0..v2
        got = np.load(path)
        np.testing.assert_allclose(got, s[FT], atol=FALLBACK_ATOL, rtol=0)
        assert np.abs(got - x[FT]).max() > 100 * FALLBACK_ATOL


def test_clip_host_batch_is_rounded_as_in_jax(sample_video, small_tower):
    ours = ExtractCLIP(ExtractionConfig(feature_type=FT, video_paths=[sample_video],
                                        extract_method="uni_4", cpu=True, dtype=BF16),
                       external_call=True).prepare(sample_video)[0]
    ref = JaxExtractCLIP(JaxConfig(feature_type=FT, video_paths=[sample_video],
                                   extract_method="uni_4", cpu=True, decoder="cv2", dtype=BF16),
                         external_call=True).prepare(sample_video)[0]
    assert isinstance(ours, torch.Tensor) and ours.dtype == torch.bfloat16
    np.testing.assert_array_equal(ours.float().numpy(), _np(ref))


# --- the device preprocess in bf16 ------------------------------------------

DEVICE = {"clip": (224, 224, "bicubic", port_pre.CLIP_MEAN, port_pre.CLIP_STD),
          "resnet": (256, 224, "bilinear", port_pre.IMAGENET_MEAN, port_pre.IMAGENET_STD)}


@pytest.mark.parametrize("family", sorted(DEVICE))
def test_device_preprocess_bf16_matches_jax(family):
    resize_to, crop, method, mean, std = DEVICE[family]
    h, w = 120, 180
    bh, bw = spatial_bucket(h, w, 64)
    wt_y, idx_y, wt_x, idx_x = port_resize.fused_resize_crop_banded(
        h, w, resize_to, crop, method, pad_h=bh, pad_w=bw)
    frames = np.random.RandomState(5).randint(0, 256, (3, bh, bw, 3)).astype(np.uint8)
    got = port_pre.device_preprocess_frames(
        torch.from_numpy(frames),
        (torch.from_numpy(np.array(wt_y)), torch.from_numpy(idx_y.astype(np.int64))),
        (torch.from_numpy(np.array(wt_x)), torch.from_numpy(idx_x.astype(np.int64))),
        mean, std, out_dtype=torch.bfloat16)
    want = jax_pre.device_preprocess_frames(jnp.asarray(frames), (wt_y, idx_y), (wt_x, idx_x),
                                            mean, std, out_dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert tuple(got.shape) == want.shape == (3, 3, crop, crop)
    got, want = got.float().numpy(), _np(want)
    diff = np.abs(got - want)
    level = 1.0 / 255.0 / min(std) + 2.0 ** -7 * np.abs(want).max()  # + one bf16 rounding
    assert diff.max() <= level, diff.max()
    assert (diff > 0).mean() <= MAX_SHARE, (diff > 0).mean()


@pytest.mark.parametrize("ft", [FT, "resnet18"])
def test_device_preprocess_extract_bf16(ft, clips, small_tower):
    def run(dtype):
        cfg = ExtractionConfig(feature_type=ft, video_paths=[clips[0]], cpu=True,
                               allow_random_init=True, preprocess="device", dtype=dtype,
                               batch_size=4, extract_method="uni_3" if ft == FT else None)
        (out,) = build_extractor(cfg, external_call=True)()
        return out[ft]

    f32, b16 = run("float32"), run(BF16)
    family = port_config.model_family(ft)
    kind = "e2e" if family == "clip" else "model"  # ResNet has no e2e ceiling
    assert b16.dtype == np.float32 and b16.shape == f32.shape
    assert 0 < rel_drift(b16, f32) <= max_rel_drift(family, BF16, kind)
