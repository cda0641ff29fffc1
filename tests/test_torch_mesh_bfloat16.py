"""``--dtype bfloat16`` under ``--sharding mesh``: the port's bf16 meshes
against the JAX package's bf16 meshes, the port's one-device bf16 run and
its fp32 run, on the CPU at tiny widths.

- CLIP: ``tests/test_torch_parallel.py``'s tiny tower (patch 16, width
  64, 2 layers, 2 heads, 32 px) with ``_openai_tiny``'s nonzero biases
  and LayerNorm weights, cast as the extractor casts it
  (``cast_for_compute``, ``proj`` kept fp32), on CPU meshes at tp2,
  dp2 x tp2 and context 2 x tp2 (``ShardedVisionTransformer``), against
  the JAX package's ``build_sharded_apply`` of its bf16 tower over the
  same params cast by ``cast_floats_for_compute``, on the 8 virtual CPU
  devices of ``conftest.py``. The dtypes of the sharded block's steps
  are held to the JAX graph's: a bf16 residual stream, bf16 partial
  products summed in bf16 over ``model``, the row-parallel bias rounded
  to bf16 (Flax's ``Dense(dtype=bfloat16)`` rounds its fp32 bias at use;
  the port casts it beside its weight), fp32 LayerNorm statistics and an
  fp32 ``proj``.
- ResNet-18, R(2+1)D-18, PWC, RAFT and I3D-rgb: each extractor at
  ``--dtype bfloat16 --sharding mesh`` through the converter route of
  ``tests/test_torch_mesh_families.py`` (one ``.pth`` for the port, the
  JAX converter's tree for the JAX extractor, which casts it at build),
  against the JAX package's bf16 mesh of the same shape and against the
  port's one-device bf16 run.

Tolerances, relative L2 in float64 (``analysis/parity.py::rel_drift``),
each from ``config.PARITY_CEILINGS`` (the JAX package's committed
budget), none looser:

- a bf16 mesh against the JAX package's bf16 mesh, and against the
  port's fp32 run: the family's ``"model"`` ceiling (two bf16 graphs
  round at other points, so they differ by about what either differs
  from fp32);
- a data-parallel mesh against the port's one-device bf16 run: a tenth of
  that ceiling (``test_torch_i3d_sequence_parallel.py``'s precedent). A
  data row does the one-device arithmetic on fewer rows;
- CLIP's tensor- and context-parallel meshes against the one-device bf16
  run: the ``"model"`` ceiling. Their partial products are rounded to
  bf16 before they are summed over ``model``, a rounding the one-device
  tower does not have (the JAX package's GSPMD graph has it too).

Measured values are in each test's docstring (this sandbox's CPU).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_features_tpu.models.clip import convert as jax_clip_convert
from video_features_tpu.models.clip import model as jax_clip
from video_features_tpu.models.common.weights import cast_floats_for_compute
from video_features_tpu.parallel import sharding as jax_sharding
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
from video_features_tpu.parallel.ring_attention import make_context_parallel_core
from video_features_tpu.parallel.sharding import make_mesh as jax_make_mesh
from video_features_tpu_torch import config as port_config
from video_features_tpu_torch.analysis.parity import max_rel_drift, rel_drift
from video_features_tpu_torch.models.clip import model as port_clip
from video_features_tpu_torch.models.clip.convert import convert_state_dict as clip_state_dict
from video_features_tpu_torch.config import sanity_check
from video_features_tpu_torch.extract.registry import build_extractor
from video_features_tpu_torch.models.common.weights import cast_for_compute
from video_features_tpu_torch.models.i3d import model as port_i3d
from video_features_tpu_torch.models.pwc import model as pwc_model
from video_features_tpu_torch.models.pwc.model import PWCNet
from video_features_tpu_torch.models.pwc.model import init_weights as pwc_init
from video_features_tpu_torch.models.r21d import model as port_r21d
from video_features_tpu_torch.models.raft import model as port_raft
from video_features_tpu_torch.models.raft.model import RAFT
from video_features_tpu_torch.models.resnet import model as port_resnet
from video_features_tpu_torch.parallel import sharding

from test_torch_i3d import seeded_i3d
from test_torch_mesh_families import _cfg, _jax_ex, _mesh, _np_sd
from test_torch_multihost import _two_process_mesh, fake_group  # noqa: F401 - a fixture
from test_torch_parallel import TINY, _openai_tiny
from test_torch_r21d import seeded_r21d
from test_torch_raft import seeded_raft
from test_torch_resnet import seeded_resnet
from torch_threads import one_torch_thread  # noqa: F401 - an autouse fixture

BF16 = "bfloat16"
CPU = torch.device("cpu")
# data-parallel rows against the one-device bf16 run: a tenth of the
# family's "model" ceiling
DP_SHARE = 0.1
# RAFT's update iterations in both packages (test_torch_mesh_families.py's)
RAFT_ITERS = 3


def _cpus(n):
    return [CPU] * n


def _ceiling(family):
    return max_rel_drift(family, BF16, "model")


# --- CLIP: the sharded tower against the JAX package's bf16 GSPMD graph ----------

def _tower(sd, dtype):
    model = port_clip.VisionTransformer(port_clip.CLIPVisionConfig(**TINY))
    model.load_state_dict(clip_state_dict(sd, TINY["layers"]))
    with torch.no_grad():
        return cast_for_compute(model.eval(), dtype, exclude=port_clip.FP32_PARAMS)


@pytest.fixture(scope="module")
def tiny_bf16():
    """(state dict, bf16 tower, images, the one-device bf16 and fp32
    embeddings). The images are rounded to bf16 first: the extractor's
    host batch is a bf16 tensor, and both packages then see one input."""
    sd = _openai_tiny()
    b16 = _tower(sd, torch.bfloat16)
    x = np.random.RandomState(0).randn(8, 3, 32, 32).astype(np.float32)
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    with torch.inference_mode():
        one = b16(torch.from_numpy(x).to(torch.bfloat16)).numpy()
        f32 = _tower(sd, torch.float32)(torch.from_numpy(x)).numpy()
    return sd, b16, x, one, f32


def _jax_bf16_mesh(sd, x, data, model, context):
    from jax.sharding import PartitionSpec as P

    mesh = jax_sharding.make_mesh(jax.devices()[:data * model], model=model)
    core = make_context_parallel_core(mesh) if context else None
    net = jax_clip.VisionTransformer(jax_clip.CLIPVisionConfig(**TINY), dtype=jnp.bfloat16,
                                     attn_core=core)
    params = cast_floats_for_compute(jax_clip_convert.convert_state_dict(sd, TINY["layers"]),
                                     jnp.bfloat16, exclude=("proj",))
    spec = P() if context else P("data")
    fn = jax_sharding.build_sharded_apply(net, mesh, batch_spec=spec, out_spec=spec)
    return np.asarray(fn(jax_sharding.shard_params(params, mesh), jnp.asarray(x)), np.float32)


@pytest.mark.parametrize("data,model,context", [
    (1, 2, False), (2, 2, False), (2, 2, True), (2, 1, False),
], ids=["tp2", "dp2xtp2", "context2xtp2", "dp2"])
def test_clip_bf16_mesh_matches_the_jax_bf16_mesh(tiny_bf16, data, model, context):
    """Measured here: against the JAX bf16 mesh tp2 6.7e-3, dp2 x tp2
    6.7e-3, context 2 x tp2 6.9e-3, dp2 6.2e-3 (the two packages' bf16
    towers on one device differ by as much: dp2 is the one-device
    arithmetic); against the one-device bf16 run tp2 5.1e-3, dp2 x tp2
    5.1e-3, context 5.8e-3, dp2 0.0; against fp32 5.1e-3 to 5.9e-3
    (ceiling 0.03)."""
    sd, b16, x, one, f32 = tiny_bf16
    mesh = sharding.make_mesh(_cpus(data * model), model=model)
    sharded = port_clip.ShardedVisionTransformer(b16, mesh, context=context)
    with torch.inference_mode():
        out = sharded(sharded.place(torch.from_numpy(x).to(torch.bfloat16)))
    assert out.dtype == torch.float32 and out.shape == (8, TINY["embed_dim"])
    out = out.numpy()
    ceiling = _ceiling("clip")
    vs_jax = rel_drift(out, _jax_bf16_mesh(sd, x, data, model, context))
    vs_one, vs_f32 = rel_drift(out, one), rel_drift(out, f32)
    assert vs_jax <= ceiling
    assert 0 < vs_f32 <= ceiling
    assert vs_one <= (DP_SHARE * ceiling if model == 1 else ceiling)


def test_clip_bf16_mesh_steps_keep_the_jax_dtypes(tiny_bf16, monkeypatch):
    """The sharded bf16 block, step by step, in the dtypes of the JAX
    package's bf16 GSPMD graph: bf16 partial products reach the sum over
    ``model`` and stay bf16 through it, the row-parallel biases are bf16
    on every shard, the residual stream is bf16 after each ``_reduce``,
    the LayerNorms keep fp32 parameters and ``proj`` stays fp32."""
    _, b16, x, _, _ = tiny_bf16
    mesh = sharding.make_mesh(_cpus(4), model=2)
    sharded = port_clip.ShardedVisionTransformer(b16, mesh)
    summed, reduced = [], []
    real_sum, real_reduce = sharding.all_reduce_sum, sharded._reduce

    def spy_sum(parts):
        out = real_sum(parts)
        summed.append(({p.dtype for p in parts}, {s.dtype for s in out}))
        return out

    def spy_reduce(b, rows, grid, partials, bias):
        out = real_reduce(b, rows, grid, partials, bias)
        reduced.append({t.dtype for row in out for t in row})
        return out

    monkeypatch.setattr(sharding, "all_reduce_sum", spy_sum)
    monkeypatch.setattr(sharded, "_reduce", spy_reduce)
    with torch.inference_mode():
        out = sharded(sharded.place(torch.from_numpy(x).to(torch.bfloat16)))
    assert out.dtype == torch.float32
    # 2 layers x (attention, MLP) x 2 data rows
    assert summed == [({torch.bfloat16}, {torch.bfloat16})] * (2 * TINY["layers"] * 2)
    assert reduced == [{torch.bfloat16}] * (2 * TINY["layers"])
    for shard in sharded.shards:
        for block in shard:
            assert block["out_b"].dtype == block["proj_b"].dtype == torch.bfloat16
            assert block["in_w"].dtype == block["fc_w"].dtype == torch.bfloat16
    for rep in sharded.replicas:
        assert rep.proj.dtype == torch.float32 and rep.conv1.weight.dtype == torch.bfloat16
        assert all(p.dtype == torch.float32 for n in rep.norms for p in n.parameters())


# --- the other families: the extractor's bf16 mesh against the JAX package's -------

def _family_case(ft, tmp_path, sample_video):
    """(port weights path, the JAX extractor class, its host params, the
    extractor flags, mesh rows, output keys) of one family: seeded weights
    saved in the reference layout for the port and converted by the JAX
    package's converter for the JAX extractor."""
    if ft == "resnet18":
        model = seeded_resnet("resnet18", seed=3)
        path = tmp_path / "resnet18.pth"
        torch.save(model.state_dict(), path)
        return (path, JaxExtractResNet,
                jax_resnet_convert.convert_state_dict(_np_sd(model), "resnet18"),
                dict(extraction_fps=2.5, batch_size=6), 2, ["resnet18"])
    if ft == "r21d_rgb":
        model = seeded_r21d(seed=1)
        path = tmp_path / "r2plus1d_18.pth"
        torch.save(model.state_dict(), path)
        return (path, JaxExtractR21D, jax_r21d_convert.convert_state_dict(_np_sd(model)),
                dict(extraction_fps=5.0, stack_size=4, step_size=4, batch_size=2), 2,
                ["r21d_rgb"])
    if ft == "pwc":
        sd = _np_sd(pwc_init(PWCNet(), seed=4))
        path = tmp_path / "pwc_net_sintel.pt"
        torch.save({f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}, path)
        return (path, JaxExtractPWC, jax_pwc_convert.convert_state_dict(sd),
                dict(extraction_fps=2.5, side_size=64, batch_size=5), 2, ["pwc"])
    if ft == "raft":
        model = seeded_raft(iters=RAFT_ITERS)
        path = tmp_path / "raft-sintel.pth"
        torch.save({f"module.{k}": v for k, v in model.state_dict().items()}, path)
        return (path, JaxExtractRAFT, jax_raft_convert.convert_state_dict(_np_sd(model)),
                dict(extraction_fps=2.5, side_size=128, batch_size=8), 2, ["raft"])
    model = seeded_i3d(3, seed=6)
    path = tmp_path / "weights"
    path.mkdir()
    torch.save(model.state_dict(), path / "i3d_rgb.pt")
    return (path, JaxExtractI3D, {"rgb": jax_i3d_convert.convert_state_dict(_np_sd(model))},
            dict(flow_type="pwc", streams=["rgb"], stack_size=10, step_size=10,
                 extraction_fps=5.0), 2, ["rgb"])


@pytest.fixture
def short_raft(monkeypatch):
    """Both packages' RAFT at ``RAFT_ITERS`` update iterations (the
    extractors' builds patched), as ``test_torch_mesh_families.py`` runs it."""
    monkeypatch.setattr(RAFT.__init__, "__defaults__", (RAFT_ITERS,))
    monkeypatch.setattr(jax_raft_extract, "build",
                        functools.partial(jax_raft_model.build, RAFT_ITERS))


@pytest.fixture
def replica_dtypes(monkeypatch):
    """Each ``Replicas`` built while it is open: a {name: dtype} map of
    every copy's parameters and buffers."""
    seen = []
    real = sharding.Replicas.__init__

    def spy(self, mesh, copies):
        real(self, mesh, copies)
        seen.extend({n: t.dtype for n, t in [*m.named_parameters(), *m.named_buffers()]}
                    for m in copies.values())

    monkeypatch.setattr(sharding.Replicas, "__init__", spy)
    return seen


@pytest.fixture
def k2_inputs(monkeypatch):
    """Each cost volume PWC computes, as (pairs, dtype of f1, of f2)."""
    calls = []
    real = pwc_model.local_correlation

    def spy(f1, f2, *a, **kw):
        calls.append((f1.shape[0], f1.dtype, f2.dtype))
        return real(f1, f2, *a, **kw)

    monkeypatch.setattr(pwc_model, "local_correlation", spy)
    return calls


# the port modules whose FP32_PARAMS a family's bf16 copies keep fp32
FP32 = {"resnet18": port_resnet.FP32_PARAMS, "r21d_rgb": port_r21d.FP32_PARAMS,
        "pwc": pwc_model.FP32_PARAMS, "raft": port_raft.FP32_PARAMS,
        "i3d": port_i3d.FP32_PARAMS}


@pytest.mark.parametrize("ft", ["resnet18", "r21d_rgb", "pwc", "raft", "i3d"])
def test_family_bf16_mesh_matches_the_jax_bf16_mesh(ft, sample_video, tmp_path, short_raft,
                                                    replica_dtypes, k2_inputs):
    """Against the JAX bf16 mesh and the port's one-device bf16 run,
    measured here: ResNet-18 1.8e-3 and 0.0, R(2+1)D-18 1.3e-3 and 0.0,
    PWC 3.1e-3 and 0.0, RAFT 1.5e-3 and 0.0, I3D-rgb 9.0e-4 and 0.0
    (ceilings 0.03, 0.03, 0.02, 0.02, 0.03; a tenth of them against the
    one-device run). Each row's copy keeps the built model's dtypes: its
    parameters and buffers are those ``cast_for_compute`` gives the fp32
    copy (bf16 weights, fp32 norms and ``FP32_PARAMS``). PWC's cost
    volume gets fp32 inputs on each row, at the row's pair count."""
    weights, jax_cls, params, kw, data, keys = _family_case(ft, tmp_path, sample_video)
    ceiling = _ceiling(port_config.model_family(ft))

    def port(rows):
        cfg = _cfg(ft, sample_video, tmp_path, dtype=BF16, weights_path=str(weights), **kw)
        if rows:
            cfg.sharding = "mesh"
        (out,) = build_extractor(sanity_check(cfg), external_call=True)(
            device=_mesh(rows) if rows else CPU)
        return out

    mesh = port(data)
    assert replica_dtypes
    for dtypes in replica_dtypes:
        bf16 = {n for n, d in dtypes.items() if d == torch.bfloat16}
        assert bf16 and all(d in (torch.float32, torch.bfloat16) or n.endswith(
            "num_batches_tracked") for n, d in dtypes.items())
        for n in bf16:  # never a norm's parameter or statistic, never an excluded head
            assert not set(n.split(".")) & set(FP32[ft]), n
            assert "bn" not in n and "running" not in n and "norm" not in n, n
    if ft == "pwc":  # 5 pairs over 2 rows: 3 and 2, five levels each, fp32
        assert k2_inputs == ([(3, torch.float32, torch.float32)] * 5
                             + [(2, torch.float32, torch.float32)] * 5)
    one = port(0)
    ex = _jax_ex(jax_cls, ft, sample_video, tmp_path, params, dtype=BF16, **kw)
    (ref,) = ex([0], device=jax_make_mesh(jax.devices()[:data], model=1))
    for k in keys:
        got = mesh[k]
        assert got.dtype == np.float32 and got.shape == one[k].shape == ref[k].shape
        vs_jax, vs_one = rel_drift(got, ref[k]), rel_drift(got, one[k])
        assert vs_jax <= ceiling, (k, vs_jax)
        assert vs_one <= DP_SHARE * ceiling, (k, vs_one)


# --- across launched processes: bf16 gathers and halos ------------------------------

def test_bf16_rows_and_halos_cross_processes_in_their_dtype(fake_group):
    """Two threads as two processes (``test_torch_multihost.py``'s
    ``fake_group``). A multi-process mesh's collectives move bf16 tensors as their
    bytes: the rows ``gather_rows`` gathers (a bf16 feature map beside an
    fp32 one in a tuple, as a row's outputs may be) come back on every
    process bit for bit and in their dtypes, and ``temporal_halo``'s
    edges of bf16 time blocks equal the one-process halo."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(7, 3).astype(np.float32)).to(torch.bfloat16)
    blocks = [torch.from_numpy(rng.randn(1, 2, t, 3, 3).astype(np.float32)).to(torch.bfloat16)
              for t in (8, 8, 2)]
    want_halo = sharding.temporal_halo(blocks, 1, 1, ends=True)

    def rank_view(rank):
        mesh = _two_process_mesh(rank, [2, 2])
        parts, sizes = sharding.split_rows(x, mesh)
        rows = sharding.gather_rows([(p * 2, p.float() + 1) for p in parts], CPU, sizes, mesh)
        edges = _two_process_mesh(rank, [2, 1])
        mine = [b if edges.owners[i] == rank else torch.empty(b.shape, dtype=b.dtype,
                                                               device="meta")
                for i, b in enumerate(blocks)]
        return edges, rows, sharding.temporal_halo(mine, 1, 1, ends=True, mesh=edges)

    for rank, (edges, (doubled, widened), halo) in enumerate(fake_group.run(rank_view)):
        assert doubled.dtype == torch.bfloat16 and widened.dtype == torch.float32
        assert torch.equal(doubled, x * 2) and torch.equal(widened, x.float() + 1)
        for i, (g, w) in enumerate(zip(halo, want_halo)):
            assert g.dtype == torch.bfloat16 and g.shape == w.shape
            if edges.owners[i] == rank:
                assert torch.equal(g, w)
