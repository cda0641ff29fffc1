"""The port's ring attention and its online-softmax pieces against the
JAX package's.

The JAX side runs ``ring_attention_sharded`` under ``shard_map`` on the
virtual CPU devices of ``conftest.py``; the port's ring runs over lists
of shards on ``[cpu] * k`` with its explicit one-hop permute. One set of
(N, H, L, d) inputs from a seed goes through both: L = 50 (CLIP's
tokens) padded to 52 with ``kv_len``, with and without ``block_size``,
with and without a head axis; fp32 within 1e-5, bf16 within 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_features_tpu.ops import attention as jax_attention
from video_features_tpu.parallel import ring_attention as jax_ring
from video_features_tpu.parallel import sharding as jax_sharding
from video_features_tpu_torch.ops import attention
from video_features_tpu_torch.parallel import ring_attention as ring
from video_features_tpu_torch.parallel import sharding

from torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
ATOL = {"float32": 1e-5, "bfloat16": 1e-2}
SHAPE = (2, 4, 50, 16)


def _qkv(shape=SHAPE, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


def _port(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _jax(arrays, dtype):
    return [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]


def _meshes(data, model):
    return (sharding.make_mesh([CPU] * (data * model), model=model),
            jax_sharding.make_mesh(jax.devices()[:data * model], model=model))


def _pad(arrays, to):
    return [np.pad(a, ((0, 0), (0, 0), (0, to - a.shape[2]), (0, 0))) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_size", [None, 8], ids=["one-step", "block8"])
@pytest.mark.parametrize("data,model,head_axis", [(4, 1, None), (2, 2, "model")],
                         ids=["ring4", "ring2xheads2"])
def test_ring_matches_jax_with_padding(dtype, block_size, data, model, head_axis):
    padded = _pad(_qkv(), 52)  # 50 tokens to a multiple of 4
    ours_mesh, jax_mesh = _meshes(data, model)
    ours = ring.ring_attention_sharded(*_port(padded, dtype), ours_mesh, kv_len=50,
                                       head_axis=head_axis, block_size=block_size)
    ref = jax_ring.ring_attention_sharded(*_jax(padded, dtype), jax_mesh, kv_len=50,
                                          head_axis=head_axis, block_size=block_size)
    assert ours.dtype == getattr(torch, dtype) and ours.shape == (2, 4, 52, 16)
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(ours.float().numpy()[:, :, :50], ref[:, :, :50], atol=ATOL[dtype])
    # and against full attention over the 50 valid tokens
    full = attention.attention(*_port(_qkv(), dtype))
    np.testing.assert_allclose(ours.float().numpy()[:, :, :50], full.float().numpy(),
                               atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_context_parallel_core_matches_fused_and_jax(dtype):
    arrays = _qkv(seed=1)
    ours_mesh, jax_mesh = _meshes(4, 2)
    ours = ring.make_context_parallel_core(ours_mesh)(*_port(arrays, dtype))
    ref = jax_ring.make_context_parallel_core(jax_mesh)(*_jax(arrays, dtype))
    fused = attention.attention(*_port(arrays, dtype))
    assert ours.shape == fused.shape == SHAPE
    np.testing.assert_allclose(ours.float().numpy(), fused.float().numpy(), atol=ATOL[dtype])
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=ATOL[dtype])


def test_context_parallel_attention_replicates_the_output():
    q, k, v = _port(_qkv(seed=2), "float32")
    outs = ring.context_parallel_attention([q] * 3, [k] * 3, [v] * 3, block_size=4)
    full = attention.attention(q, k, v)
    assert len(outs) == 3
    for o in outs:
        np.testing.assert_allclose(o.numpy(), full.numpy(), atol=1e-5)


@pytest.mark.parametrize("args,kw", [
    (((2, 4, 50, 16),), dict()),
    (((2, 3, 52, 16),), dict(head_axis="model")),
], ids=["tokens", "heads"])
def test_ring_divisibility_errors_match_jax(args, kw):
    arrays = [np.zeros(args[0], np.float32)] * 3
    ours_mesh, jax_mesh = _meshes(2, 2)
    if "head_axis" not in kw:
        ours_mesh, jax_mesh = _meshes(4, 1)
    with pytest.raises(ValueError) as ours:
        ring.ring_attention_sharded(*_port(arrays, "float32"), ours_mesh, **kw)
    with pytest.raises(ValueError) as ref:
        jax_ring.ring_attention_sharded(*_jax(arrays, "float32"), jax_mesh, **kw)
    assert str(ours.value) == str(ref.value)


def test_ring_permute_moves_each_part_one_device_on():
    parts = [torch.full((1,), float(i)) for i in range(4)]
    moved = sharding.ring_permute(parts, [CPU] * 4)
    assert [float(p) for p in moved] == [3.0, 0.0, 1.0, 2.0]
    assert [float(s) for s in sharding.all_reduce_sum(parts)] == [6.0] * 4
    assert [list(g.numpy()) for g in sharding.all_gather(parts, 0)] == [[0.0, 1.0, 2.0, 3.0]] * 4


@pytest.mark.parametrize("limit", [None, 37, 20], ids=["none", "inside-second", "first-only"])
def test_accumulate_blockwise_over_spans_matches_jax(limit):
    """Two spans folded into one carry, the second at a global offset,
    equal the JAX package's carry; the finalized output equals
    ``blockwise_attention`` over the whole (whose outputs are unchanged
    by the refactor: the same steps in the same order)."""
    q, k, v = _qkv(shape=(1, 2, 24, 8), seed=3)
    q = q[:, :, :12]
    k, v = [np.concatenate([a, a[:, :, ::-1] * 0.5], axis=2) for a in (k, v)]  # 24 + 24 keys
    qt, kt, vt = _port([q, k, v], "float32")
    qj, kj, vj = _jax([q, k, v], "float32")
    scale = 8 ** -0.5
    carry = attention.init_carry(qt)
    jcarry = jax_attention.init_carry(qj)
    for lo, hi in ((0, 24), (24, 48)):
        carry = attention.accumulate_blockwise(qt, kt[:, :, lo:hi], vt[:, :, lo:hi], carry,
                                               scale, 5, offset=lo, limit=limit)
        jcarry = jax_attention.accumulate_blockwise(qj, kj[:, :, lo:hi], vj[:, :, lo:hi], jcarry,
                                                    scale, 5, offset=lo, limit=limit)
    out = attention._finalize(*carry, qt.dtype)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jax_attention._finalize(*jcarry, jnp.float32)),
                               atol=1e-5)
    whole = attention.blockwise_attention(qt, kt, vt, block_size=5, kv_len=limit)
    np.testing.assert_allclose(out.numpy(), whole.numpy(), atol=1e-6)
