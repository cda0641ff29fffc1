"""The port's attention cores against the JAX package's.

The port's ``flash_attention`` on a CPU tensor runs its plain version;
both are held to the JAX Pallas kernel in interpret mode and the JAX
fused core, on the cases of tests/test_pallas_flash_attention.py.
Tolerances: fp32 1e-5 (the same sums in other orders); bf16 3e-2 against
the fp32 reference (bf16 rounding of inputs, p and the output).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_features_tpu.ops import attention as jax_attn
from video_features_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from video_features_tpu_torch.ops.attention import (
    attention,
    blockwise_attention,
    online_softmax_step,
)
from video_features_tpu_torch.ops.flash_attention import (
    BLOCK_K,
    BLOCK_Q,
    flash_attention,
    flash_attention_reference,
)

FP32_ATOL = 1e-5
BF16_ATOL = 3e-2


def _qkv(seed, n=2, h=3, lq=64, lk=64, d=32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, h, lq, d)).astype(np.float32)
    k = rng.standard_normal((n, h, lk, d)).astype(np.float32)
    v = rng.standard_normal((n, h, lk, d)).astype(np.float32)
    return q, k, v


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("bq,bk", [(16, 16), (32, 64), (64, 16)])
def test_cores_match_jax_flash(bq, bk):
    q, k, v = _qkv(0, lq=96, lk=128)
    ref = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), block_q=bq, block_k=bk,
                               interpret=True))
    tq, tk, tv = _t(q, k, v)
    for out in (
        flash_attention(tq, tk, tv, block_q=bq, block_k=bk),
        blockwise_attention(tq, tk, tv, block_size=bk),
        attention(tq, tk, tv),
    ):
        np.testing.assert_allclose(out.numpy(), ref, atol=FP32_ATOL)


def test_ragged_kv_len_matches_jax():
    """L not a multiple of the tiles, and kv_len masks the tail."""
    q, k, v = _qkv(1, lq=50, lk=50)
    ref_flash = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), block_q=16, block_k=16,
                                     kv_len=37, interpret=True))
    ref_fused = np.asarray(jax_attn.attention(*map(jnp.asarray, (q, k[:, :, :37], v[:, :, :37]))))
    tq, tk, tv = _t(q, k, v)
    for out in (
        flash_attention(tq, tk, tv, block_q=16, block_k=16, kv_len=37),
        flash_attention(tq, tk, tv, kv_len=37),
        blockwise_attention(tq, tk, tv, block_size=16, kv_len=37),
        attention(tq, tk, tv, kv_len=37),
    ):
        assert out.shape == tq.shape
        np.testing.assert_allclose(out.numpy(), ref_flash, atol=FP32_ATOL)
        np.testing.assert_allclose(out.numpy(), ref_fused, atol=FP32_ATOL)


def test_bf16_accumulates_in_fp32():
    q, k, v = _qkv(2)
    ref = np.asarray(jax_attn.attention(*map(jnp.asarray, (q, k, v))))
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    ref_flash = np.asarray(jax_flash(jq, jk, jv, block_q=32, block_k=32, interpret=True),
                           dtype=np.float32)
    tq, tk, tv = _t(q, k, v, dtype=torch.bfloat16)
    out = flash_attention(tq, tk, tv, block_q=32, block_k=32)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=BF16_ATOL)
    np.testing.assert_allclose(out.float().numpy(), ref_flash, atol=BF16_ATOL)
    fused = attention(tq, tk, tv)
    assert fused.dtype == torch.bfloat16
    np.testing.assert_allclose(fused.float().numpy(), ref, atol=BF16_ATOL)


def test_single_block():
    """The whole sequence in one tile."""
    q, k, v = _qkv(3, lq=16, lk=16)
    ref = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), interpret=True))
    out = flash_attention(*_t(q, k, v))
    np.testing.assert_allclose(out.numpy(), ref, atol=FP32_ATOL)


@pytest.mark.parametrize("length", [50, 65], ids=["L50", "L65"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_plain_at_kernel_tiles_matches_jax(length, dtype):
    """The plain version at the kernel's 64-row KV tiles: one tile at L=50,
    a full tile and a 1-row tile at L=65 (the KV tile edge)."""
    assert (BLOCK_Q, BLOCK_K) == (64, 64)
    q, k, v = _qkv(8, n=1, h=2, lq=length, lk=length, d=32)
    fused = np.asarray(jax_attn.attention(*map(jnp.asarray, (q, k, v))))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    pallas = np.asarray(jax_flash(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                                  block_q=BLOCK_Q, block_k=BLOCK_K, interpret=True),
                        dtype=np.float32)
    out = flash_attention(*_t(q, k, v, dtype=dtype))
    assert out.dtype == dtype and out.shape == (1, 2, length, 32)
    atol = FP32_ATOL if dtype == torch.float32 else BF16_ATOL
    np.testing.assert_allclose(out.float().numpy(), pallas, atol=atol)
    np.testing.assert_allclose(out.float().numpy(), fused, atol=atol)


def test_online_softmax_step_matches_jax():
    q, k, v = _qkv(4, lq=8, lk=12, d=16)
    rng = np.random.default_rng(5)
    m = rng.standard_normal((2, 3, 8)).astype(np.float32)
    l = rng.uniform(0.5, 2.0, (2, 3, 8)).astype(np.float32)
    acc = rng.standard_normal((2, 3, 8, 16)).astype(np.float32)
    mask = np.arange(12) < 9
    ref = jax_attn.online_softmax_step(
        *map(jnp.asarray, (q, k, v, m, l, acc)), 0.25, kv_mask=jnp.asarray(mask)
    )
    out = online_softmax_step(*_t(q, k, v, m, l, acc), 0.25, kv_mask=torch.from_numpy(mask))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FP32_ATOL, rtol=1e-6)


def test_rejects_bad_kv_len_and_non_cpu_tensors():
    tq, tk, tv = _t(*_qkv(6, lq=8, lk=8))
    for kv_len in (0, 9):
        with pytest.raises(ValueError, match="kv_len"):
            flash_attention(tq, tk, tv, kv_len=kv_len)
    # a tensor off the CPU launches the kernel or raises: never the plain path
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(*(t.to("meta") for t in (tq, tk, tv)))


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,dtype,kv_len,atol",
    [
        ((16, 12, 50, 64), torch.float32, None, 1e-5),
        ((16, 12, 197, 64), torch.float32, None, 1e-5),
        ((16, 12, 50, 64), torch.float32, 37, 1e-5),
        ((16, 12, 50, 64), torch.bfloat16, None, 1e-2),
        ((4, 12, 64, 64), torch.float32, None, 1e-5),  # exactly one KV tile
        ((4, 12, 65, 64), torch.float32, None, 1e-5),  # two tiles, the second 1 row
        ((4, 12, 65, 64), torch.bfloat16, 65, 1e-2),
        ((4, 12, 130, 64), torch.float32, 70, 1e-5),  # tiles past kv_len skipped
        ((4, 12, 50, 32), torch.float32, None, 1e-5),
        ((4, 12, 197, 32), torch.bfloat16, None, 1e-2),
        ((4, 12, 50, 128), torch.float32, None, 1e-5),
        ((4, 12, 197, 128), torch.float32, None, 1e-5),  # two stages, 169 KB shared
        ((4, 12, 197, 128), torch.bfloat16, None, 1e-2),
    ],
)
def test_kernel_matches_plain_on_card(cuda_device, shape, dtype, kv_len, atol):
    rng = np.random.default_rng(7)
    q, k, v = (
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(cuda_device, dtype)
        for _ in range(3)
    )
    before = flash_attention.launches
    out = flash_attention(q, k, v, kv_len=kv_len)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attention_reference(q, k, v, kv_len=kv_len)
    assert (out.float() - ref.float()).abs().max().item() <= atol


@pytest.mark.cuda
def test_kernel_shapes_in_turns_on_card(cuda_device):
    """Two KV stages (L=197) take more shared memory than one (L=50): the
    larger, the smaller and the larger again all run."""
    rng = np.random.default_rng(9)
    for shape in [(2, 12, 197, 64), (2, 12, 50, 64), (2, 12, 197, 64)]:
        q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(cuda_device)
                   for _ in range(3))
        out = flash_attention(q, k, v)
        torch.cuda.synchronize()
        assert (out - flash_attention_reference(q, k, v)).abs().max().item() <= FP32_ATOL
