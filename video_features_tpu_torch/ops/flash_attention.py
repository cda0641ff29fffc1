"""Flash attention: the Hopper kernel ``csrc/flash_attention.cu`` and its
plain PyTorch version.

Counterpart of ``video_features_tpu/ops/pallas/flash_attention.py``, with
the same (N, H, L, d) contract. A CPU tensor goes to
``flash_attention_reference``; a CUDA tensor launches the kernel or raises.
``flash_attention.launches`` counts kernel launches, so a run can show
that its attention went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from video_features_tpu_torch.ops import kernels
from video_features_tpu_torch.ops.attention import blockwise_attention
from video_features_tpu_torch.telemetry.ledger import kernel_flops

# the kernel's tiles (csrc/flash_attention.cu kBlockQ / kBlockK): 4 warps
# of 16 query rows, 64-row KV tiles
BLOCK_Q = 64
BLOCK_K = 64
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_k: int = BLOCK_K,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """The kernel's arithmetic in plain torch: the online softmax over
    ``block_k``-row KV tiles, fp32 state, p rounded to v's dtype."""
    return blockwise_attention(q, k, v, block_size=block_k, kv_len=kv_len)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned: the kernel stages rows with 16-byte
    copies."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.lru_cache(maxsize=None)
def _forward_fn():
    """The kernel's C entry point, built and bound on first use."""
    fn = kernels.load("flash_attention").vft_flash_attention_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# graftcheck: cuda-kernel
def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_q: int = BLOCK_Q,
    block_k: int = BLOCK_K,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """(N, H, Lq, d) q and (N, H, Lk, d) k/v -> (N, H, Lq, d) in q's dtype.

    ``kv_len`` masks KV positions ``>= kv_len``. On the CPU the blocks are
    the plain version's tiles; on the card they must be the kernel's
    (``BLOCK_Q``, ``BLOCK_K``). Inside a cost-ledger capture the call
    counts ``attention_flops`` whichever version runs
    (``telemetry/ledger.py::kernel_flops``)."""
    flops = attention_flops(q, k, kv_len) if q.dim() == k.dim() == 4 else 0
    with kernel_flops(flops):
        if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
            return flash_attention_reference(q, k, v, block_k=block_k, kv_len=kv_len)
        return _launch(q, k, v, block_q, block_k, kv_len)


def attention_flops(q: torch.Tensor, k: torch.Tensor, kv_len: Optional[int] = None) -> int:
    """The kernel's operations, as the cost ledger counts them: the
    ``q k^T`` and ``p v`` products, 2 * 2 * Lq * kv_len * d per (n, h)."""
    n, h, lq, d = q.shape
    return 4 * n * h * lq * (k.shape[2] if kv_len is None else int(kv_len)) * d


def _launch(q, k, v, block_q: int, block_k: int, kv_len: Optional[int]) -> torch.Tensor:
    """Check the arguments and launch the kernel on q's device."""
    if not (q.device == k.device == v.device and q.device.type == "cuda"):
        raise ValueError(
            f"flash_attention needs q, k, v on one CUDA device, got "
            f"{q.device}, {k.device}, {v.device}"
        )
    if not (q.dtype == k.dtype == v.dtype and q.dtype in _DTYPES):
        raise ValueError(
            f"flash_attention takes float32 or bfloat16 q/k/v of one dtype, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention takes (N, H, L, d) tensors, got q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    N, H, Lq, d = q.shape
    Lk = k.shape[2]
    if k.shape[:2] != (N, H) or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims {HEAD_DIMS}, got {d}")
    if (block_q, block_k) != (BLOCK_Q, BLOCK_K):
        raise ValueError(
            f"the CUDA kernel's tiles are ({BLOCK_Q}, {BLOCK_K}), got ({block_q}, {block_k})"
        )
    limit = Lk if kv_len is None else int(kv_len)
    if not 1 <= limit <= Lk:
        raise ValueError(f"kv_len must be in [1, {Lk}], got {kv_len}")
    if N * H * -(-Lq // BLOCK_Q) > _INT_MAX or max(Lq, Lk) * d > _INT_MAX:
        raise ValueError(f"flash_attention shapes too large: q {tuple(q.shape)}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    fn = _forward_fn()
    with kernels.on_device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            N * H, Lq, Lk, limit, d, _DTYPES[q.dtype], d ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    kernels.count_launch(flash_attention)
    return out


flash_attention.launches = 0
