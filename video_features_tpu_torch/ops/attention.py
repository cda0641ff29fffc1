"""Attention cores in plain PyTorch: fused and blockwise (online softmax).

Counterpart of ``video_features_tpu/ops/attention.py``. Both cores take
(N, H, L, d) tensors and return (N, H, L_q, d) in q's dtype. Scores and
the p·v product accumulate in fp32 for every input dtype, as the TPU
kernel does with ``preferred_element_type=float32``; the softmax weights
are rounded to v's dtype before p·v. ``kv_len`` masks KV positions
``>= kv_len`` (right padding) at -1e30 and must be >= 1.

- ``attention``: the full score matrix, one fp32 softmax, two matmuls —
  the right core at ViT's 50/197 tokens.
- ``blockwise_attention``: FlashAttention's recurrence over KV blocks
  with a running (max, sum, acc) carry; O(L_q * block) live scores. It is
  also the plain version of the flash kernel
  (``ops/flash_attention.py::flash_attention_reference``). Its pieces,
  ``init_carry``, ``accumulate_blockwise`` and ``_finalize``, are what
  ring attention replays across devices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# Scores at masked KV positions (not -inf: an all-masked block would give
# exp(-inf - (-inf)) = nan in the online update).
_MASK_VALUE = -1e30


def _check_kv_len(kv_len: Optional[int], lk: int) -> None:
    if kv_len is not None and not 1 <= int(kv_len) <= lk:
        raise ValueError(f"kv_len must be in [1, {lk}], got {kv_len}")


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """(N,H,Lq,d) x (N,H,Lk,d) -> fp32 (N,H,Lq,Lk) scaled scores."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale


def _pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """fp32 p·v with p rounded to v's dtype first."""
    return torch.matmul(p.to(v.dtype).float(), v.float())


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Fused core: full score matrix, fp32 softmax, output in q.dtype."""
    _check_kv_len(kv_len, k.shape[2])
    s = _scores(q, k, q.shape[-1] ** -0.5)
    if kv_len is not None:
        s[..., kv_len:] = _MASK_VALUE
    p = torch.softmax(s, dim=-1)
    return _pv(p, v).to(q.dtype)


def online_softmax_step(
    q: torch.Tensor,
    k_blk: torch.Tensor,
    v_blk: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    acc: torch.Tensor,
    scale: float,
    kv_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One numerically stable softmax accumulation step over a KV block.

    Carries (all fp32): ``m`` (N,H,Lq) running max, ``l`` (N,H,Lq) running
    sum of exp, ``acc`` (N,H,Lq,d) running weighted-value sum. ``kv_mask``
    is (Lk_blk,) True at valid KV positions."""
    s = _scores(q, k_blk, scale)
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask, _MASK_VALUE)
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + _pv(p, v_blk)
    return m_new, l_new, acc_new


def init_carry(q: torch.Tensor):
    """A fresh fp32 (m, l, acc) carry of the online softmax for ``q``."""
    N, H, Lq, d = q.shape
    m = torch.full((N, H, Lq), _MASK_VALUE, dtype=torch.float32, device=q.device)
    l = torch.zeros((N, H, Lq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((N, H, Lq, d), dtype=torch.float32, device=q.device)
    return m, l, acc


def _finalize(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor, dtype) -> torch.Tensor:
    """The carry's output, ``acc / l`` in ``dtype`` (``m`` is not read);
    the epsilon only guards a sum that underflowed."""
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(dtype)


def accumulate_blockwise(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    carry,
    scale: float,
    block_size: int,
    offset: int = 0,
    limit: Optional[int] = None,
):
    """Fold ``k``/``v`` into an online-softmax ``(m, l, acc)`` carry in
    ``block_size`` chunks. Row ``i`` of ``k`` is global position
    ``offset + i``; positions ``>= limit`` are masked (None: none), and a
    chunk wholly past ``limit`` is skipped, so a ring hop whose shard is
    all padding leaves the carry as it was. Shared by
    ``blockwise_attention`` (one span) and ring attention
    (``parallel/ring_attention.py``, one call per arriving KV shard)."""
    Lk = k.shape[2]
    end = offset + Lk if limit is None else min(int(limit), offset + Lk)
    m, l, acc = carry
    for start in range(0, max(end - offset, 0), block_size):
        stop = min(start + block_size, Lk)
        mask = (offset + torch.arange(start, stop, device=q.device)) < end
        m, l, acc = online_softmax_step(
            q, k[:, :, start:stop], v[:, :, start:stop], m, l, acc, scale, kv_mask=mask
        )
    return m, l, acc


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_size: int = 512,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """FlashAttention-style loop over KV blocks; exact vs ``attention``.

    Blocks past ``kv_len`` are skipped: after at least one valid position
    they would add exp(-1e30 - m) = 0 to every sum."""
    _check_kv_len(kv_len, k.shape[2])
    carry = accumulate_blockwise(q, k, v, init_carry(q), q.shape[-1] ** -0.5, block_size,
                                 limit=kv_len)
    return _finalize(*carry, q.dtype)
