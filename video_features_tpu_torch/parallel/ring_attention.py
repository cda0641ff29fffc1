"""Ring attention: exact context parallelism over a mesh axis.

Counterpart of ``video_features_tpu/parallel/ring_attention.py``. The
token axis of q/k/v splits into one shard per device of the ring; every
Q shard stays where it is while the K/V shards travel one device on per
hop (``sharding.ring_permute``), and each device folds every K/V shard
that passes into its online-softmax carry (``ops/attention.py``:
``init_carry``, ``online_softmax_step``, ``accumulate_blockwise``,
``_finalize``). After one hop per device every Q shard has seen every K/V
shard: the result is full attention, summed in another order. The
carries are fp32; the output is in q's dtype.

Layout: (N, H, L, d) tensors. Right padding of L (to a multiple of the
ring's size) is masked through ``kv_len``, the global count of valid
tokens; the padded query rows compute values the caller slices off.

- ``ring_attention``: the per-shard collective, over lists of shards
  (on a mesh across launched processes, this process's shards of a ring
  over every data row: the hops between processes are paired sends and
  receives, ``sharding.ring_permute``);
- ``context_parallel_attention``: what the sharded CLIP forward runs
  under ``--mesh_context``: one head shard's q/k/v, replicated on the
  ring's devices, in; L padded (CLIP's 50 tokens) and sharded, the ring,
  the pad rows sliced off; the output, replicated on them, out;
- ``ring_attention_sharded`` (with the JAX package's divisibility
  errors) and ``make_context_parallel_core``: the JAX package's global
  views, one tensor in and out, each ``context_parallel_attention`` once
  per head shard.

The JAX package's branch for jax < 0.6's ``shard_map`` has no
counterpart: it works around an XLA partitioner fault.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from video_features_tpu_torch.ops.attention import (
    _finalize,
    accumulate_blockwise,
    init_carry,
    online_softmax_step,
)
from video_features_tpu_torch.parallel.sharding import Mesh, all_gather_data, ring_permute


def ring_attention(
    qs: Sequence[torch.Tensor],
    ks: Sequence[torch.Tensor],
    vs: Sequence[torch.Tensor],
    kv_len: Optional[int] = None,
    block_size: Optional[int] = None,
    mesh: Optional[Mesh] = None,
) -> List[torch.Tensor]:
    """Shard ``i`` of the ring is ``qs[i]``/``ks[i]``/``vs[i]``, (N, H,
    L_local, d) on the ring's ``i``-th device; returns the output shards.
    At hop ``t`` device ``i`` folds the K/V shard that started on device
    ``(i - t) mod n``, its tokens at global offset ``src * L_local`` and
    masked from ``kv_len`` on; then every K/V shard moves one device on.
    ``block_size`` chunks each arriving shard through
    ``accumulate_blockwise``. On a ``mesh`` the ring is the mesh's ``n``
    data rows and the shards given are this process's rows of it
    (``Mesh.local_rows``)."""
    n = mesh.shape["data"] if mesh is not None else len(qs)
    rows = mesh.local_rows if mesh is not None else range(n)
    devices = [q.device for q in qs]
    l_local = ks[0].shape[2]
    scale = qs[0].shape[-1] ** -0.5
    carries = [init_carry(q) for q in qs]
    k_cur, v_cur = list(ks), list(vs)
    for hop in range(n):
        for i, row in enumerate(rows):
            src = (row - hop) % n
            if block_size is not None:
                carries[i] = accumulate_blockwise(
                    qs[i], k_cur[i], v_cur[i], carries[i], scale, block_size,
                    offset=src * l_local, limit=kv_len,
                )
                continue
            mask = None
            if kv_len is not None:
                pos = src * l_local + torch.arange(l_local, device=devices[i])
                mask = pos < kv_len
            carries[i] = online_softmax_step(
                qs[i], k_cur[i], v_cur[i], *carries[i], scale, kv_mask=mask
            )
        if hop < n - 1:  # the JAX scan's last hop only restores the placement
            k_cur = ring_permute(k_cur, devices, mesh)
            v_cur = ring_permute(v_cur, devices, mesh)
    return [_finalize(*c, q.dtype) for c, q in zip(carries, qs)]


def context_parallel_attention(
    qs: Sequence[torch.Tensor],
    ks: Sequence[torch.Tensor],
    vs: Sequence[torch.Tensor],
    kv_len: Optional[int] = None,
    block_size: Optional[int] = None,
    mesh: Optional[Mesh] = None,
) -> List[torch.Tensor]:
    """One head shard's attention under ``--mesh_context``: ``qs[i]`` etc.
    are the same (N, H, L, d) q/k/v replicated on the ring's ``i``-th
    device. Each device keeps token shard ``i`` of L right-padded to a
    multiple of the ring's size (the pad keys masked, as are keys from
    ``kv_len`` on), the ring runs, and the output shards are gathered
    back along L on every device (the all-gather GSPMD inserts before the
    row-parallel output projection). Returns the (N, H, L, d) output on
    each device. On a ``mesh`` the ring is every data row of the mesh and
    the devices given are this process's rows of it (``ring_attention``)."""
    n = mesh.shape["data"] if mesh is not None else len(qs)
    rows = mesh.local_rows if mesh is not None else range(n)
    L = qs[0].shape[2]
    to = -(-L // n) * n
    step = to // n
    if kv_len is None and to != L:
        kv_len = L

    def local(ts):
        return [_pad_tokens(t, to)[:, :, i * step:(i + 1) * step] for i, t in zip(rows, ts)]

    ring = ring_attention(local(qs), local(ks), local(vs), kv_len=kv_len, block_size=block_size,
                          mesh=mesh)
    return [o[:, :, :L] for o in all_gather_data(ring, 2, mesh)]


def _per_head_shard(q, k, v, mesh: Mesh, axis_name: str, head_axis: Optional[str],
                    kv_len: Optional[int], block_size: Optional[int]) -> torch.Tensor:
    """The global view of ``context_parallel_attention``: one ring over
    ``axis_name`` per head shard of ``head_axis`` (the devices at index 0
    of the other axis without one), q/k/v replicated onto its devices,
    the output returned on q's device."""
    rings = mesh.shape[head_axis] if head_axis is not None else 1
    heads = q.shape[1] // rings
    outs = []
    for j in range(rings):
        devices = mesh.axis_devices(axis_name, j)
        rep = [[t[:, j * heads:(j + 1) * heads].to(d, non_blocking=True) for d in devices]
               for t in (q, k, v)]
        out = context_parallel_attention(*rep, kv_len=kv_len, block_size=block_size)[0]
        outs.append(out.to(q.device, non_blocking=True))
    return torch.cat(outs, dim=1)


def ring_attention_sharded(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    axis_name: str = "data",
    kv_len: Optional[int] = None,
    head_axis: Optional[str] = None,
    block_size: Optional[int] = None,
) -> torch.Tensor:
    """Global-view ring attention: L (axis 2) split over ``mesh``'s
    ``axis_name`` devices, which must divide it (pad and pass
    ``kv_len``). ``head_axis`` also splits the heads (axis 1) over the
    other mesh axis, one ring per head shard with no traffic between
    rings; without it the ring runs on the devices at index 0 of the
    other axis. Returns the output on q's device."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape[2] % mesh.shape[axis_name]:
            raise ValueError(
                f"{name} token axis {t.shape[2]} not divisible by mesh axis "
                f"'{axis_name}' ({mesh.shape[axis_name]}); pad and pass kv_len"
            )
    if head_axis is not None and q.shape[1] % mesh.shape[head_axis]:
        raise ValueError(
            f"head axis {q.shape[1]} not divisible by mesh axis "
            f"'{head_axis}' ({mesh.shape[head_axis]})"
        )
    return _per_head_shard(q, k, v, mesh, axis_name, head_axis, kv_len, block_size)


def _pad_tokens(t: torch.Tensor, to: int) -> torch.Tensor:
    return t if t.shape[2] == to else F.pad(t, (0, 0, 0, to - t.shape[2]))


def make_context_parallel_core(
    mesh: Mesh, axis_name: str = "data", head_axis: Optional[str] = "model",
    block_size: Optional[int] = None,
):
    """An ``attn_core(q, k, v) -> out`` over ``mesh``: L right-padded to
    the next multiple of the ``axis_name`` size, the pad keys masked, the
    pad query rows sliced off the result (``context_parallel_attention``).
    A ``head_axis`` absent from the mesh is ignored."""
    if head_axis is not None and head_axis not in mesh.shape:
        head_axis = None

    def core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return _per_head_shard(q, k, v, mesh, axis_name, head_axis, None, block_size)

    return core
