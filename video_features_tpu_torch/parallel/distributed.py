"""Several launched processes as one mesh: a ``torch.distributed`` group.

The port's counterpart of the JAX package's ``jax.distributed.initialize``
(``cli.py``), of ``jax.experimental.multihost_utils`` and of
``parallel/sharding.py::multihost``. Under a launcher (``torchrun``, that
is ``python -m torch.distributed.run``, whose environment gives
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``
and ``LOCAL_WORLD_SIZE``) a ``--sharding mesh`` run joins one process
group (``initialize``), and ``parallel/sharding.py`` lays one global
``(data, model)`` mesh over every process: the data rows span the
processes, the model axis stays inside each. Queue mode makes no group:
its processes share no tensor, as the JAX package issues no collective
there.

The backend follows the layout, never a failure (``backend_for``):
``nccl`` where the processes' cards are distinct; ``gloo`` under
``--cpu``, or where the launcher puts more processes on a host than it
has visible cards (they share a card, which NCCL refuses), and then
device tensors cross through pinned host copies. A collective that fails
or outlives ``TIMEOUT`` raises ``CollectiveError``, which the extractors'
failure policy treats as sticky (``runtime/faults.py``): the run stops
with an error instead of carrying on out of step with the other ranks.

The collectives here are the few the mesh needs, each joined by every
process in the same order with the same arguments:

- ``broadcast_one_to_all``: process 0's integer to every process
  (``--resume``'s skip decision);
- ``all_gather_rows``: each process's entries of an indexed list (a
  row's outputs, a time block's edges or sums), every entry to every
  process; the dtypes and shapes travel with them, so entries may be
  uneven and a process with none still joins;
- ``exchange``: paired point-to-point sends and receives in one batch
  (ring attention's hops between processes);
- ``all_gather_int``: one integer from each process (the mesh's row
  counts at build time, each video's outcome in ``extract/base.py``'s
  lockstep loop);
- ``barrier``.
"""

from __future__ import annotations

import datetime
import os
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from video_features_tpu_torch.parallel import devices
from video_features_tpu_torch.parallel.devices import world_size

# a rank that falls out of step fails the run within this, instead of
# hanging it (the first collectives wait for every rank's model build
# and first kernel build)
TIMEOUT = datetime.timedelta(minutes=10)

_group: Dict[str, torch.device] = {}  # the joined group's wire device
_group_lock = threading.Lock()  # initialize/shutdown against a loop's reads


class CollectiveError(RuntimeError):
    """A collective of the mesh's process group failed or timed out: the
    ranks are out of step, and every later collective would fail too."""


def backend_for(cpu: bool, local_processes: int, visible_cards: int) -> str:
    """The layout rule: ``gloo`` on the CPU or when a host's processes
    outnumber its visible cards (processes share a card), else
    ``nccl``."""
    return "gloo" if cpu or local_processes > visible_cards else "nccl"


def initialize(cfg) -> bool:
    """Join the process group of a launched ``--sharding mesh`` run (once
    per process; ``WORLD_SIZE`` > 1): ``init_process_group`` from the
    launcher's environment, with ``TIMEOUT``, on the backend the layout
    gives (``backend_for``), bound to this process's first device. Prints
    the backend. Returns whether it joined a group now (the caller then
    calls ``shutdown``). A process without a visible card and without
    ``--cpu`` fails here, as ``resolve_devices`` does."""
    if cfg.sharding != "mesh" or world_size() < 2 or dist.is_initialized():
        return False
    device = devices.resolve_devices(cfg)[0]
    local = int(os.environ.get("LOCAL_WORLD_SIZE") or world_size())
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    backend = backend_for(device.type != "cuda", local, cards)
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(device)
        kw["device_id"] = device  # eager: a failed NCCL set-up fails here
    dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT, **kw)
    with _group_lock:
        _group["device"] = device if backend == "nccl" else torch.device("cpu")
    print(f"distributed: rank {dist.get_rank()} of {dist.get_world_size()}, backend "
          f"{backend}, {local} process(es) on this host over {cards} visible card(s)")
    return True


def shutdown() -> None:
    """Leave the process group ``initialize`` joined."""
    if dist.is_initialized():
        dist.destroy_process_group()
    with _group_lock:
        _group.clear()


def multihost() -> bool:
    """True in a joined group of more than one process."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if multihost() else 0


def process_count() -> int:
    return dist.get_world_size() if multihost() else 1


def _wire_device() -> torch.device:
    """Where a collective's tensors live: this process's card for NCCL,
    the host for gloo."""
    return _group.get("device") or torch.device("cpu")


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    wire = _wire_device()
    if t.device == wire:
        return t.contiguous()
    if wire.type == "cpu" and t.device.type == "cuda":  # gloo: a pinned host copy
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t)
    return t.to(wire)


def _checked(what: str, fn, *args, **kwargs):
    try:
        return fn(*args, **kwargs)
    except RuntimeError as e:  # DistBackendError and gloo's timeouts
        raise CollectiveError(f"collective failed: {what} on rank {process_index()} of "
                              f"{process_count()}: {e}") from e


def _all_gather(t: torch.Tensor) -> List[torch.Tensor]:
    t = _to_wire(t)
    out = [torch.empty_like(t) for _ in range(process_count())]
    _checked("all_gather", dist.all_gather, out, t)
    return out


def all_gather_int(value: int) -> List[int]:
    """Every process's ``value``, in rank order."""
    return [int(t) for t in _all_gather(torch.tensor([int(value)], dtype=torch.int64))]


def broadcast_one_to_all(value: int) -> int:
    """Process 0's ``value`` on every process (the JAX package's
    ``multihost_utils.broadcast_one_to_all``)."""
    t = _to_wire(torch.tensor([int(value)], dtype=torch.int64))
    _checked("broadcast", dist.broadcast, t, 0)
    return int(t.item())


def barrier() -> None:
    if multihost():
        _checked("barrier", dist.barrier)


def _all_gather_object(obj) -> list:
    out = [None] * process_count()
    _checked("all_gather_object", dist.all_gather_object, out, obj)
    return out


def _nbytes(dtype: torch.dtype, shape: Sequence[int]) -> int:
    count = 1
    for d in shape:
        count *= d
    return count * torch.empty((), dtype=dtype).element_size()


def all_gather_rows(entries: Mapping[int, Sequence[torch.Tensor]], n: int,
                    device: torch.device) -> List[Optional[Tuple[torch.Tensor, ...]]]:
    """Index ``i`` of an ``n``-long list held by one process or none:
    ``entries`` maps this process's indices to their tensors. Returns, on
    every process, every index's tensors in index order (this process's
    own as they are, the others' on ``device``), None where no process
    holds the index. One gather of each process's ``{index: [(dtype,
    shape)]}`` and one of the bytes, each process's padded to the
    longest; on one process, no collective."""
    if process_count() == 1:
        return [tuple(entries[i]) if i in entries else None for i in range(n)]
    metas = _all_gather_object({i: [(t.dtype, tuple(t.shape)) for t in ts]
                                for i, ts in entries.items()})
    wire = _wire_device()
    flat = [_to_wire(t.contiguous().reshape(-1).view(torch.uint8))
            for i in sorted(entries) for t in entries[i]]
    data = torch.cat(flat) if flat else torch.zeros(0, dtype=torch.uint8, device=wire)
    longest = max(sum(_nbytes(*s) for shapes in m.values() for s in shapes) for m in metas)
    padded = torch.zeros(longest, dtype=torch.uint8, device=wire)
    padded[:data.numel()] = data
    gathered = _all_gather(padded)
    out: List[Optional[Tuple[torch.Tensor, ...]]] = [None] * n
    for i, ts in entries.items():
        out[i] = tuple(ts)
    for rank, meta in enumerate(metas):
        if rank == process_index():
            continue
        offset = 0  # each process packed its indices in order
        for i in sorted(meta):
            ts = []
            for dtype, shape in meta[i]:
                size = _nbytes(dtype, shape)
                raw = gathered[rank][offset:offset + size]
                offset += size
                # a fresh buffer: a view of dtype needs its alignment
                ts.append(raw.clone().view(dtype).reshape(shape).to(device))
            out[i] = tuple(ts)
    return out


def exchange(sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[torch.Tensor, int]]) -> None:
    """Paired point-to-point transfers in one batch: each ``(tensor,
    rank)`` of ``sends`` goes to ``rank``; each ``(buffer, rank)`` of
    ``recvs`` is filled from ``rank``, in the order that rank sends.
    Every send and receive is posted before any is waited for, so a ring
    of processes that all send and receive cannot deadlock."""
    if not sends and not recvs:
        return
    wire_sends = [(_to_wire(t), r) for t, r in sends]
    wire_recvs = [(torch.empty(b.shape, dtype=b.dtype, device=_wire_device()), r)
                  for b, r in recvs]
    ops = [dist.P2POp(dist.isend, t, r) for t, r in wire_sends]
    ops += [dist.P2POp(dist.irecv, t, r) for t, r in wire_recvs]
    for work in _checked("batch_isend_irecv", dist.batch_isend_irecv, ops):
        _checked("isend/irecv", work.wait)
    for (buf, _), (got, _) in zip(recvs, wire_recvs):
        buf.copy_(got)
