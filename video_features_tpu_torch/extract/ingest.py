"""Async device ingest for the pipelined loop (``--video_batch``,
``--inflight_groups``), and its retry timers.

Counterpart of ``video_features_tpu/extract/ingest.py``. The JAX package
gets asynchronous transfers and results from XLA's dispatch; here they
are explicit:

- ``place_batch`` stages a host array (or a host tensor: numpy has no
  bf16, so CLIP's ``--dtype bfloat16`` batch is one) in pinned memory and
  copies it to the device with ``non_blocking=True`` on a dedicated copy
  stream; the compute stream waits on the copy's event, so a group's H2D
  overlaps the previous group's compute;
- ``HostCopy`` starts a device tensor's D2H into pinned memory with
  ``non_blocking=True`` and records an event after it; ``numpy()``
  synchronizes that event before it reads the host tensor (reading it
  earlier returns stale memory and raises nothing);
- ``handle_ready`` is the non-blocking probe of a dispatch handle: the
  query of every ``HostCopy`` event in it (always True on the CPU);
- ``CompletionQueue`` is the ``--inflight_groups``-deep FIFO of
  dispatched handles the loop drains;
- ``StagedGroup`` is what an extractor's ``transfer_group`` returns: the
  fused group already on the device, with the metas ``fetch_group``
  needs to slice it apart; ``stack_group`` stacks per-video arrays;
- ``place_taps`` puts the resample taps of ``--preprocess device`` on
  the device (``BaseExtractor._device_taps`` does so once per source
  resolution: only the uint8 frames cross per dispatch), and
  ``stack_taps`` stacks per-video placed taps for a fused group.

Left unported on purpose: ``jit_donated`` (XLA buffer donation; eager
PyTorch frees a staged input when its last use on the compute stream
ends).
"""

from __future__ import annotations

import contextlib
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from video_features_tpu_torch.ops.window import pad_batch


class _Stager:
    """A CUDA device's copy stream, and the pinned staging buffers of the
    copies still in flight on it, each kept until its copy's event has
    fired (then the caching host allocator may hand the block out again)."""

    def __init__(self, device: torch.device) -> None:
        self.stream = torch.cuda.Stream(device)
        self.inflight: deque = deque()  # (copy event, pinned buffer)
        self._lock = threading.Lock()  # queue workers on one device share it

    def keep(self, event: torch.cuda.Event, host: torch.Tensor) -> None:
        with self._lock:
            while self.inflight and self.inflight[0][0].query():
                self.inflight.popleft()
            self.inflight.append((event, host))


# one stager per CUDA device, made on first use by the loop thread (a
# process-wide resource, as the device's default stream is)
_STAGERS: Dict[torch.device, _Stager] = {}
_STAGERS_LOCK = threading.Lock()


def _stager(device: torch.device) -> _Stager:
    with _STAGERS_LOCK:
        stager = _STAGERS.get(device)
        if stager is None:
            stager = _STAGERS[device] = _Stager(device)
        return stager


HostBatch = Union[np.ndarray, torch.Tensor]


def _host_tensor(x: HostBatch) -> torch.Tensor:
    """A host array or tensor as a contiguous CPU tensor (no copy where it
    already is one)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous()
    return torch.from_numpy(np.ascontiguousarray(x))


def pinned_copy(x: HostBatch) -> torch.Tensor:
    """``x`` copied into page-locked host memory (PyTorch's caching host
    allocator: a block is allocated once and reused)."""
    x = _host_tensor(x)
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host


def place_batch(x: HostBatch, device: torch.device,
                phase: Optional[Callable[[Any], Any]] = None) -> torch.Tensor:
    """``x`` on ``device``. On a CUDA device: a pinned staging copy, then
    a non-blocking H2D on the device's copy stream; the current (compute)
    stream waits on the copy's event, and the device tensor is recorded
    on the compute stream, so the caching allocator does not hand its
    memory out while the compute stream may still read it. Call it on the
    loop thread, never in ``prepare``. On the CPU: the array itself (as a
    tensor), no copy. ``phase``, called with the copy stream (None on the
    CPU), gives a context manager entered around the H2D issue alone (the
    device lane's ``h2d`` phase, ``Telemetry.device_phase``)."""
    x = _host_tensor(x)
    around = phase if phase is not None else (lambda stream: contextlib.nullcontext())
    if device.type != "cuda":
        with around(None):
            return x
    host = pinned_copy(x)
    stager = _stager(device)
    compute = torch.cuda.current_stream(device)
    with around(stager.stream), torch.cuda.stream(stager.stream):
        dev = host.to(device, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(stager.stream)
    compute.wait_event(copied)
    dev.record_stream(compute)
    stager.keep(copied, host)
    return dev


def place_taps(taps, device: torch.device):
    """``((wt_y, idx_y), (wt_x, idx_x))`` host taps -> the same pairs on
    ``device`` as (float32, int64) tensors (``torch.gather`` and indexing
    on the card take int64 indices)."""
    return tuple(
        (torch.from_numpy(np.array(wt, dtype=np.float32)).to(device),
         torch.from_numpy(np.array(idx, dtype=np.int64)).to(device))
        for wt, idx in taps
    )


def stack_taps(placed):
    """Per-video placed taps -> the (N, P, K) layout of a fused group,
    stacked on the device."""
    return tuple(tuple(torch.stack([p[axis][j] for p in placed]) for j in range(2))
                 for axis in range(2))


class HostCopy:
    """A device tensor on its way to the host: the D2H is issued at
    construction (``non_blocking`` into pinned memory, on the current
    stream, after the work that produces the tensor) and an event is
    recorded after it. ``numpy()`` waits for that event, then reads. On
    the CPU the tensor is already there."""

    __slots__ = ("_host", "_event")

    def __init__(self, t: torch.Tensor) -> None:
        if t.device.type != "cuda":
            self._host, self._event = t, None
            return
        self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self._host.copy_(t, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(t.device))

    def ready(self) -> bool:
        """Non-blocking: whether the copy has landed."""
        return self._event is None or self._event.query()

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            # graftcheck: host-sync — the fetch boundary's one wait: the
            # loop calls numpy() in fetch_*/drain_* (allowlisted), after
            # the next group is dispatched; an asynchronous kernel error
            # surfaces here
            self._event.synchronize()
        return self._host.numpy()


def handle_ready(handle: Any) -> bool:
    """Non-blocking completion probe of a dispatch handle: True when every
    ``HostCopy`` reachable through its tuples, lists and dicts has landed
    (other leaves, host arrays and metadata, are always ready)."""
    stack = [handle]
    while stack:
        leaf = stack.pop()
        if isinstance(leaf, HostCopy):
            if not leaf.ready():
                return False
        elif isinstance(leaf, (tuple, list)):
            stack.extend(leaf)
        elif isinstance(leaf, dict):
            stack.extend(leaf.values())
    return True


class StagedGroup:
    """Output of an extractor's ``transfer_group``: the fused group's
    device tensors plus the per-video metas ``fetch_group`` needs to
    slice results apart."""

    __slots__ = ("arrays", "metas")

    def __init__(self, arrays, metas: List[Any]) -> None:
        self.arrays = arrays
        self.metas = metas


class CompletionQueue:
    """FIFO of dispatched, unfetched work, ``depth`` entries deep
    (``--inflight_groups``). Entries are ``(slots, handle, grouped,
    payloads)``: a grouped entry keeps its members' host payloads until it
    drains, so a fused failure can fall back to the solo path."""

    def __init__(self, depth: int) -> None:
        self.depth = max(int(depth), 1)
        self._q: deque = deque()

    def push(self, slots, handle, grouped, payloads) -> None:
        self._q.append((slots, handle, grouped, payloads))

    def pop(self):
        return self._q.popleft()

    def head_ready(self) -> bool:
        """True when the oldest entry's device work has completed (only
        the head is probed, so drains stay in FIFO order)."""
        return bool(self._q) and handle_ready(self._q[0][1])

    @property
    def full(self) -> bool:
        return len(self._q) >= self.depth

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)


def stack_group(payload_heads: Sequence[np.ndarray], pad_to: Optional[int] = None) -> np.ndarray:
    """Per-video arrays stacked on a new leading axis, optionally
    zero-padded along it to ``pad_to``."""
    arr = np.stack(payload_heads)
    if pad_to is not None and arr.shape[0] < pad_to:
        arr = pad_batch(arr, pad_to)
    return arr


class RequeueTimers:
    """``schedule(delay, fire)`` arms a daemon ``threading.Timer`` that
    calls ``fire`` (which puts the retry's prepare future back in the
    loop's queue) after ``delay`` seconds, so no decode thread sleeps
    through a backoff. ``pending()`` counts armed timers and drops only
    after ``fire`` has run, so ``pending() == 0`` means every retry is
    back in the queue. ``wait_any`` parks the loop until a timer fires
    (or the poll interval ends) instead of spinning."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._armed = 0
        self._fired = threading.Event()

    def schedule(self, delay: float, fire: Callable[[], None]) -> None:
        if delay <= 0:
            fire()
            return
        with self._lock:
            self._armed += 1

        def _run() -> None:
            try:
                fire()
            finally:
                with self._lock:
                    self._armed -= 1
                self._fired.set()

        t = threading.Timer(delay, _run)
        t.daemon = True  # a crashed run's timer never blocks interpreter exit
        t.start()

    def pending(self) -> int:
        with self._lock:
            return self._armed

    def wait_any(self, timeout: float = 0.05) -> None:
        self._fired.wait(timeout)
        self._fired.clear()
