"""Cross-request batched admission: the daemon's coalescing queue.

Counterpart of ``video_features_tpu/serve/batcher.py``, copied as it is
(stdlib only). Incoming requests are keyed by
``(feature_type, spatial bucket)`` — the same bucket-keyed aggregation
key the ``--video_batch`` group path fuses on — and same-key requests
coalesce into groups of up to ``max_group_size`` under a latency
deadline of ``max_batch_wait_ms``. A group dispatches when it fills OR
when its oldest member's deadline expires, whichever comes first; so a
burst of N same-key requests crosses the device in ceil(N / group) fused
dispatches while a lone request waits at most one deadline.

One dispatcher thread executes groups serially (one resident scheduler
multiplexing model stages over a fixed device); WHICH ready group runs
next is the pluggable scheduler's call (serve/scheduler.py): EDF across keys with priority tiers and
aging by default, FIFO as the A/B baseline. Admission stamps each
request's ``admitted_at``/``deadline_at`` on this controller's clock so
scheduler ranks and fake-clock tests share one time base. Sources admit
concurrently from their own threads. The admission
queue is bounded (``max_queue``, counting every request admitted but
not yet terminal) — past the bound :meth:`admit` raises
:class:`QueueFull`, which the HTTP source turns into a 503 and the
spool source into leave-it-for-the-next-poll backpressure.

Determinism for tests: the clock is injectable and the deadline logic
is a pure sweep (:meth:`take_ready`), so the tests drive coalescing
with a fake ``now`` and never sleep.

All shared state lives behind one condition variable.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

from video_features_tpu_torch.serve.lifecycle import ExtractionRequest
from video_features_tpu_torch.serve.scheduler import EdfScheduler

Key = Tuple[str, str]
Group = Tuple[Key, List[ExtractionRequest]]


class QueueFull(RuntimeError):
    """Admission rejected: the bounded queue is at ``max_queue`` (or the
    controller is closed). The caller owns the reject record."""


class AdmissionController:
    """Bucket-keyed coalescing queue + single dispatcher thread.

    ``dispatch`` is called on the dispatcher thread with one
    ``(key, requests)`` group at a time; it must not raise (the daemon's
    dispatch wrapper records per-request failures itself), but a raise
    is still contained here so one poisoned group can never kill the
    serving loop."""

    def __init__(
        self,
        dispatch: Callable[[Key, List[ExtractionRequest]], None],
        max_group_size: int = 8,
        max_batch_wait_s: float = 0.05,
        max_queue: int = 256,
        clock: Callable[[], float] = time.monotonic,
        metrics: Any = None,
        scheduler: Optional[EdfScheduler] = None,
    ) -> None:
        self._dispatch = dispatch
        self.max_group_size = max(int(max_group_size), 1)
        self.max_batch_wait_s = max(float(max_batch_wait_s), 0.0)
        self.max_queue = max(int(max_queue), 1)
        self._clock = clock
        self._metrics = metrics
        self._scheduler = scheduler if scheduler is not None else EdfScheduler()
        self._cond = threading.Condition()
        # key -> open coalescing buffer; insertion-ordered so expiry
        # sweeps oldest-first (a buffer's deadline is set when its FIRST
        # member arrives and never extended by later ones)
        self._buffers: "OrderedDict[Key, List[ExtractionRequest]]" = OrderedDict()
        self._deadlines: Dict[Key, float] = {}
        # ready groups in the order they became ready; the scheduler
        # picks ACROSS this list at each dispatch, index = arrival
        # tie-break, so FIFO scheduling degenerates to the old deque
        self._ready: List[Group] = []
        self._depth = 0  # admitted, not yet handed back as terminal
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._errors = 0

    # -- admission (any thread) -----------------------------------------

    def admit(self, req: ExtractionRequest) -> None:
        """Queue one request for coalescing; raises :class:`QueueFull`
        past ``max_queue`` (bounded admission is the backpressure fix —
        an unbounded daemon queue turns a burst into an OOM)."""
        with self._cond:
            if self._closed:
                raise QueueFull("daemon is shutting down")
            if self._depth >= self.max_queue:
                raise QueueFull(
                    f"admission queue full ({self._depth}/{self.max_queue})"
                )
            self._depth += 1
            # absolute scheduling times on THIS controller's clock: the
            # scheduler's ranks and the dispatch-time expiry check both
            # read these, never the wall clock
            req.admitted_at = self._clock()
            if req.deadline_ms is not None:
                req.deadline_at = req.admitted_at + req.deadline_ms / 1000.0
            key = req.key()
            buf = self._buffers.setdefault(key, [])
            buf.append(req)
            if len(buf) >= self.max_group_size:
                del self._buffers[key]
                self._deadlines.pop(key, None)
                self._ready.append((key, buf))
            elif len(buf) == 1:
                self._deadlines[key] = self._clock() + self.max_batch_wait_s
            self._gauge_locked()
            self._cond.notify_all()

    def depth(self) -> int:
        with self._cond:
            return self._depth

    def cancel(self, request_id: str) -> Optional[ExtractionRequest]:
        """Pull one still-queued request out of the admission queue —
        open coalescing buffer or ready group — returning it so the
        caller records the terminal ``cancelled`` state. None when the
        request is not here (already dispatched, or unknown): dispatched
        requests are the daemon's cancel-requested set, checked at the
        group boundary."""
        with self._cond:
            for key, buf in list(self._buffers.items()):
                for i, r in enumerate(buf):
                    if r.id == request_id:
                        buf.pop(i)
                        if not buf:
                            del self._buffers[key]
                            self._deadlines.pop(key, None)
                        self._depth -= 1
                        self._gauge_locked()
                        self._cond.notify_all()
                        return r
            for gi, (key, reqs) in enumerate(self._ready):
                for i, r in enumerate(reqs):
                    if r.id == request_id:
                        reqs.pop(i)
                        if not reqs:
                            self._ready.pop(gi)
                        self._depth -= 1
                        self._gauge_locked()
                        self._cond.notify_all()
                        return r
        return None

    # -- deadline sweep (pure given `now`; lock held by callers) --------

    def _flush_expired_locked(self, now: float) -> None:
        for key in [k for k, d in self._deadlines.items() if d <= now]:
            buf = self._buffers.pop(key, None)
            del self._deadlines[key]
            if buf:
                self._ready.append((key, buf))

    def _flush_all_locked(self) -> None:
        while self._buffers:
            key, buf = self._buffers.popitem(last=False)
            self._deadlines.pop(key, None)
            self._ready.append((key, buf))

    def take_ready(self, now: Optional[float] = None) -> List[Group]:
        """Drain every group ready at ``now`` (full groups plus buffers
        whose deadline has passed), in scheduler dispatch order. The
        deterministic surface the fake-clock tests drive directly."""
        with self._cond:
            now = self._clock() if now is None else now
            self._flush_expired_locked(now)
            out = self._scheduler.order(self._ready, now)
            self._ready.clear()
            return out

    def _next_deadline_locked(self) -> Optional[float]:
        return min(self._deadlines.values()) if self._deadlines else None

    # -- dispatcher thread ----------------------------------------------

    def start(self) -> None:
        with self._cond:
            if self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._loop, name="serve-batcher", daemon=True
            )
        self._thread.start()

    def _loop(self) -> None:
        while True:
            with self._cond:
                group: Optional[Group] = None
                while group is None:
                    now = self._clock()
                    self._flush_expired_locked(now)
                    if self._ready:
                        group = self._ready.pop(self._scheduler.pick(self._ready, now))
                        break
                    if self._closed:
                        return
                    nd = self._next_deadline_locked()
                    timeout = None if nd is None else max(nd - self._clock(), 0.0)
                    self._cond.wait(timeout=timeout)
            self._run_group(group)

    def _run_group(self, group: Group) -> None:
        key, reqs = group
        if self._metrics is not None:
            self._metrics.set_gauge("groups_inflight", 1)
            self._metrics.inc("groups_dispatched")
        try:
            self._dispatch(key, reqs)
        except Exception:  # noqa: BLE001 - one bad group must not kill serving
            import traceback

            with self._cond:
                self._errors += 1
            print(f"serve: dispatch of group {key} died (requests survive "
                  f"as 'failed' only if the dispatcher recorded them):")
            traceback.print_exc()
        finally:
            if self._metrics is not None:
                self._metrics.set_gauge("groups_inflight", 0)
            with self._cond:
                self._depth -= len(reqs)
                self._gauge_locked()
                self._cond.notify_all()

    # -- shutdown --------------------------------------------------------

    def close(self, drain: bool = True) -> List[ExtractionRequest]:
        """Stop admitting. ``drain=True`` (the default): flush every
        partial buffer and let the dispatcher finish the backlog before
        returning — no admitted request is ever silently dropped.
        ``drain=False``: return the undispatched requests so the caller
        can record them rejected."""
        with self._cond:
            self._closed = True
            if drain:
                self._flush_all_locked()
                dropped: List[ExtractionRequest] = []
            else:
                self._flush_all_locked()
                dropped = [r for _, buf in self._ready for r in buf]
                self._depth -= len(dropped)
                self._ready.clear()
            self._cond.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join()
        elif drain:
            # never started (warmup-only runs, unit tests): drain inline
            for group in self.take_ready(now=float("inf")):
                self._run_group(group)
        return dropped

    def _gauge_locked(self) -> None:
        if self._metrics is not None:
            self._metrics.set_gauge("queue_depth.admission", self._depth)
            self._metrics.set_gauge(
                "queue_age_oldest_s", self._oldest_wait_locked(self._clock())
            )

    def _oldest_wait_locked(self, now: float) -> float:
        """Age of the oldest still-queued request (coalescing buffers +
        ready groups), 0.0 when the queue is empty — the head-of-line
        staleness signal for /metrics and the heartbeat."""
        oldest: Optional[float] = None
        for buf in self._buffers.values():
            if buf and buf[0].admitted_at is not None:
                t = buf[0].admitted_at
                oldest = t if oldest is None else min(oldest, t)
        for _, reqs in self._ready:
            if reqs and reqs[0].admitted_at is not None:
                t = reqs[0].admitted_at
                oldest = t if oldest is None else min(oldest, t)
        return max(now - oldest, 0.0) if oldest is not None else 0.0

    def oldest_wait_s(self) -> float:
        with self._cond:
            return self._oldest_wait_locked(self._clock())

    def queued_by_feature_type(self) -> Dict[str, Dict[str, Any]]:
        """Per-feature-type view of everything still queued (coalescing
        buffers + ready groups): ``{ft: {"count", "max_priority",
        "buckets"}}``. The preemptor's value score reads this — how much
        work is waiting for each model, at what priority tier, on which
        spatial buckets."""
        with self._cond:
            out: Dict[str, Dict[str, Any]] = {}
            for key, buf in list(self._buffers.items()) + list(self._ready):
                ft, bucket = key
                stat = out.setdefault(
                    ft, {"count": 0, "max_priority": 0, "buckets": set()}
                )
                stat["count"] += len(buf)
                stat["buckets"].add(bucket)
                for r in buf:
                    pri = getattr(r, "priority", None)
                    if pri is not None and int(pri) > stat["max_priority"]:
                        stat["max_priority"] = int(pri)
            for stat in out.values():
                stat["buckets"] = sorted(stat["buckets"])
            return out
