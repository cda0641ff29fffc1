"""Run telemetry for the extraction loops: spans, a device lane, metrics,
heartbeat.

Counterpart of ``video_features_tpu/runtime/telemetry.py``, with the
same metric names, files and ``summary.json`` block, and the JAX
package's span rows plus the port's device lane:

* **Spans** — one record per (video, stage) interval with monotonic
  start/end, thread id and name, worker, attempt and free attributes,
  buffered in memory and drained to ``<output>/_telemetry/spans-*.jsonl``
  by one shared daemon thread, so the loops never wait on disk. Stage
  names are the pipeline's: ``decode`` / ``prepare`` / ``h2d`` /
  ``dispatch`` / ``fetch`` / ``sink`` / ``extract`` (the serial loop's
  fused stage), ``compile`` (a built module's first call at an argument
  signature, ``telemetry/ledger.py``); ``reencode`` and the serve stages
  as in the JAX package. The port adds ``PORT_STAGES``: ``stage_in``
  and ``launch``, the loop thread's host work inside ``dispatch`` (a
  stack's staging, the host side of each device phase), and ``device``.
  The schema (``telemetry/spans_schema.json``) is the JAX package's plus
  those stages and the attributes ``phase``, ``stack`` and ``captured``.
* **The device lane** — :meth:`Telemetry.device_scope` (one dispatch of
  the loop) and :meth:`Telemetry.device_phase` (a phase of it) record
  CUDA timing events on the stream that runs the work; once the events
  have completed, the drain thread turns each phase into one ``device``
  row whose ``t0`` / ``t1`` are the events' times on the host's
  ``time.monotonic()`` clock, through a per-device anchor
  (:meth:`Telemetry.anchor_device`, one event recorded and waited on at
  the start of a call while the lane is quiet). The rows sit in a lane
  of their own: ``thread`` a synthetic id per worker, ``thread_name``
  ``device <worker>``. On the CPU a phase's device interval is its host
  interval. ``telemetry/DEVICE_LANE.md`` describes the lane, its error
  and how to lay it over a ``--profile_dir`` trace.
* **Metrics** — process-wide counters (videos done, frames decoded, H2D
  bytes, retries, first calls), gauges (the pipelined loop's queue
  depths) and log-bucketed stage-latency histograms, snapshotted
  atomically to ``_telemetry/metrics-*.json`` at every drain, so a
  crashed run still reports its throughput.
* **Heartbeat** — a periodic progress line on stderr (videos/s, decode
  fps, ETA).

``python -m video_features_tpu_torch.telemetry export`` turns a spans
file into Chrome-trace JSON, and ``report`` prints :func:`overlap_report`:
how much of the run's wall time host decode/prepare overlapped device
work. :func:`utilization_report`, :func:`overlap_report`'s device side
and the export's ``--device-lanes`` read the device lane
(:func:`_device_intervals`), and a process's host ``h2d`` / ``dispatch``
/ ``fetch`` spans only where it left no ``device`` row.

Host spans are host wall time. Nothing here reads a tensor, and the one
wait on the device is the anchor's, at the start of a call, before its
first dispatch: a ``dispatch`` span times the launch, a ``fetch`` span
the wait on the D2H event, the device lane's events are read only once
``query()`` says they have completed, and :meth:`Telemetry.count_h2d`
reads ``.nbytes`` of the host payload. While a ``--profile_dir``
profiler session is on, each span is also a ``record_function`` range
in the profiler's trace. Module-level state is written under
``_STATE_LOCK``, and the drain thread is shared by every
:class:`Telemetry` in the process.

The JAX package's recompile watch (``RecompileWatch`` and its helpers)
is left out: it reads XLA's compile log; the port's ``compile`` spans
come from the first call of each built module at each signature.
"""

from __future__ import annotations

import bisect
import glob
import io
import json
import math
import os
import sys
import threading
import time
import uuid
import weakref
import zlib
from collections import deque
import contextlib
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from video_features_tpu_torch.utils import profiling
from video_features_tpu_torch.utils.profiling import StageTimer

# the port's stages beyond the JAX package's: the device lane's rows, and
# the loop thread's host work inside ``dispatch``
PORT_STAGES = (
    "device",    # one device phase of a dispatch, on the CUDA events' clock
    "stage_in",  # host staging of one stack: stacking, padding, pinned copy, H2D issue
    "launch",    # the host side of one device phase (its ``phase`` attribute)
)

STAGES = (
    "decode", "reencode", "prepare", "h2d",
    "dispatch", "fetch", "sink", "compile", "extract",
    "request",  # serve mode: one request's lifetime, parent of its group's stages
    "admission",   # serve mode: parse + preflight + queue admit of one request
    "queue_wait",  # serve mode: admission -> group dispatch (the queueing delay)
) + PORT_STAGES

# Host-side ingest stages vs device dispatch/fetch stages, for the
# overlap-efficiency report. ``extract`` (the serial loop's fused
# prepare+device stage) is deliberately in neither set: the serial loop
# has no overlap story to measure. The serve lifecycle stages
# (``request``/``admission``/``queue_wait``) are in neither either —
# they bracket queueing + dispatch end-to-end, so counting them as busy
# time in either set would double-book their children.
HOST_STAGES = frozenset({"decode", "reencode", "prepare"})
DEVICE_STAGES = frozenset({"h2d", "dispatch", "fetch"})

# Log-ish latency buckets (seconds) for stage histograms: fine-grained
# where per-video stages actually land (1ms..1s), coarse above.
HIST_BOUNDS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)

_DRAIN_INTERVAL_S = 0.5
# one encoder for every spans line (``json.dumps`` with ``default`` builds
# one a call)
_ROW_ENCODER = json.JSONEncoder(default=str)
# Bounded retention when there is no file sink (external calls): enough
# for overlap math over a timed pass, small enough to never matter for
# memory.
_MEM_RETAIN_SPANS = 100_000

# -- process-global state (all writes under _STATE_LOCK) ----------------
_STATE_LOCK = threading.Lock()
_CURRENT: Optional["Telemetry"] = None
_DRAINER: Optional[threading.Thread] = None
_TARGETS: "weakref.WeakSet[Telemetry]" = weakref.WeakSet()


def set_current(tele: Optional["Telemetry"]) -> None:
    """Install ``tele`` as the process-current telemetry, the sink for
    module-level hooks (:func:`frame_decoded`, :func:`begin`/:func:`end`,
    :func:`note_bucket`) used by code that has no extractor reference
    (io/ decode, ops/ bucketing). Latest-wins, like
    ``faults.install_injector``."""
    global _CURRENT
    with _STATE_LOCK:
        _CURRENT = tele


def current() -> Optional["Telemetry"]:
    return _CURRENT


def frame_decoded(n: int = 1) -> None:
    """Count decoded frames into the current telemetry (io/video.py hook)."""
    t = _CURRENT
    if t is not None and t.enabled:
        t.metrics.inc("frames_decoded", n)


def note_bucket(key: Any) -> None:
    """Record a distinct spatial/output bucket (ops/window.py hook): the
    ``buckets_seen`` gauge."""
    t = _CURRENT
    if t is not None and t.enabled:
        t.note_bucket(key)


def begin(stage: str, video: Optional[str] = None, **extra: Any) -> Optional["SpanToken"]:
    """Open a span on the current telemetry; returns None when telemetry
    is absent/disabled so callers can pass the token straight to
    :func:`end` unconditionally. For code (io/ readers) whose interval
    does not nest lexically."""
    t = _CURRENT
    if t is None or not t.enabled:
        return None
    return t.begin(stage, video=video, **extra)


def end(token: Optional["SpanToken"]) -> None:
    if token is not None:
        token.finish()


def _ensure_drainer() -> None:
    global _DRAINER
    with _STATE_LOCK:
        if _DRAINER is not None and _DRAINER.is_alive():
            return
        t = threading.Thread(target=_drain_loop, name="telemetry-drain", daemon=True)
        _DRAINER = t
    t.start()


def _drain_loop() -> None:
    while True:
        time.sleep(_DRAIN_INTERVAL_S)
        for tele in list(_TARGETS):
            try:
                tele.resolve_device()
                tele.flush()
                tele.maybe_heartbeat()
            except Exception:  # noqa: BLE001 - observability must never kill the run
                pass


class MetricsRegistry:
    """Thread-safe counters / gauges / histograms with a dict snapshot."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        # name -> [count, sum, min, max, bucket_counts(len(HIST_BOUNDS)+1)]
        self._hists: Dict[str, list] = {}
        self.t_start = time.time()

    def inc(self, name: str, n: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = [0, 0.0, value, value, [0] * (len(HIST_BOUNDS) + 1)]
                self._hists[name] = h
            h[0] += 1
            h[1] += value
            h[2] = min(h[2], value)
            h[3] = max(h[3], value)
            h[4][bisect.bisect_left(HIST_BOUNDS, value)] += 1

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0)

    def gauge(self, name: str, default: Optional[float] = None) -> Optional[float]:
        with self._lock:
            return self._gauges.get(name, default)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "t_start": self.t_start,
                "t_snapshot": time.time(),
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {
                    name: {
                        "count": h[0], "sum": h[1], "min": h[2], "max": h[3],
                        "bounds": list(HIST_BOUNDS), "buckets": list(h[4]),
                    }
                    for name, h in self._hists.items()
                },
            }


def _quantile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank quantile over an ascending list (empty -> 0.0)."""
    if not sorted_vals:
        return 0.0
    idx = max(math.ceil(q * len(sorted_vals)) - 1, 0)
    return float(sorted_vals[min(idx, len(sorted_vals) - 1)])


class SloTracker:
    """Rolling-window SLO accounting for serve mode.

    One sample per terminal request: end-to-end latency (admission to
    terminal, on the daemon's scheduling clock), queue wait, priority
    tier, terminal state, and whether its deadline was missed. The
    window is time-bounded (``window_s``) and size-bounded
    (``max_samples``), so a week-old burst never skews today's p99 and
    memory stays O(1) under any traffic.

    ``snapshot()`` feeds /metrics, /v1/stats, and the serve heartbeat
    line: p50/p95/p99 latency + queue wait and deadline-miss rate,
    overall and per priority tier. The miss-rate denominator counts only
    requests that were *supposed* to complete (done/failed/expired);
    cancelled and rejected requests still contribute latency samples but
    a user hitting DELETE is not a missed promise.

    Thread-safe (records arrive from the dispatcher thread, snapshots
    from HTTP handler threads and the drain-thread heartbeat); no I/O
    under the lock."""

    # terminal states that count toward the deadline-miss denominator
    _MISS_DENOM_STATES = ("done", "failed", "expired")

    def __init__(
        self,
        window_s: float = 300.0,
        max_samples: int = 4096,
        clock: Any = time.monotonic,
    ) -> None:
        self.window_s = max(float(window_s), 1.0)
        self._clock = clock
        self._lock = threading.Lock()
        # (t, tier, state, latency_s, queue_wait_s|None, missed)
        self._samples: deque = deque(maxlen=max(int(max_samples), 16))

    def record(
        self,
        state: str,
        latency_s: float,
        queue_wait_s: Optional[float] = None,
        priority: int = 0,
        deadline_missed: bool = False,
        now: Optional[float] = None,
    ) -> None:
        t = self._clock() if now is None else now
        with self._lock:
            self._samples.append((
                t, int(priority), str(state), float(latency_s),
                None if queue_wait_s is None else float(queue_wait_s),
                bool(deadline_missed),
            ))

    def _window(self, now: Optional[float]) -> list:
        t = self._clock() if now is None else now
        cutoff = t - self.window_s
        with self._lock:
            # prune from the left (samples are time-ordered), then copy
            while self._samples and self._samples[0][0] < cutoff:
                self._samples.popleft()
            return list(self._samples)

    @staticmethod
    def _digest(samples: list) -> Dict[str, Any]:
        lats = sorted(s[3] for s in samples)
        waits = sorted(s[4] for s in samples if s[4] is not None)
        denom = [s for s in samples if s[2] in SloTracker._MISS_DENOM_STATES]
        missed = sum(1 for s in denom if s[5])
        return {
            "count": len(samples),
            "miss_rate": (missed / len(denom)) if denom else 0.0,
            "deadline_missed": missed,
            "latency_s": {
                "p50": round(_quantile(lats, 0.50), 4),
                "p95": round(_quantile(lats, 0.95), 4),
                "p99": round(_quantile(lats, 0.99), 4),
            },
            "queue_wait_s": {
                "p50": round(_quantile(waits, 0.50), 4),
                "p95": round(_quantile(waits, 0.95), 4),
                "p99": round(_quantile(waits, 0.99), 4),
            },
        }

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        samples = self._window(now)
        tiers: Dict[str, list] = {}
        for s in samples:
            tiers.setdefault(str(s[1]), []).append(s)
        return {
            "window_s": self.window_s,
            "overall": self._digest(samples),
            "tiers": {k: self._digest(v) for k, v in sorted(tiers.items())},
        }

    def miss_rate(self, now: Optional[float] = None) -> float:
        return self._digest(self._window(now))["miss_rate"]


class SpanToken:
    """Handle for a begin/end span (non-lexical intervals: io/ readers)."""

    __slots__ = ("_tele", "_row", "_t0", "_done")

    def __init__(self, tele: "Telemetry", row: Dict[str, Any], t0: float) -> None:
        self._tele = tele
        self._row = row
        self._t0 = t0
        self._done = False

    @property
    def span_id(self) -> str:
        return self._row["span"]

    def finish(self, **extra: Any) -> None:
        if self._done:
            return
        self._done = True
        if extra:
            self._row.update(extra)
        self._tele._finish_row(self._row, self._t0)


# -- the device lane ------------------------------------------------------

# synthetic tid base for the device lanes (the rows of the device lane and
# the export's mirrored lanes): far above any real thread ident's low bits
# so lanes never collide with OS thread ids
_DEVICE_LANE_TID_BASE = 1 << 22


def device_lane_tid(worker: str) -> int:
    """The synthetic ``thread`` id of ``worker``'s device lane: the same
    worker gets the same lane in every run."""
    return _DEVICE_LANE_TID_BASE + (zlib.crc32(str(worker).encode()) & 0xFFFFF)


def _cuda_event():
    """A CUDA timing event (one seam, so the tests can count and fake
    them)."""
    import torch

    return torch.cuda.Event(enable_timing=True)


def _cuda_stream(device):
    import torch

    return torch.cuda.current_stream(device)


def _device_key(device) -> str:
    """A CUDA device's name with its index (``cuda`` alone is the current
    device)."""
    if device.index is None:
        import torch

        return f"cuda:{torch.cuda.current_device()}"
    return str(device)


class _Mark:
    """A phase boundary: a CUDA timing event recorded on a stream, or on
    the CPU a host time, and once read its time on the host clock (``t``),
    when its event goes back to the lane's pool. Contiguous phases on one
    stream share one: an earlier phase's end is the next one's start."""

    __slots__ = ("event", "t")

    def __init__(self, event, t: Optional[float] = None) -> None:
        self.event = event
        self.t = t


class _Lane:
    """One CUDA device's anchor (an event waited on at the start of a call,
    and the host time just after the wait), the wait's length (the
    anchor's error bound), its pool of free timing events, and how many
    device scopes are open on it."""

    __slots__ = ("anchor", "t_anchor", "error_s", "pool", "scopes")

    def __init__(self) -> None:
        self.anchor = None
        self.t_anchor = 0.0
        self.error_s = 0.0
        self.pool: deque = deque()
        self.scopes = 0


class _Scope:
    """One dispatch's device scope on the loop thread: the lane (None on
    the CPU), the stream its phases run on unless they name another, the
    rows' attributes (``attrs``, with ``worker``; ``base``, a device row's
    fields but its phase and times), its own start mark (a ``forward``
    row's, if no phase is recorded), the phases recorded, and the tail:
    (stream, end mark) of the last phase closed, which the next phase on
    that stream shares as its start. A host span opened in the scope
    (:meth:`Telemetry.scope_span`) clears the tail, so the host's time in
    it is a gap of the lane wherever the stream ran dry."""

    __slots__ = ("device", "lane", "stream", "attrs", "base", "start", "phases", "tail")

    def __init__(self, device, lane: Optional[_Lane], stream, attrs: Dict[str, Any],
                 run: str) -> None:
        self.device = device
        self.lane = lane
        self.stream = stream
        self.attrs = attrs
        worker = str(attrs["worker"])
        self.base: Dict[str, Any] = {
            "span": "", "seq": 0, "parent": None, "stage": "device", "phase": None,
            "video": None, "pid": os.getpid(), "run": run,
            "thread": device_lane_tid(worker), "thread_name": f"device {worker}", **attrs}
        self.start: Optional[_Mark] = None
        self.phases = 0
        self.tail: Optional[Tuple[Any, _Mark]] = None


class _Phase:
    """The context of :meth:`Telemetry.device_phase` (a class, not a
    generator: the loop thread enters one for each phase of each stack)."""

    __slots__ = ("tele", "scope", "phase", "stream", "attrs", "launch", "start")

    def __init__(self, tele: "Telemetry", scope: _Scope, phase: str, stream,
                 attrs: Dict[str, Any]) -> None:
        self.tele, self.scope, self.phase, self.stream = tele, scope, phase, stream
        self.attrs = attrs

    def __enter__(self) -> None:
        tele, scope = self.tele, self.scope
        self.launch = tele._open_span("launch", dict(scope.attrs, phase=self.phase, **self.attrs))
        tail = scope.tail
        try:
            self.start = (tail[1] if tail is not None and tail[0] == self.stream
                          else tele._mark(scope.lane, self.stream))
        except Exception:  # noqa: BLE001 - observability must never kill the run
            self.start = None

    def __exit__(self, exc_type, exc, tb) -> bool:
        tele, scope = self.tele, self.scope
        scope.tail = None
        if self.start is not None:
            try:
                end = tele._mark(scope.lane, self.stream)
                tele._pending.append((scope, self.phase, self.attrs, self.start, end))
                scope.phases += 1
                scope.tail = (self.stream, end)
            except Exception:  # noqa: BLE001 - observability must never kill the run
                pass
        tele._close_span(*self.launch, exc)
        return False


class Telemetry:
    """Per-run span recorder + metrics registry + heartbeat.

    ``enabled=False`` (``--telemetry off``) degrades :meth:`span` to bare
    StageTimer timing, the baseline of the bookkeeping cost. With no
    ``output_root`` (external calls and print runs) spans are retained in
    a bounded in-memory deque instead of a file, so overlap math still
    works.
    """

    def __init__(
        self,
        output_root: Optional[str] = None,
        enabled: bool = True,
        heartbeat_s: float = 0.0,
        total_videos: Optional[int] = None,
        run_id: Optional[str] = None,
    ) -> None:
        self.enabled = bool(enabled)
        self.output_root = output_root
        self.heartbeat_s = float(heartbeat_s or 0.0)
        self.total_videos = total_videos
        # uuid tail: a daemon builds several Telemetry instances in the
        # same process-second (its own + one per pooled extractor), and
        # their spans files must never collide
        self.run_id = run_id or (
            f"{int(time.time()):x}-{os.getpid():x}-{uuid.uuid4().hex[:6]}"
        )
        self.timer = StageTimer()  # span-backed aggregate view
        self.metrics = MetricsRegistry()
        self._lock = threading.Lock()
        self._flush_lock = threading.Lock()
        self._seq = 0
        self._rows: deque = deque()
        self._mem: deque = deque(maxlen=_MEM_RETAIN_SPANS)
        self._buckets: set = set()
        self._local = threading.local()
        # the device lane: one _Lane per CUDA device; the phases whose
        # events have not been read yet, (scope, phase, attrs, start, end),
        # appended by the loop threads and read by resolve_device (one
        # reader at a time: _resolve_lock); _dev_lock guards the lanes'
        # anchors and open scopes
        self._dev_lock = threading.Lock()
        self._resolve_lock = threading.Lock()
        self._lanes: Dict[str, _Lane] = {}
        self._pending: deque = deque()
        self._path: Optional[str] = None
        self._metrics_path: Optional[str] = None
        self._file: Optional[io.TextIOBase] = None
        self._next_heartbeat = (
            time.monotonic() + self.heartbeat_s if self.heartbeat_s > 0 else None
        )
        self._closed = False
        # serve mode swaps the batch-progress heartbeat line for its own
        # (queue depth, inflight, miss rate): a callable returning the
        # line, or None/raising to fall back to heartbeat_line()
        self.heartbeat_provider: Optional[Any] = None
        if self.enabled and output_root:
            tdir = os.path.join(output_root, "_telemetry")
            os.makedirs(tdir, exist_ok=True)
            base = f"{os.getpid()}-{self.run_id}"
            self._path = os.path.join(tdir, f"spans-{base}.jsonl")
            self._metrics_path = os.path.join(tdir, f"metrics-{base}.json")
        if self.enabled:
            _TARGETS.add(self)
            _ensure_drainer()

    # -- spans ----------------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = []
            self._local.stack = st
        return st

    def _new_row(self, stage: str, video: Optional[str], extra: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            self._seq += 1
            seq = self._seq
        th = threading.current_thread()
        stack = self._stack()
        row: Dict[str, Any] = {
            "span": f"{self.run_id}.{seq}",
            "seq": seq,
            "parent": stack[-1]["span"] if stack else None,
            "stage": stage,
            "video": video,
            "pid": os.getpid(),
            "run": self.run_id,
            "thread": th.ident or 0,
            "thread_name": th.name,
        }
        if extra:
            row.update(extra)
        return row

    def _finish_row(self, row: Dict[str, Any], t0: float, t1: Optional[float] = None) -> None:
        if t1 is None:
            t1 = time.monotonic()
        row["t0"] = t0
        row["t1"] = t1
        dt = t1 - t0
        stage = row["stage"]
        with self.timer._lock:
            self.timer.seconds[stage] += dt
            self.timer.counts[stage] += 1
        self.metrics.observe(f"stage_s.{stage}", dt)
        with self._lock:
            self._rows.append(row)
            if self._path is None:
                self._mem.append(row)

    @contextmanager
    def span(
        self, stage: str, video: Optional[str] = None, **extra: Any
    ) -> Iterator[Optional[Dict[str, Any]]]:
        """Time a stage. Disabled mode keeps the StageTimer aggregate
        (pre-telemetry behaviour) and yields None; enabled mode yields
        the mutable row (callers may add attributes) and, on an escaping
        exception, stamps the span id onto the exception as
        ``telemetry_span`` (innermost span wins) so manifest failure
        records link to the timeline. While a ``--profile_dir`` profiler
        session is on (``utils/profiling.py::device_trace``) the span is
        also a ``torch.profiler.record_function`` range named ``stage``,
        so the trace holds it on the profiler's clock; otherwise that
        costs one flag check."""
        if not self.enabled:
            with self.timer.stage(stage):
                yield None
            return
        opened = self._open_span(stage, dict(extra, video=video))
        exc = None
        try:
            yield opened[0]
        except BaseException as e:
            exc = e
            raise
        finally:
            self._close_span(*opened, exc)

    def _open_span(self, stage: str, extra: Dict[str, Any]) -> tuple:
        """Open a span on this thread (``extra`` holds its ``video``):
        (row, t0, the profiler's range or None)."""
        row = self._new_row(stage, extra.pop("video", None), extra)
        self._stack().append(row)
        ranged = None
        if profiling.session_active():
            import torch

            ranged = torch.profiler.record_function(stage)
            ranged.__enter__()
        return row, time.monotonic(), ranged

    def _close_span(self, row: Dict[str, Any], t0: float, ranged,
                    exc: Optional[BaseException]) -> None:
        """Close a span of :meth:`_open_span`; an escaping exception gets
        its id as ``telemetry_span`` (the innermost span wins)."""
        if exc is not None and not hasattr(exc, "telemetry_span"):
            try:
                exc.telemetry_span = row["span"]
            except Exception:  # noqa: BLE001 - exceptions with __slots__
                pass
        self._stack().pop()
        self._finish_row(row, t0)
        if ranged is not None:
            ranged.__exit__(None, None, None)

    def begin(self, stage: str, video: Optional[str] = None, **extra: Any) -> Optional[SpanToken]:
        """Non-lexical span open; pair with ``token.finish()``. The span
        records the opener's thread and current parent but is NOT pushed
        on the nesting stack (the interval may outlive the opening
        frame, e.g. an io/ reader's lifetime)."""
        if not self.enabled:
            return None
        row = self._new_row(stage, video, extra)
        return SpanToken(self, row, time.monotonic())

    # -- the device lane -------------------------------------------------

    def anchor_device(self, device) -> None:
        """At the start of a call on a CUDA ``device``, before its first
        dispatch: record one timing event on the device's current stream
        and wait for it, and take the host clock just after. The device
        lane's times are that host time plus each event's elapsed time
        from the anchor; the wait's length bounds the anchor's error. The
        lane's first call anchors it; a later one takes a new anchor only
        while the lane is quiet (no device scope open on it and none of
        its phases unread), so a worker never waits on another's work on
        a shared card. Nothing on the CPU, with telemetry off, or for a
        mesh."""
        if not self.enabled or getattr(device, "type", None) != "cuda":
            return
        self.resolve_device()
        key = _device_key(device)
        try:
            # with no reader in flight and no scope opening: the lane's
            # unread phases are all in _pending, and a scope opened later
            # records its events after the anchor
            with self._resolve_lock, self._dev_lock:
                lane = self._lanes.get(key)
                if lane is None:
                    lane = self._lanes[key] = _Lane()
                elif lane.anchor is not None and (
                        lane.scopes or any(item[0].lane is lane for item in list(self._pending))):
                    return
                event = _cuda_event()
                t_a = time.monotonic()
                event.record(_cuda_stream(device))
            # graftcheck: host-sync — the device lane's anchor: one wait at
            # the start of a call, before its first dispatch, while the
            # lane has no work of this process in flight; no warm stack
            # waits here
            event.synchronize()
            t_b = time.monotonic()
        except Exception:  # noqa: BLE001 - observability must never kill the run
            return
        with self._resolve_lock:
            lane.anchor, lane.t_anchor, lane.error_s = event, t_b, t_b - t_a

    def device_anchors(self) -> Dict[str, Dict[str, float]]:
        """Each CUDA device's anchor: its host time (``t``) and the wait
        that bounds its error (``error_s``)."""
        with self._dev_lock:
            return {k: {"t": lane.t_anchor, "error_s": lane.error_s}
                    for k, lane in self._lanes.items() if lane.anchor is not None}

    @staticmethod
    def _mark(lane: Optional[_Lane], stream) -> _Mark:
        """A new boundary, recorded now on ``stream`` (the host clock on
        the CPU)."""
        if lane is None:
            return _Mark(None, time.monotonic())
        try:
            event = lane.pool.pop()
        except IndexError:
            event = _cuda_event()
        event.record(stream)
        return _Mark(event)

    @contextmanager
    def device_scope(self, device, worker: str, **attrs: Any) -> Iterator[None]:
        """One dispatch of the loop on ``device``: the device phases
        recorded inside it on this thread (:meth:`device_phase`) carry
        ``attrs`` (``video``, or a group's ``videos``) and ``worker``. If
        none is recorded, the whole dispatch becomes one ``forward`` row,
        from an event recorded on the current stream at entry to one at
        exit. No rows and no events with telemetry off, on a mesh (a
        device with no ``type``), or on a CUDA device not anchored by
        :meth:`anchor_device`."""
        scope = self._open_scope(device, worker, attrs) if self.enabled else None
        if scope is None:
            yield
            return
        prev = getattr(self._local, "scope", None)
        self._local.scope = scope
        try:
            yield
        finally:
            self._local.scope = prev
            self._close_scope(scope)

    def _open_scope(self, device, worker: str, attrs: Dict[str, Any]) -> Optional[_Scope]:
        kind = getattr(device, "type", None)
        if kind == "cpu":
            lane, stream = None, None
        elif kind == "cuda":
            lane = self._lanes.get(_device_key(device))
            if lane is None or lane.anchor is None:
                return None
            stream = _cuda_stream(device)
        else:
            return None
        scope = _Scope(device, lane, stream, dict(attrs, worker=worker), self.run_id)
        if lane is not None:
            with self._dev_lock:
                lane.scopes += 1
        try:
            scope.start = self._mark(lane, stream)
        except Exception:  # noqa: BLE001 - observability must never kill the run
            self._close_scope(scope)
            return None
        return scope

    def _close_scope(self, scope: _Scope) -> None:
        lane = scope.lane
        try:
            if scope.phases == 0 and scope.start is not None:
                self._pending.append((scope, "forward", {}, scope.start,
                                      self._mark(lane, scope.stream)))
            elif lane is not None and scope.start is not None:
                lane.pool.append(scope.start.event)  # a start no row reads
        except Exception:  # noqa: BLE001 - observability must never kill the run
            pass
        if lane is not None:
            with self._dev_lock:
                lane.scopes -= 1

    def device_phase(self, phase: str, device, stream=None, **attrs: Any):
        """One phase of the dispatch in this thread's device scope, as a
        context: a timing event on ``stream`` (by default the scope's) before
        the phase's launches and one after, read later into one ``device``
        row (``phase``, the scope's attributes and ``attrs``, e.g.
        ``stack``). A phase that follows another on the same stream shares
        that one's end event as its start, unless a :meth:`scope_span`
        opened between. The host side is a ``launch`` span on this thread.
        Outside a device scope, or on another device than the scope's,
        nothing is recorded."""
        scope = getattr(self._local, "scope", None)
        if scope is None or getattr(device, "type", None) != scope.device.type:
            return contextlib.nullcontext()
        return _Phase(self, scope, phase, scope.stream if stream is None else stream, attrs)

    def scope_span(self, stage: str, **extra: Any):
        """:meth:`span` on this thread with the attributes of its device
        scope (``video`` or ``videos``, ``worker``), if one is open, and
        ``extra``: the loop thread's ``stage_in`` spans. The next device
        phase records its own start, so the span's host time shows on the
        lane wherever the stream ran dry."""
        scope = getattr(self._local, "scope", None)
        attrs: Dict[str, Any] = {}
        if scope is not None:
            scope.tail = None
            attrs.update(scope.attrs)
        attrs.update(extra)
        return self.span(stage, **attrs)

    def resolve_device(self) -> int:
        """Turn every queued phase whose end event has completed
        (``query()``; nothing waits) into its ``device`` row, its times on
        the host clock through the lane's anchor; returns how many. The
        drain thread calls it before each flush, the loop at the end of a
        call, and :meth:`spans` and :meth:`close` before they read, so
        the loop threads build no device row."""
        done = []
        with self._resolve_lock:
            pending = self._pending
            items = [pending.popleft() for _ in range(len(pending))]
            keep = []
            for item in items:
                scope, phase, attrs, start, end = item
                lane = scope.lane
                try:
                    if end.t is None and not end.event.query():
                        keep.append(item)
                        continue
                    done.append((scope, phase, attrs, self._read(lane, start),
                                 self._read(lane, end)))
                except Exception:  # noqa: BLE001 - an unreadable event drops its row
                    pass
            pending.extendleft(reversed(keep))
        for scope, phase, attrs, t0, t1 in done:
            row = dict(scope.base, phase=phase, **attrs)
            with self._lock:
                self._seq += 1
                seq = self._seq
            row["span"], row["seq"] = f"{self.run_id}.{seq}", seq
            self._finish_row(row, t0, t1)
        return len(done)

    @staticmethod
    def _read(lane: Optional[_Lane], mark: _Mark) -> float:
        """``mark``'s host time; its first read turns the event's elapsed
        time from the anchor into that and hands the event back to the
        pool (a mark's later readers take the time). Call with
        ``_resolve_lock`` held."""
        if mark.t is None:
            mark.t = lane.t_anchor + lane.anchor.elapsed_time(mark.event) * 1e-3
            lane.pool.append(mark.event)
            mark.event = None
        return mark.t

    # -- registry hooks -------------------------------------------------

    def note_bucket(self, key: Any) -> None:
        with self._lock:
            self._buckets.add(key)
        self.metrics.set_gauge("buckets_seen", len(self._buckets))

    def buckets_seen(self) -> int:
        with self._lock:
            return len(self._buckets)

    def count_h2d(self, payload: Any) -> None:
        n = payload_nbytes(payload)
        if n:
            self.metrics.inc("h2d_bytes", n)

    # -- sinks ----------------------------------------------------------

    def flush(self) -> None:
        """Drain buffered spans to the JSONL file and refresh the
        metrics snapshot. Called by the shared drain thread and by
        :meth:`close`; safe from any thread. ``_flush_lock`` serializes
        WRITERS only — span recording contends on ``_lock`` alone, so a
        slow disk never stalls the hot path — and the file I/O itself
        lives in the ``_flush_sink`` boundary, the one blocking region."""
        with self._flush_lock:
            with self._lock:
                rows = list(self._rows)
                self._rows.clear()
            self._flush_sink(rows)

    def _flush_sink(self, rows: List[Dict[str, Any]]) -> None:
        """The blocking sink boundary: JSONL append + metrics snapshot
        rewrite. Only ever entered with ``_flush_lock`` held (one writer
        at a time); takes no state locks beyond the short ``_lock`` in
        :meth:`buckets_seen`."""
        if self._path is not None and rows:
            if self._file is None:
                self._file = open(self._path, "a", encoding="utf-8")
            f = self._file
            f.write("".join(_ROW_ENCODER.encode(r) + "\n" for r in rows))
            f.flush()
        if self._metrics_path is not None:
            from video_features_tpu_torch.io.sink import atomic_write_json

            snap = self.metrics.snapshot()
            snap["run"] = self.run_id
            snap["buckets_seen"] = self.buckets_seen()
            atomic_write_json(self._metrics_path, snap)

    def maybe_heartbeat(self) -> None:
        if self._next_heartbeat is None or time.monotonic() < self._next_heartbeat:
            return
        self._next_heartbeat = time.monotonic() + self.heartbeat_s
        line: Optional[str] = None
        if self.heartbeat_provider is not None:
            try:
                line = self.heartbeat_provider()
            except Exception:  # noqa: BLE001 - a broken provider must not kill the drain thread
                line = None
        print(line if line is not None else self.heartbeat_line(),
              file=sys.stderr, flush=True)

    def heartbeat_line(self) -> str:
        done = int(self.metrics.counter("videos_done"))
        frames = int(self.metrics.counter("frames_decoded"))
        elapsed = max(time.time() - self.metrics.t_start, 1e-9)
        vps = done / elapsed
        fps = frames / elapsed
        total = self.total_videos
        if total and vps > 0:
            eta = f"{(total - done) / vps:.0f}s"
        else:
            eta = "?"
        frac = f"{done}/{total}" if total else f"{done}"
        line = (
            f"telemetry: {frac} videos, {vps:.2f} videos/s, "
            f"{fps:.0f} decode fps, eta {eta}"
        )
        # serve mode: surface live admission-queue depth (the bounded
        # backpressure queue) on the same line the operator already reads
        depth = self.metrics.gauge("queue_depth.admission")
        if depth is not None:
            line += f", queue {int(depth)}"
        # async-ingest pipeline depths (extract/base.py::_run_pipelined):
        # dispatched-but-unfetched device groups and host-resident
        # prepared payloads waiting to dispatch — a stalled pipeline
        # shows up here live, not just post-hoc in the overlap report
        inflight = self.metrics.gauge("queue_depth.inflight")
        prepared = self.metrics.gauge("queue_depth.prepared")
        if inflight is not None or prepared is not None:
            line += (
                f", inflight {int(inflight or 0)}, prepared {int(prepared or 0)}"
            )
        return line

    def spans(self) -> List[Dict[str, Any]]:
        """All spans recorded so far (memory mode only reflects the
        bounded retention window). Reads the device phases that have
        completed and flushes first, so the file is complete."""
        self.resolve_device()
        self.flush()
        if self._path is not None:
            return read_spans(self._path)
        with self._lock:
            return list(self._mem)

    def close(self) -> None:
        """Final flush, release the file. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self.resolve_device()
        self.flush()
        with self._flush_lock:
            if self._file is not None:
                self._file.close()
                self._file = None
        _TARGETS.discard(self)


NULL_TELEMETRY = Telemetry(enabled=False)


# -- pure helpers (no Telemetry state) ----------------------------------


def payload_nbytes(payload: Any) -> int:
    """Total array bytes in a (possibly nested) host payload, duck-typed
    on ``.nbytes`` so no numpy import is needed here."""
    n = getattr(payload, "nbytes", None)
    if n is not None:
        return int(n)
    if isinstance(payload, dict):
        return sum(payload_nbytes(v) for v in payload.values())
    if isinstance(payload, (list, tuple)):
        return sum(payload_nbytes(v) for v in payload)
    return 0


def read_spans(path: str) -> List[Dict[str, Any]]:
    """Load one spans-*.jsonl file, skipping torn trailing lines."""
    rows: List[Dict[str, Any]] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except ValueError:
                continue
    return rows


def _intersect(xs: List[Tuple[float, float]], ys: List[Tuple[float, float]]) -> float:
    """Seconds where the two (already merged-disjoint, sorted) interval
    unions overlap."""
    total = 0.0
    i = j = 0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def _merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    if not intervals:
        return []
    intervals.sort()
    out = [list(intervals[0])]
    for a, b in intervals[1:]:
        if a > out[-1][1]:
            out.append([a, b])
        else:
            out[-1][1] = max(out[-1][1], b)
    return [(a, b) for a, b in out]


def _device_intervals(rows: Sequence[Dict[str, Any]]) -> Dict[int, Dict[str, list]]:
    """pid -> device lane -> (t0, t1) intervals of device work, each lane's
    in the order of its rows. A process that left ``device`` rows (the
    device lane: CUDA events on the host's clock) is read from them alone,
    by their ``worker``. A process without them (span files from before
    the device lane, a mesh, the lockstep loop) is read from its host
    ``h2d``/``dispatch``/``fetch`` spans, whose union then stands in for
    the device's busy time. Rows with no interval or a negative one are
    skipped."""
    lane: Dict[int, Dict[str, list]] = {}
    host: Dict[int, Dict[str, list]] = {}
    for r in rows:
        t0, t1 = r.get("t0"), r.get("t1")
        if t0 is None or t1 is None or t1 < t0:
            continue
        stage = r.get("stage")
        into = lane if stage == "device" else host if stage in DEVICE_STAGES else None
        if into is not None:
            into.setdefault(int(r.get("pid", 0)), {}).setdefault(
                _device_of_row(r), []).append((float(t0), float(t1)))
    return {pid: lane.get(pid) or host[pid] for pid in list(lane) + list(host)}


def overlap_report(rows: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Overlap efficiency from span intervals: how much of the run's
    wall time had host ingest (decode/reencode/prepare) running
    concurrently with device work (:func:`_device_intervals`: the device
    lane's rows, or the h2d/dispatch/fetch spans of a process without
    them).

    ``overlap_efficiency`` is overlap seconds / wall seconds — the
    headline the async-ingest PR is judged on. ``overlap_of_device``
    (overlap / device-busy) answers the sharper question: while the
    chip was busy, was the host feeding it? Single-process spans only
    use monotonic clocks, so rows from different pids are compared
    per-pid and summed."""
    by_pid: Dict[int, Tuple[list, list]] = {}
    for r in rows:
        t0, t1 = r.get("t0"), r.get("t1")
        if t0 is None or t1 is None or t1 < t0:
            continue
        h, _ = by_pid.setdefault(int(r.get("pid", 0)), ([], []))
        if r.get("stage") in HOST_STAGES:
            h.append((float(t0), float(t1)))
    for pid, lanes in _device_intervals(rows).items():
        by_pid[pid][1].extend(iv for intervals in lanes.values() for iv in intervals)
    wall = host_busy = dev_busy = overlap = 0.0
    for h, d in by_pid.values():
        host, dev = _merged(h), _merged(d)
        host_busy += sum(b - a for a, b in host)
        dev_busy += sum(b - a for a, b in dev)
        overlap += _intersect(host, dev)
        ts = [a for a, _ in host] + [a for a, _ in dev]
        te = [b for _, b in host] + [b for _, b in dev]
        if ts:
            wall += max(te) - min(ts)
    return {
        "wall_s": wall,
        "host_busy_s": host_busy,
        "device_busy_s": dev_busy,
        "overlap_s": overlap,
        "overlap_efficiency": (overlap / wall) if wall > 0 else 0.0,
        "overlap_of_device": (overlap / dev_busy) if dev_busy > 0 else 0.0,
        "spans": sum(len(h) + len(d) for h, d in by_pid.values()),
    }


def _device_of_row(r: Dict[str, Any]) -> str:
    """The device lane a span belongs to: the loops stamp device spans and
    the device lane's rows with ``worker`` (``str(device)`` unless queue
    mode names it; extract/base.py); spans missing it (old files) share
    one per-pid lane."""
    w = r.get("worker")
    return str(w) if w else f"pid{int(r.get('pid', 0))}"


def utilization_report(rows: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-device busy/idle accounting — the per-device refinement of
    :func:`overlap_report`. Busy time is the merged union of one device's
    intervals of device work (:func:`_device_intervals`: the device
    lane's rows, or for a process without them its h2d/dispatch/fetch
    spans); wall time is per-pid (monotonic clocks never compare across
    processes), taken over ALL rows so a device idle while the host
    decodes counts as idle.

    ``device_utilization`` is the headline fraction in summary.json:
    total device-busy seconds / total device-lane wall seconds (each
    pid's wall counted once per device it drove). 0.0 when no device
    work was recorded (--telemetry off)."""
    walls: Dict[int, list] = {}
    for r in rows:
        t0, t1 = r.get("t0"), r.get("t1")
        if t0 is None or t1 is None or t1 < t0:
            continue
        walls.setdefault(int(r.get("pid", 0)), []).append((float(t0), float(t1)))
    lanes = _device_intervals(rows)
    devices: Dict[str, Dict[str, Any]] = {}
    busy_total = wall_total = 0.0
    for pid, pid_walls in walls.items():
        devs = lanes.get(pid)
        if not devs:
            continue
        merged_wall = _merged(pid_walls)
        pid_wall = (merged_wall[-1][1] - merged_wall[0][0]) if merged_wall else 0.0
        for name, intervals in devs.items():
            merged = _merged(intervals)
            busy = sum(b - a for a, b in merged)
            d = devices.setdefault(
                name, {"busy_s": 0.0, "wall_s": 0.0, "spans": 0}
            )
            d["busy_s"] += busy
            d["wall_s"] += pid_wall
            d["spans"] += len(intervals)
            busy_total += busy
            wall_total += pid_wall
    for d in devices.values():
        d["busy_frac"] = (d["busy_s"] / d["wall_s"]) if d["wall_s"] > 0 else 0.0
        d["idle_s"] = max(d["wall_s"] - d["busy_s"], 0.0)
    return {
        "devices": {k: devices[k] for k in sorted(devices)},
        "device_busy_s": busy_total,
        "device_wall_s": wall_total,
        "device_utilization": (busy_total / wall_total) if wall_total > 0 else 0.0,
    }


def request_trace_rows(
    rows: Sequence[Dict[str, Any]], request_id: str
) -> List[Dict[str, Any]]:
    """Assemble the spans belonging to ONE serve request out of a run's
    combined span rows (``python -m video_features_tpu_torch.telemetry trace
    <request_id>``).

    A serve request's spans live in two files: the daemon's telemetry
    records the lifecycle (``admission``/``request``/``queue_wait``
    spans carrying ``request=<id>``), while the resident extractor's
    telemetry records the group dispatch (a ``request`` span whose
    ``requests`` list links the member ids) and the per-video pipeline
    stages. Selection:

    1. anchors — every span whose ``request`` equals the id, plus every
       group span whose ``requests`` list contains it;
    2. descendants of an anchor via ``parent`` links (the dispatcher
       thread's dispatch/fetch/sink spans nest under the group span);
    3. same-pid spans for the request's video overlapping a group
       span's interval (decode/prepare run on worker threads whose
       spans do not parent-link into the group).

    Result is t0-ordered; empty when the id appears nowhere."""
    anchors: List[Dict[str, Any]] = []
    for r in rows:
        if r.get("request") == request_id:
            anchors.append(r)
        else:
            reqs = r.get("requests")
            if isinstance(reqs, (list, tuple)) and request_id in reqs:
                anchors.append(r)
    if not anchors:
        return []
    children: Dict[str, List[Dict[str, Any]]] = {}
    for r in rows:
        p = r.get("parent")
        if p:
            children.setdefault(p, []).append(r)
    selected: Dict[str, Dict[str, Any]] = {}
    stack = list(anchors)
    while stack:
        r = stack.pop()
        sid = r.get("span")
        if not sid or sid in selected:
            continue
        selected[sid] = r
        stack.extend(children.get(sid, ()))
    videos = {r.get("video") for r in anchors if r.get("video")}
    windows = [
        (int(r.get("pid", 0)), float(r["t0"]), float(r["t1"]))
        for r in anchors
        if isinstance(r.get("requests"), (list, tuple))
        and r.get("t0") is not None and r.get("t1") is not None
    ]
    if videos and windows:
        for r in rows:
            sid = r.get("span")
            if not sid or sid in selected or r.get("video") not in videos:
                continue
            t0, t1 = r.get("t0"), r.get("t1")
            if t0 is None or t1 is None:
                continue
            pid = int(r.get("pid", 0))
            if any(pid == wp and float(t1) >= w0 and float(t0) <= w1
                   for wp, w0, w1 in windows):
                selected[sid] = r
    return sorted(selected.values(), key=lambda r: (r.get("t0") or 0.0, r.get("seq", 0)))


def spans_to_chrome_trace(
    rows: Sequence[Dict[str, Any]], device_lanes: bool = False
) -> Dict[str, Any]:
    """Chrome-trace ("Trace Event Format") JSON from span rows, loadable
    in Perfetto / chrome://tracing. Complete ("X") events with µs
    ``ts``/``dur`` rebased to the earliest span, plus thread_name
    metadata so lanes are labelled decode-*/worker threads.

    The device lane's rows are drawn in their own lane, ``device
    <worker>``, as their ``thread`` and ``thread_name`` say. For a process
    that left none (span files from before the device lane, a mesh),
    ``device_lanes=True`` (``telemetry export --device-lanes``) mirrors
    every device-stage span (h2d/dispatch/fetch) into one synthetic
    ``device <name>`` lane per device instead, so the busy/idle timeline
    :func:`utilization_report` summarizes is visible as a row per chip
    rather than scattered across dispatcher threads."""
    events: List[Dict[str, Any]] = []
    with_lane = {int(r.get("pid", 0)) for r in rows if r.get("stage") == "device"}
    t_base = min(
        (float(r["t0"]) for r in rows if r.get("t0") is not None),
        default=0.0,
    )
    seen_threads: set = set()
    device_tids: Dict[Tuple[int, str], int] = {}
    for r in rows:
        t0, t1 = r.get("t0"), r.get("t1")
        if t0 is None or t1 is None:
            continue
        pid = int(r.get("pid", 0))
        tid = int(r.get("thread", 0))
        key = (pid, tid)
        if key not in seen_threads and r.get("thread_name"):
            seen_threads.add(key)
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": r["thread_name"]},
            })
        args = {
            k: v for k, v in r.items()
            if k not in ("stage", "t0", "t1", "pid", "thread", "thread_name")
            and v is not None
        }
        ev = {
            "ph": "X",
            "name": r.get("stage", "?"),
            "cat": r.get("stage", "?"),
            "ts": int(round((float(t0) - t_base) * 1e6)),
            "dur": max(int(round((float(t1) - float(t0)) * 1e6)), 0),
            "pid": pid,
            "tid": tid,
            "args": args,
        }
        events.append(ev)
        if device_lanes and r.get("stage") in DEVICE_STAGES and pid not in with_lane:
            dev = _device_of_row(r)
            lane_key = (pid, dev)
            lane_tid = device_tids.get(lane_key)
            if lane_tid is None:
                lane_tid = _DEVICE_LANE_TID_BASE + len(device_tids)
                device_tids[lane_key] = lane_tid
                events.append({
                    "ph": "M", "name": "thread_name", "pid": pid,
                    "tid": lane_tid, "args": {"name": f"device {dev}"},
                })
            events.append({**ev, "tid": lane_tid})
    events.sort(key=lambda e: (e.get("ts", -1), e["ph"] != "M"))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# -- summary.json integration ------------------------------------------


def merge_metrics_files(output_root: str) -> Optional[Dict[str, Any]]:
    """Merge every ``_telemetry/metrics-*.json`` under ``output_root``:
    counters sum, gauges max, histograms merge bucket-wise. Returns None
    when no telemetry was recorded."""
    paths = sorted(glob.glob(os.path.join(output_root, "_telemetry", "metrics-*.json")))
    if not paths:
        return None
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    hists: Dict[str, Dict[str, Any]] = {}
    t_start: Optional[float] = None
    t_end: Optional[float] = None
    buckets = 0
    for p in paths:
        try:
            with open(p, "r", encoding="utf-8") as f:
                snap = json.load(f)
        except Exception:  # noqa: BLE001 - torn snapshot from a crashed process
            continue
        for k, v in snap.get("counters", {}).items():
            counters[k] = counters.get(k, 0) + v
        for k, v in snap.get("gauges", {}).items():
            gauges[k] = max(gauges.get(k, v), v)
        for k, h in snap.get("histograms", {}).items():
            cur = hists.get(k)
            if cur is None:
                hists[k] = {
                    "count": h["count"], "sum": h["sum"],
                    "min": h["min"], "max": h["max"],
                    "bounds": h["bounds"], "buckets": list(h["buckets"]),
                }
            else:
                cur["count"] += h["count"]
                cur["sum"] += h["sum"]
                cur["min"] = min(cur["min"], h["min"])
                cur["max"] = max(cur["max"], h["max"])
                cur["buckets"] = [a + b for a, b in zip(cur["buckets"], h["buckets"])]
        ts = snap.get("t_start")
        te = snap.get("t_snapshot")
        if ts is not None:
            t_start = ts if t_start is None else min(t_start, ts)
        if te is not None:
            t_end = te if t_end is None else max(t_end, te)
        buckets = max(buckets, int(snap.get("buckets_seen", 0)))
    if t_start is None:
        t_start = t_end = 0.0
    wall = max((t_end or 0.0) - t_start, 1e-9)
    done = counters.get("videos_done", 0)
    frames = counters.get("frames_decoded", 0)
    decode_s = hists.get("stage_s.decode", {}).get("sum", 0.0)
    return {
        "counters": counters,
        "gauges": gauges,
        "histograms": hists,
        "buckets_seen": buckets,
        "stages": {
            name[len("stage_s."):]: {"seconds": h["sum"], "calls": h["count"]}
            for name, h in hists.items() if name.startswith("stage_s.")
        },
        "throughput": {
            "wall_s": wall,
            "videos_per_s": done / wall,
            "decode_fps": (frames / decode_s) if decode_s > 0 else (frames / wall),
        },
    }


def collect(output_root: str) -> Optional[Dict[str, Any]]:
    """The ``summary.json`` telemetry block: merged metrics plus the
    overlap report over every spans file under ``output_root``."""
    block = merge_metrics_files(output_root)
    span_paths = sorted(glob.glob(os.path.join(output_root, "_telemetry", "spans-*.jsonl")))
    rows: List[Dict[str, Any]] = []
    for p in span_paths:
        rows.extend(read_spans(p))
    if block is None and not rows:
        return None
    if block is None:
        block = {}
    if rows:
        block["overlap"] = overlap_report(rows)
        # the per-device busy/idle refinement; its device_utilization
        # fraction is THE headline the fleet-scale placement work reads
        util = utilization_report(rows)
        block["utilization"] = util
        block["device_utilization"] = util["device_utilization"]
        block["span_files"] = [os.path.basename(p) for p in span_paths]
    return block
