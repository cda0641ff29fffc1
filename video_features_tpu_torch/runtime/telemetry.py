"""Run telemetry for the extraction loops: spans, metrics, heartbeat.

Counterpart of ``video_features_tpu/runtime/telemetry.py``, with the
same span rows, metric names, files and ``summary.json`` block, so a
run of either package leaves the same record for the same input:

* **Spans** — one record per (video, stage) interval with monotonic
  start/end, thread id and name, worker, attempt and free attributes,
  buffered in memory and drained to ``<output>/_telemetry/spans-*.jsonl``
  by one shared daemon thread, so the loops never wait on disk. Stage
  names are the pipeline's: ``decode`` / ``prepare`` / ``h2d`` /
  ``dispatch`` / ``fetch`` / ``sink`` / ``extract`` (the serial loop's
  fused stage); ``reencode``, ``compile`` and the serve stages stay in
  ``STAGES`` so the schema (``telemetry/spans_schema.json``) is the JAX
  package's.
* **Metrics** — process-wide counters (videos done, frames decoded, H2D
  bytes, retries), gauges (the pipelined loop's queue depths) and
  log-bucketed stage-latency histograms, snapshotted atomically to
  ``_telemetry/metrics-*.json`` at every drain, so a crashed run still
  reports its throughput.
* **Heartbeat** — a periodic progress line on stderr (videos/s, decode
  fps, ETA).

``python -m video_features_tpu_torch.telemetry export`` turns a spans
file into Chrome-trace JSON, and ``report`` prints :func:`overlap_report`:
how much of the run's wall time host decode/prepare overlapped device
dispatch/fetch.

Spans are host wall time. Nothing here reads a tensor or waits on the
device: a ``dispatch`` span times the launch, a ``fetch`` span the wait
on the D2H event, and :meth:`Telemetry.count_h2d` reads ``.nbytes`` of
the host payload, so wrapping a region in a span does not change when
the card runs. Module-level state is written under ``_STATE_LOCK``, and
the drain thread is shared by every :class:`Telemetry` in the process.

The JAX package's recompile watch (``RecompileWatch`` and its helpers)
is left out: it reads XLA's compile log, and eager PyTorch compiles no
shape.
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
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from video_features_tpu_torch.utils.profiling import StageTimer

STAGES = (
    "decode", "reencode", "prepare", "h2d",
    "dispatch", "fetch", "sink", "compile", "extract",
    "request",  # serve mode: one request's lifetime, parent of its group's stages
    "admission",   # serve mode: parse + preflight + queue admit of one request
    "queue_wait",  # serve mode: admission -> group dispatch (the queueing delay)
)

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

    def _finish_row(self, row: Dict[str, Any], t0: float) -> None:
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
        records link to the timeline."""
        if not self.enabled:
            with self.timer.stage(stage):
                yield None
            return
        row = self._new_row(stage, video, extra)
        stack = self._stack()
        stack.append(row)
        t0 = time.monotonic()
        try:
            yield row
        except BaseException as exc:
            if not hasattr(exc, "telemetry_span"):
                try:
                    exc.telemetry_span = row["span"]
                except Exception:  # noqa: BLE001 - exceptions with __slots__
                    pass
            raise
        finally:
            stack.pop()
            self._finish_row(row, t0)

    def begin(self, stage: str, video: Optional[str] = None, **extra: Any) -> Optional[SpanToken]:
        """Non-lexical span open; pair with ``token.finish()``. The span
        records the opener's thread and current parent but is NOT pushed
        on the nesting stack (the interval may outlive the opening
        frame, e.g. an io/ reader's lifetime)."""
        if not self.enabled:
            return None
        row = self._new_row(stage, video, extra)
        return SpanToken(self, row, time.monotonic())

    def point(self, stage: str, **extra: Any) -> None:
        """Zero-duration event span (compile events)."""
        if not self.enabled:
            return
        row = self._new_row(stage, None, extra)
        self._finish_row(row, time.monotonic())

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
            for r in rows:
                f.write(json.dumps(r, default=str) + "\n")
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
        bounded retention window). Flushes first so the file is
        complete."""
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


def overlap_report(rows: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Overlap efficiency from span intervals: how much of the run's
    wall time had host ingest (decode/reencode/prepare) running
    concurrently with device work (h2d/dispatch/fetch).

    ``overlap_efficiency`` is overlap seconds / wall seconds — the
    headline the async-ingest PR is judged on. ``overlap_of_device``
    (overlap / device-busy) answers the sharper question: while the
    chip was busy, was the host feeding it? Single-process spans only
    use monotonic clocks, so rows from different pids are compared
    per-pid and summed."""
    by_pid: Dict[int, Tuple[list, list]] = {}
    for r in rows:
        stage = r.get("stage")
        t0, t1 = r.get("t0"), r.get("t1")
        if t0 is None or t1 is None or t1 < t0:
            continue
        pid = int(r.get("pid", 0))
        h, d = by_pid.setdefault(pid, ([], []))
        if stage in HOST_STAGES:
            h.append((float(t0), float(t1)))
        elif stage in DEVICE_STAGES:
            d.append((float(t0), float(t1)))
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
    """The device lane a span belongs to: the pipelined loop stamps
    device spans with ``worker=str(device)`` (extract/base.py); spans
    missing it (the serial loop, old files) share one per-pid lane."""
    w = r.get("worker")
    return str(w) if w else f"pid{int(r.get('pid', 0))}"


def utilization_report(rows: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-device busy/idle accounting over the device stages
    (h2d/dispatch/fetch) — the per-device refinement of
    :func:`overlap_report`. Busy time is the merged union of one
    device's span intervals; wall time is per-pid (monotonic clocks
    never compare across processes), taken over ALL stage spans so a
    device idle while the host decodes counts as idle.

    ``device_utilization`` is the headline fraction in summary.json:
    total device-busy seconds / total device-lane wall seconds (each
    pid's wall counted once per device it drove). 0.0 when no device
    spans exist (serial loop, --telemetry off)."""
    # pid -> (wall intervals over every stage, device -> intervals)
    by_pid: Dict[int, Tuple[list, Dict[str, list]]] = {}
    for r in rows:
        t0, t1 = r.get("t0"), r.get("t1")
        if t0 is None or t1 is None or t1 < t0:
            continue
        pid = int(r.get("pid", 0))
        walls, devs = by_pid.setdefault(pid, ([], {}))
        walls.append((float(t0), float(t1)))
        if r.get("stage") in DEVICE_STAGES:
            devs.setdefault(_device_of_row(r), []).append((float(t0), float(t1)))
    devices: Dict[str, Dict[str, Any]] = {}
    busy_total = wall_total = 0.0
    for walls, devs in by_pid.values():
        if not devs:
            continue
        merged_wall = _merged(walls)
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


# synthetic tid base for the per-device Perfetto lanes: far above any
# real thread ident so lanes never collide with OS thread ids
_DEVICE_LANE_TID_BASE = 1 << 22


def spans_to_chrome_trace(
    rows: Sequence[Dict[str, Any]], device_lanes: bool = False
) -> Dict[str, Any]:
    """Chrome-trace ("Trace Event Format") JSON from span rows, loadable
    in Perfetto / chrome://tracing. Complete ("X") events with µs
    ``ts``/``dur`` rebased to the earliest span, plus thread_name
    metadata so lanes are labelled decode-*/worker threads.

    ``device_lanes=True`` (``telemetry export --device-lanes``)
    additionally mirrors every device-stage span (h2d/dispatch/fetch)
    into one synthetic ``device <name>`` lane per device, so the
    busy/idle timeline :func:`utilization_report` summarizes is visible
    as a row per chip rather than scattered across dispatcher threads."""
    events: List[Dict[str, Any]] = []
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
        if device_lanes and r.get("stage") in DEVICE_STAGES:
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
