"""Fault tolerance: error classes, classification, retry policy, the run
manifest and deterministic fault injection.

Counterpart of ``video_features_tpu/runtime/faults.py``: the batch
pipeline's stages (decode, prepare, dispatch, sink) and the serve
daemon's (admission, serve_dispatch, extractor, tracker_write,
replica_kill, hbm_squeeze, lease_stall):

- :func:`classify_error` buckets an exception into ``transient`` (I/O
  flake, decode deadline: retrying may help), ``oom`` (memory pressure:
  retrying may help) or ``permanent`` (corrupt input, a CUDA error, a
  kernel that does not build: fail fast, record, move on);
- :class:`RunManifest` appends one JSONL record per per-video outcome to
  a per-process file under ``<output_path>/_manifest/``;
  :func:`merge_manifest` folds every process's and every earlier run's
  records into one summary and :func:`finalize_run` writes it as
  ``summary.json``. Rows and summary keep the JAX package's keys, so
  either package's ``merge_manifest`` reads the other's files;
- :func:`backoff_delay` is the retry schedule, exponential with a jitter
  that hashes the video's key (reproducible, and no two videos retry in
  lockstep);
- :class:`FaultInjector` (``--fault_inject STAGE:KIND:EVERY_N``,
  test-only) raises or stalls at a stage every N calls, so the retry and
  manifest paths are exercised by fast CPU tests.

No torch import here: the manifest stays writable from decode threads
whatever state the device is in.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import os
import signal
import sys
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence

MANIFEST_DIRNAME = "_manifest"
SUMMARY_BASENAME = "summary.json"

# the serve stages: request admission, the group body around the
# extractor call, the resident extractor itself (breaker/teardown
# coverage), and the durable result write; replica_kill fires in the
# spool watcher's poll pass (kind 'kill' SIGKILLs the whole replica
# process — the work-stealing drill), hbm_squeeze in the preemptor's
# headroom read (any raising kind collapses the observed device-memory
# headroom to zero, forcing the preemption path without a real wall)
# and lease_stall in the lease heartbeat (a raising kind skips that
# pass's mtime refresh)
STAGES = (
    "decode", "prepare", "dispatch", "sink",
    "admission", "serve_dispatch", "extractor", "tracker_write",
    "replica_kill", "hbm_squeeze", "lease_stall",
)
KINDS = ("error", "corrupt", "hang", "oom", "compile", "kill")
# how long an injected 'hang' sleeps
HANG_SECONDS = 0.4

RETRYABLE_CLASSES = ("transient", "oom")


# --- exception taxonomy -----------------------------------------------------

class DecodeTimeout(Exception):
    """Decode exceeded its deadline (a stalled demuxer or read, or an
    ffmpeg subprocess past its timeout). Transient: the next attempt gets
    a fresh deadline."""

    stage = "decode"


class CorruptVideoError(IOError):
    """The container itself is bad (cannot open, zero frames decodable,
    too short to sample). Permanent: no number of retries fixes bytes."""

    stage = "decode"


class MediaRejected(CorruptVideoError):
    """A probe rejected the input before any real decode work. Permanent,
    with the probe's reason in the message."""

    stage = "preflight"


class ResourceCapExceeded(Exception):
    """The input busts a declared resource cap. Permanent: a bigger input
    never shrinks on retry."""

    stage = "decode"


class AudioDecodeError(IOError):
    """The audio payload is bad (unparseable wav, an ffmpeg rip that dies
    on the bitstream): ``io/audio.py``'s analog of
    :class:`CorruptVideoError`. Permanent."""

    stage = "decode"


class MissingStreamError(AudioDecodeError):
    """The container opened but carries no stream of the kind the consumer
    needs (a silent mp4 through VGGish). Permanent, with the missing
    stream named in the message."""


class InjectedTransientError(OSError):
    """--fault_inject KIND=error: an I/O flake."""


class InjectedPermanentError(ValueError):
    """--fault_inject KIND=corrupt: unfixable bad input."""


class InjectedOOMError(RuntimeError):
    """--fault_inject KIND=oom: its message carries 'out of memory' so the
    real classifier routes it."""


class InjectedCompileError(RuntimeError):
    """--fault_inject KIND=compile: a kernel that does not build; its
    message carries 'nvcc' so the real classifier routes it."""


class InjectedSinkKill(RuntimeError):
    """--fault_inject KIND=kill: the process dying mid-save, raised after
    the tmp file is written and before the rename."""

    stage = "sink"


class PeerFailure(RuntimeError):
    """In a mesh across launched processes, another process failed this
    video's step (its own record says why): every process takes the
    decision of the worst ``error_class`` among them
    (``extract/base.py::_agree``)."""

    def __init__(self, message: str, error_class: str) -> None:
        super().__init__(message)
        self.error_class = error_class


# --- classification ---------------------------------------------------------

_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "out of memory", "Out of memory", "OOM")
# a CUDA error other than an allocation failure is sticky in the process
# (every later launch fails the same way), a kernel that does not build
# or load does not build on retry either, and after a failed collective
# the processes of a mesh are out of step for good
_STICKY_MARKERS = (
    "CUDA error",
    "illegal memory access",
    "device-side assert",
    "nvcc",
    "kernel library",
    "collective failed",
)


def classify_error(exc: BaseException) -> str:
    """Bucket ``exc`` into 'transient' | 'oom' | 'permanent'.

    Order matters: the specific contracts (corrupt input, decode deadline,
    allocation failure, sticky CUDA error) win over the broad OSError
    check (CorruptVideoError IS an OSError, but bad bytes never become
    good bytes)."""
    if isinstance(exc, PeerFailure):
        return exc.error_class
    if isinstance(exc, (CorruptVideoError, AudioDecodeError, ResourceCapExceeded)):
        return "permanent"
    if isinstance(exc, DecodeTimeout):
        return "transient"
    if isinstance(exc, MemoryError):
        return "oom"
    torch = sys.modules.get("torch")  # an OOM can only come from a loaded torch
    if torch is not None and isinstance(exc, torch.cuda.OutOfMemoryError):
        return "oom"
    msg = str(exc)
    if any(m in msg for m in _OOM_MARKERS):
        return "oom"
    if any(m in msg for m in _STICKY_MARKERS):
        return "permanent"
    if isinstance(exc, (OSError, TimeoutError)):
        # I/O flakes: decode reads, sink writes, subprocess deadlines
        return "transient"
    return "permanent"


def is_sticky(exc: BaseException) -> bool:
    """Whether ``exc`` poisons the process for every later launch (a CUDA
    error other than an allocation failure, or a kernel that does not
    build or load): the loop then stops instead of failing each later
    video the same way. ``classify_error`` calls these ``permanent``."""
    if classify_error(exc) != "permanent":
        return False
    msg = str(exc)
    return any(m in msg for m in _STICKY_MARKERS)


class LoopStopped(Exception):
    """Raised by an extractor's failure policy at a sticky device error
    (``extract/base.py::_stop_on_sticky``): the loop ends there and leaves
    the videos not yet attempted without a record. ``videos`` holds the
    keys of the videos it recorded failed."""

    def __init__(self, message: str, videos=()) -> None:
        super().__init__(message)
        self.videos = frozenset(videos)


# exception types that indict the INPUT rather than the stack. The serve
# circuit breaker must ignore these — a burst of corrupt user uploads is
# not a sick model, and tearing down a healthy resident extractor over
# them would let hostile traffic take the model down.
# InjectedPermanentError is the test-only stand-in for "unfixable bad
# input" and rides the same contract.
INPUT_ERROR_TYPES = (
    CorruptVideoError,    # includes MediaRejected
    AudioDecodeError,     # includes MissingStreamError
    ResourceCapExceeded,
    InjectedPermanentError,
)


def is_input_error(exc: BaseException) -> bool:
    """True when ``exc`` blames the input media, not the infrastructure
    — the breaker-correctness predicate (serve/daemon.py gates
    ``CircuitBreaker.record_failure`` on it)."""
    return isinstance(exc, INPUT_ERROR_TYPES)


def is_retryable(error_class: str) -> bool:
    """Whether re-entering the work queue can help."""
    return error_class in RETRYABLE_CLASSES


def backoff_delay(attempt: int, base: float, key: str) -> float:
    """Exponential backoff with deterministic jitter for retry ``attempt``
    (1-based): ``base * 2^(attempt-1) * [0.5, 1]``, the jitter from
    sha1(key, attempt)."""
    if base <= 0:
        return 0.0
    digest = hashlib.sha1(f"{key}:{attempt}".encode()).digest()
    frac = digest[0] / 255.0  # [0, 1]
    return base * (2.0 ** (attempt - 1)) * (0.5 + 0.5 * frac)


# --- fault injection --------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultSpec:
    stage: str
    kind: str
    every_n: int


def parse_fault_specs(specs: Optional[Sequence[str]]) -> List[FaultSpec]:
    """Parse ``--fault_inject STAGE:KIND:EVERY_N`` values; raises
    ValueError naming the bad spec (``sanity_check`` calls this, so a typo
    fails at argument parsing, not mid-run)."""
    out: List[FaultSpec] = []
    for raw in specs or ():
        parts = str(raw).split(":")
        if len(parts) != 3:
            raise ValueError(f"--fault_inject expects STAGE:KIND:EVERY_N, got {raw!r}")
        stage, kind, every = parts
        if stage not in STAGES:
            raise ValueError(f"--fault_inject stage {stage!r} not in {STAGES} ({raw!r})")
        if kind not in KINDS:
            raise ValueError(f"--fault_inject kind {kind!r} not in {KINDS} ({raw!r})")
        try:
            n = int(every)
        except ValueError:
            n = 0
        if n < 1:
            raise ValueError(f"--fault_inject EVERY_N must be a positive int ({raw!r})")
        out.append(FaultSpec(stage, kind, n))
    return out


class FaultInjector:
    """``fire(stage)`` counts that stage's calls and raises (or stalls)
    when a spec's ``count % every_n == 0``. A stage's call is its own
    unit: decode one reader open; prepare, dispatch and sink one video."""

    def __init__(self, specs: Sequence[FaultSpec]) -> None:
        self._specs: Dict[str, List[FaultSpec]] = {}
        for s in specs:
            self._specs.setdefault(s.stage, []).append(s)
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def fire(self, stage: str) -> None:
        specs = self._specs.get(stage)
        if not specs:
            return
        with self._lock:
            count = self._counts.get(stage, 0) + 1
            self._counts[stage] = count
        for spec in specs:
            if count % spec.every_n == 0:
                self._raise(spec, count)

    @staticmethod
    def _raise(spec: FaultSpec, count: int) -> None:
        tag = f"injected fault {spec.stage}:{spec.kind} (call {count})"
        if spec.kind == "hang":
            time.sleep(HANG_SECONDS)
            return
        if spec.stage == "replica_kill" and spec.kind == "kill":
            # the chaos drill is a REAL SIGKILL: no atexit, no finally,
            # no flush — exactly the death the lease-expiry reclamation
            # and foreign-replica reconcile exist to survive
            os.kill(os.getpid(), signal.SIGKILL)
        exc: Exception
        if spec.kind == "error":
            exc = InjectedTransientError(f"{tag}: transient I/O error")
        elif spec.kind == "corrupt":
            exc = InjectedPermanentError(f"{tag}: unfixable corrupt input")
        elif spec.kind == "oom":
            exc = InjectedOOMError(f"{tag}: CUDA out of memory")
        elif spec.kind == "compile":
            exc = InjectedCompileError(f"{tag}: nvcc failed")
        else:  # kill
            exc = InjectedSinkKill(f"{tag}: process killed mid-save")
        exc.stage = spec.stage  # lets handlers attribute the true stage
        raise exc


_INJECTOR: Optional[FaultInjector] = None
_INJECTOR_LOCK = threading.Lock()


def install_injector(specs: Optional[Sequence[str]]) -> None:
    """Install (or, with None/empty, clear) the process-global injector:
    the most recently built extractor's ``--fault_inject`` wins, which is
    the one-run-per-process CLI lifecycle."""
    global _INJECTOR
    parsed = parse_fault_specs(specs)
    with _INJECTOR_LOCK:
        _INJECTOR = FaultInjector(parsed) if parsed else None


def fire(stage: str) -> None:
    """Injection point; one attribute read when no injector is installed."""
    inj = _INJECTOR
    if inj is not None:
        inj.fire(stage)


# --- run manifest -----------------------------------------------------------

def manifest_dir(output_root: str) -> str:
    return os.path.join(output_root, MANIFEST_DIRNAME)


class RunManifest:
    """Append-only per-process JSONL event log under
    ``<output_root>/_manifest/events-<pid>-<runid>.jsonl``, one lock per
    process (decode threads and the device loop both record), each line
    flushed so a killed run keeps every outcome before the kill."""

    def __init__(self, output_root: str) -> None:
        self.output_root = output_root
        self.run_id = uuid.uuid4().hex[:8]
        self.path = os.path.join(
            manifest_dir(output_root), f"events-{os.getpid()}-{self.run_id}.jsonl"
        )
        self._lock = threading.Lock()
        self._seq = 0
        self._fh = None

    def record(
        self,
        video: Optional[str],
        status: str,
        stage: Optional[str] = None,
        error_class: Optional[str] = None,
        error_type: Optional[str] = None,
        message: Optional[str] = None,
        attempts: Optional[int] = None,
        wall_s: Optional[float] = None,
        **extra: Any,
    ) -> None:
        row: Dict[str, Any] = {"video": video, "status": status}
        if stage is not None:
            row["stage"] = stage
        if error_class is not None:
            row["error_class"] = error_class
        if error_type is not None:
            row["error_type"] = error_type
        if message is not None:
            row["message"] = str(message)[:500]
        if attempts is not None:
            row["attempts"] = int(attempts)
        if wall_s is not None:
            row["wall_s"] = round(float(wall_s), 4)
        row.update(extra)
        self._append(row)

    def event(self, name: str, **fields: Any) -> None:
        """Happenings that are not one video's outcome."""
        self._append({"event": name, **fields})

    def _append(self, row: Dict[str, Any]) -> None:
        with self._lock:
            self._seq += 1
            row = {
                "ts": round(time.time(), 4),
                "pid": os.getpid(),
                "run": self.run_id,
                "seq": self._seq,
                **row,
            }
            if self._fh is None:
                os.makedirs(os.path.dirname(self.path), exist_ok=True)
                self._fh = open(self.path, "a", encoding="utf-8")
            self._fh.write(json.dumps(row) + "\n")
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


class _NullManifest:
    """No-op stand-in for external_call and print-mode runs."""

    path = None
    output_root = None

    def record(self, *a: Any, **kw: Any) -> None:
        pass

    def event(self, *a: Any, **kw: Any) -> None:
        pass

    def close(self) -> None:
        pass


NULL_MANIFEST = _NullManifest()

_TERMINAL = ("done", "failed", "rejected", "expired", "cancelled")


def iter_manifest_records(output_root: str) -> List[Dict[str, Any]]:
    """Every record of every events file, in (ts, pid, seq) order. A torn
    trailing line (a killed writer) is skipped, never fatal."""
    rows: List[Dict[str, Any]] = []
    for path in glob.glob(os.path.join(manifest_dir(output_root), "events-*.jsonl")):
        try:
            with open(path, "r", encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rows.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue
        except OSError:
            continue
    rows.sort(key=lambda r: (r.get("ts", 0), r.get("pid", 0), r.get("seq", 0)))
    return rows


def merge_manifest(output_root: str) -> Optional[Dict[str, Any]]:
    """Fold every events file under ``output_root`` into one summary, or
    None when there is none.

    A video's final status is its chronologically last terminal record,
    so a retry that recovers reads 'done', a resume that fails again reads
    'failed', and a 'skipped' probe never demotes an earlier 'done'.
    Videos with only non-terminal records (skipped, retry) keep the last
    of those."""
    records = iter_manifest_records(output_root)
    if not records:
        return None
    videos: Dict[str, Dict[str, Any]] = {}
    warnings: List[Dict[str, Any]] = []
    events: List[Dict[str, Any]] = []
    retries = 0
    for r in records:
        if "event" in r:
            events.append(r)
            continue
        status = r.get("status")
        if status == "warning":
            warnings.append(r)
            continue
        if status == "retry":
            retries += 1
        key = r.get("video")
        if key is None:
            continue
        cur = videos.setdefault(key, {"status": None})
        cur["attempts"] = max(int(cur.get("attempts") or 0), int(r.get("attempts") or 0))
        terminal = status in _TERMINAL
        if terminal or cur["status"] not in _TERMINAL:
            cur["status"] = status
            for field in ("stage", "error_class", "error_type", "message", "wall_s", "span"):
                if field in r:
                    cur[field] = r[field]
                elif field in cur and terminal:
                    del cur[field]
    counts = {"done": 0, "failed": 0, "skipped": 0, "retry": 0,
              "rejected": 0, "expired": 0, "cancelled": 0, "other": 0}
    for v in videos.values():
        counts[v["status"] if v["status"] in counts else "other"] += 1
    worker_deaths = [e for e in events if e.get("event") == "worker_death"]
    return {
        "videos": videos,
        "total": len(videos),
        "done": counts["done"],
        "failed": counts["failed"],
        "skipped": counts["skipped"],
        "rejected": counts["rejected"],
        "expired": counts["expired"],
        "cancelled": counts["cancelled"],
        "retries": retries,
        "warnings": warnings,
        "events": events,
        "worker_deaths": worker_deaths,
    }


def finalize_run(output_root: str) -> Optional[Dict[str, Any]]:
    """Merge and atomically write ``_manifest/summary.json``, with the
    run's ``telemetry`` block (``runtime/telemetry.py::collect``: merged
    metrics and the overlap report over the span files). Returns the
    summary, or None when there is no manifest."""
    summary = merge_manifest(output_root)
    if summary is None:
        return None
    # a telemetry fault must never lose the run record: it lands as a
    # string in the summary instead of raising
    try:
        from video_features_tpu_torch.runtime import telemetry

        tblock = telemetry.collect(output_root)
        if tblock:
            summary["telemetry"] = tblock
    except Exception as e:  # noqa: BLE001 - keep the manifest writable
        summary["telemetry_error"] = repr(e)
    # lazy import: io/sink.py imports this module for fault injection
    from video_features_tpu_torch.io.sink import atomic_write_json

    path = os.path.join(manifest_dir(output_root), SUMMARY_BASENAME)
    atomic_write_json(path, summary)
    return summary


def format_summary(summary: Dict[str, Any]) -> str:
    """The run's one-line outcome (with videos/s and decode fps when the
    run recorded telemetry), then up to five failed videos."""
    parts = [
        f"run manifest: {summary['done']}/{summary['total']} done",
        f"{summary['failed']} failed",
        f"{summary['skipped']} skipped",
        f"{summary['retries']} retries",
    ]
    if summary.get("rejected"):
        parts.insert(2, f"{summary['rejected']} rejected")
    if summary.get("expired"):
        parts.append(f"{summary['expired']} expired")
    if summary.get("cancelled"):
        parts.append(f"{summary['cancelled']} cancelled")
    if summary["warnings"]:
        parts.append(f"{len(summary['warnings'])} warning(s)")
    if summary["worker_deaths"]:
        parts.append(f"{len(summary['worker_deaths'])} worker death(s)")
    tput = summary.get("telemetry", {}).get("throughput")
    if tput:
        parts.append(f"{tput.get('videos_per_s', 0.0):.2f} videos/s")
        parts.append(f"{tput.get('decode_fps', 0.0):.0f} decode fps")
    line = ", ".join(parts)
    failed = [k for k, v in summary["videos"].items() if v["status"] == "failed"]
    if failed:
        shown = ", ".join(failed[:5]) + (", ..." if len(failed) > 5 else "")
        line += f"\n  failed: {shown}"
    return line


def strict_failures(summary: Dict[str, Any]) -> List[str]:
    """What ``--strict`` turns into a nonzero exit: failed videos,
    empty-feature warnings and worker deaths."""
    problems = [
        f"failed: {k} ({v.get('error_class', '?')}: {v.get('message', '')[:80]})"
        for k, v in summary["videos"].items()
        if v["status"] == "failed"
    ]
    problems += [f"warning: {w.get('message', '')[:120]}" for w in summary["warnings"]]
    problems += [
        f"worker death: {d.get('device', '?')}: {d.get('message', '')[:80]}"
        for d in summary["worker_deaths"]
    ]
    return problems


def permanently_failed_videos(output_root: str) -> set:
    """Videos whose merged final status is a permanent failure: the set
    ``--resume`` skips unless ``--retry_failed`` (a transient failure that
    ran out of retries is attempted again on resume)."""
    summary = merge_manifest(output_root)
    if summary is None:
        return set()
    return {
        k
        for k, v in summary["videos"].items()
        if v["status"] == "failed" and v.get("error_class") == "permanent"
    }
