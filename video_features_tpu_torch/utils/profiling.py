"""Device tracing and per-stage timing.

Counterpart of ``video_features_tpu/utils/profiling.py``.
``device_trace(dir)`` wraps a region in a ``torch.profiler`` session
(host and CUDA activities) in place of the JAX package's
``jax.profiler`` trace, and writes a Chrome trace,
``<dir>/trace-<pid>-<n>.json``, when the session ends; the kernels'
names can be read back from it (``chrome://tracing``, Perfetto). The
profiler is process-global (one Kineto session at a time), so nested and
concurrent regions share one refcounted session. ``StageTimer``
aggregates wall time per pipeline stage across videos.
"""

from __future__ import annotations

import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Optional

_trace_lock = threading.Lock()
_trace_refs = 0
_trace_session: Optional[Any] = None  # the open torch.profiler.profile
_trace_dir: Optional[str] = None
_trace_count = 0  # sessions ended in this process: the <n> of the file name


def _start() -> Any:
    import torch

    prof = torch.profiler.profile(activities=torch.profiler.supported_activities())
    try:
        prof.start()
    except BaseException:
        try:
            prof.stop()
        except Exception:  # noqa: BLE001 - nothing was started; the start error is raised
            pass
        raise
    return prof


def session_active() -> bool:
    """Whether a ``device_trace`` session is on: one read of a flag, made
    by every telemetry span (``runtime/telemetry.py``), which then enters a
    ``record_function`` range."""
    return _trace_session is not None


@contextmanager
def device_trace(profile_dir: Optional[str]) -> Iterator[None]:
    """A refcounted ``torch.profiler`` session over a region; a no-op when
    ``profile_dir`` is None or empty.

    The directory is made up front. The first region to enter starts the
    session, the last to leave stops it and exports its Chrome trace. A
    start that raises (a profiler already running outside this module)
    leaves the count at 0, stops any half-started session, and raises:
    a run asked to trace the device never runs untraced."""
    global _trace_refs, _trace_session, _trace_dir, _trace_count
    if not profile_dir:
        yield
        return
    os.makedirs(profile_dir, exist_ok=True)
    with _trace_lock:
        if _trace_refs == 0:
            _trace_session = _start()
            _trace_dir = profile_dir
        _trace_refs += 1
    try:
        yield
    finally:
        with _trace_lock:
            _trace_refs -= 1
            if _trace_refs == 0:
                prof, out_dir = _trace_session, _trace_dir
                _trace_session = _trace_dir = None
                _trace_count += 1
                prof.stop()
                prof.export_chrome_trace(
                    os.path.join(out_dir, f"trace-{os.getpid()}-{_trace_count}.json")
                )


class StageTimer:
    """Thread-safe accumulated wall time per named stage."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.seconds: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.seconds[name] += dt
                self.counts[name] += 1

    def summary(self) -> str:
        with self._lock:
            rows = [
                f"  {name:<12} {self.seconds[name]:8.2f}s over {self.counts[name]} calls"
                for name in sorted(self.seconds)
            ]
        return "per-stage wall time:\n" + "\n".join(rows) if rows else ""
