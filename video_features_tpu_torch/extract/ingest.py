"""Backoff timers for the pipelined loop's retries.

Counterpart of ``video_features_tpu/extract/ingest.py::RequeueTimers``
(its completion queue and group staging come with ``--video_batch``).
"""

from __future__ import annotations

import threading
from typing import Callable


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
