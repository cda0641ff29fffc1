"""Extractor supervision: watchdog-bounded group execution and a
per-feature-type circuit breaker.

Counterpart of ``video_features_tpu/serve/supervisor.py``, copied as it
is (stdlib only), with ``CircuitBreaker.trip`` and ``force_close``, the
preemptor's teardown and rollback (``serve/preemptor.py``).
:class:`DaemonStopped` is the port's own: the JAX daemon has no
process-wide sticky device error to refuse on.

A resident daemon's failure modes differ from a batch run's: a wedged
extractor (hung decode on the dispatcher thread, a device runtime that
stopped answering) blocks EVERY model's traffic, and a model that fails
every group burns device time re-failing while healthy models queue behind
it. Two small mechanisms bound both:

- :class:`Watchdog` runs each group body on a supervised worker thread
  and bounds its wall time (``--group_timeout_s``). A timed-out worker
  is *abandoned* (Python threads cannot be killed) — the group's
  requests fail ``transient``, the dispatcher moves on, and the daemon
  tears the extractor down so the abandoned thread's model state is
  never reused. ``timeout_s <= 0`` disables the thread hop entirely
  (the group runs inline on the dispatcher thread).
- :class:`CircuitBreaker`, one per feature type: ``breaker_threshold``
  consecutive group-level failures (build crash, loop crash, watchdog
  timeout — NOT per-video failures inside a healthy group) open it;
  while open, new requests for that model get 503/spool-deferral while
  every other model serves normally. After ``breaker_cooldown_s`` it
  half-opens: exactly ONE admitted group becomes the probe
  (:meth:`try_probe`), the daemon re-builds the evicted extractor and
  re-warms it through the declared ``--warmup`` pairs, and the probe's
  outcome closes or re-opens the breaker. ``/healthz`` reports every
  breaker's state.

The clock is injectable (the daemon shares its admission clock), so the
breaker tests advance time instead of sleeping. All state is
lock-guarded.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

BREAKER_STATES = ("closed", "open", "half_open")


class ModelUnavailable(RuntimeError):
    """Admission refused because this feature type's breaker is open.
    Scoped to ONE model: the HTTP source answers 503 with Retry-After,
    the spool source defers the file — other models are unaffected."""

    def __init__(
        self,
        feature_type: str,
        retry_after_s: float,
        reason: Optional[str] = None,
    ) -> None:
        super().__init__(
            reason
            or f"model {feature_type!r} unavailable (circuit breaker open); "
               f"retry in {retry_after_s:.1f}s"
        )
        self.feature_type = feature_type
        self.retry_after_s = float(retry_after_s)


class DaemonStopped(RuntimeError):
    """Admission refused for EVERY model: a sticky device error poisoned
    this process (``ServeDaemon._stop_on_sticky``). The HTTP source
    answers 503, the spool source leaves the file unclaimed for a
    healthy replica; a supervisor restarts the process."""


class GroupTimeout(TimeoutError):
    """The watchdog bound fired: the group exceeded ``group_timeout_s``
    wall time. A TimeoutError so :func:`~video_features_tpu_torch.runtime.
    faults.classify_error` files it ``transient`` — re-submitting after
    the extractor is rebuilt may well succeed."""

    stage = "dispatch"


class CircuitBreaker:
    """closed -> (K consecutive failures) -> open -> (cooldown) ->
    half_open -> one probe -> closed | open. Failure/success here means
    GROUP-level outcome; per-video failures inside a completed group
    never touch the breaker."""

    def __init__(
        self,
        threshold: int = 3,
        cooldown_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.threshold = max(int(threshold), 1)
        self.cooldown_s = max(float(cooldown_s), 0.0)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0  # consecutive group-level failures
        self._opened_at = 0.0
        self._probing = False
        self._opens = 0  # lifetime count, for /healthz trend reading

    def _state_locked(self, now: float) -> str:
        if self._state == "open" and now - self._opened_at >= self.cooldown_s:
            self._state = "half_open"
        return self._state

    def state(self) -> str:
        with self._lock:
            return self._state_locked(self._clock())

    def allow_request(self) -> bool:
        """Admission gate: closed always admits; half-open admits until
        a probe is in flight (the admitted request BECOMES the probe at
        dispatch); open admits nothing."""
        with self._lock:
            st = self._state_locked(self._clock())
            return st == "closed" or (st == "half_open" and not self._probing)

    def retry_after_s(self) -> float:
        with self._lock:
            now = self._clock()
            if self._state_locked(now) != "open":
                return 0.0
            return max(self._opened_at + self.cooldown_s - now, 0.0)

    def try_probe(self) -> bool:
        """Claim the single half-open probe slot; the caller's group is
        the probe and MUST report back via record_success/failure."""
        with self._lock:
            if self._state_locked(self._clock()) == "half_open" and not self._probing:
                self._probing = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._state = "closed"
            self._failures = 0
            self._probing = False

    def record_ignored(self) -> None:
        """A group outcome that must not move the breaker either way:
        input-classified crashes (corrupt media, resource caps) say
        nothing about model health. In half-open this releases the
        probe slot WITHOUT a verdict — the hostile input consumed the
        probe group, so the next admitted group re-probes; the breaker
        stays half-open rather than closing on unproven hardware or
        re-opening on bad traffic. No-op when closed (the consecutive-
        failure counter is neither advanced nor reset: an input error
        between two real infra failures must not mask the streak, and
        ignoring it is exactly the point)."""
        with self._lock:
            self._probing = False

    def trip(self) -> None:
        """Force-open the breaker (HBM-aware preemption): the preemptor
        evicts a victim extractor to make room for a burst and trips its
        breaker so the victim's traffic defers (503 / spool backoff)
        instead of racing an immediate rebuild into the memory it just
        freed. The re-warm rides the normal cooldown -> half-open ->
        probe path, so recovery is observable in /healthz exactly like a
        failure-opened breaker."""
        with self._lock:
            self._state = "open"
            self._opened_at = self._clock()
            self._probing = False
            self._opens += 1

    def force_close(self) -> None:
        """Roll the breaker back to closed (preemption rollback: the
        beneficiary's build failed, so the victim should serve again
        without waiting out a cooldown it did nothing to deserve)."""
        with self._lock:
            self._state = "closed"
            self._failures = 0
            self._probing = False

    def record_failure(self) -> bool:
        """One group-level failure. Returns True when this failure
        (re)opened the breaker — the daemon's cue to tear the resident
        extractor down."""
        with self._lock:
            now = self._clock()
            st = self._state_locked(now)
            self._failures += 1
            if st == "half_open" or self._failures >= self.threshold:
                self._state = "open"
                self._opened_at = now
                self._probing = False
                self._opens += 1
                return True
            return False

    def snapshot(self) -> Dict[str, Any]:
        """The /healthz block for this model."""
        with self._lock:
            now = self._clock()
            st = self._state_locked(now)
            out: Dict[str, Any] = {
                "state": st,
                "consecutive_failures": self._failures,
                "opens": self._opens,
            }
            if st == "open":
                out["retry_after_s"] = round(
                    max(self._opened_at + self.cooldown_s - now, 0.0), 3
                )
            return out


class Watchdog:
    """Bounds one group's extraction wall time by running the group body
    on a fresh supervised worker thread and joining with a timeout.

    On timeout the worker is abandoned, never joined — it may still be
    blocked in a hung decode or device call; the daemon evicts the
    extractor it was using so nothing shares state with it — and
    :class:`GroupTimeout` is raised on the dispatcher thread. A fresh
    thread per group keeps this allocation-trivial next to extraction
    itself and means a wedged worker can never poison the next group."""

    def __init__(self, timeout_s: float = 0.0) -> None:
        self.timeout_s = float(timeout_s)
        self._lock = threading.Lock()
        self._timeouts = 0  # lifetime count, surfaced in /healthz

    def timeouts(self) -> int:
        with self._lock:
            return self._timeouts

    def run(self, fn: Callable[[], Any]) -> Any:
        if self.timeout_s <= 0:
            return fn()  # unbounded: inline on the caller's thread
        box: Dict[str, Any] = {}
        done = threading.Event()

        def body() -> None:
            try:
                box["result"] = fn()
            except BaseException as exc:  # noqa: BLE001 - re-raised on the dispatcher
                box["exc"] = exc
            finally:
                done.set()

        worker = threading.Thread(target=body, name="serve-group", daemon=True)
        worker.start()
        if not done.wait(self.timeout_s):
            with self._lock:
                self._timeouts += 1
            raise GroupTimeout(
                f"group exceeded group_timeout_s={self.timeout_s:g}s; "
                "worker abandoned, extractor will be rebuilt"
            )
        exc = box.get("exc")
        if exc is not None:
            raise exc
        return box.get("result")
