"""Spool-directory request source: the air-gapped twin of the HTTP door.

Counterpart of ``video_features_tpu/serve/sources.py``, copied as it is
(stdlib only), leases and work stealing included.

Protocol: a producer writes a request as
``<spool>/<name>.json`` — atomically, via write-to-temp + rename into
the directory, exactly like the sinks in io/ — with the same schema as
the HTTP body (including the multi-model ``feature_types`` LIST form:
one decode fanned out to several models; a re-polled fan-out file only
admits the members the previous attempt could not, the rest resolve as
duplicates of already-tracked sub-requests). Scheduling hints can ride in the payload
(``priority``/``deadline_ms``) or, for producers that only control the
filename, in the name itself: ``<base>.pN.json`` sets priority N and
``<base>.dMS.json`` sets deadline_ms MS (combined: ``clip.p7.d500.json``
— payload fields win over filename hints). The watcher polls
(``--spool_poll_s``), claims a file by renaming it to
``<name>.json.claim.<replica_id>`` (rename is the mutual exclusion: two
watchers on one spool can race a file, only one rename wins), then
submits it:

- admitted       -> claimed file is deleted; track via the result JSON
                    under ``<output>/_requests/<id>.json``
- malformed      -> renamed to ``<name>.json.bad`` with a ``.why`` file
                    (and, when the payload named an id, a rejected
                    lifecycle record) — poison files must leave the
                    scan path or they re-fail every poll
- queue full /   -> the claim is renamed BACK to ``<name>.json``: the
  breaker open      file system is the retry queue, which is the whole
                    point of a spool. The un-claimed file is then
                    *deferred* with jittered exponential backoff
                    (:func:`~video_features_tpu_torch.runtime.faults.
                    backoff_delay`) so a full queue or an open breaker
                    never turns the poll into a tight claim/rename spin.
- daemon stopped -> (a sticky device error; the port's own) the claim is
                    renamed back and the pass ends; the daemon has
                    already stopped this watcher, so the file waits for
                    a healthy replica.

Cancellation: dropping ``<id>.cancel`` into the spool cancels request
``<id>`` — an unclaimed ``<id>.json`` is deleted before it is ever
admitted; otherwise the cancel routes through ``daemon.cancel`` exactly
like ``DELETE /v1/requests/<id>``. The ``.cancel`` file is consumed
once handled.

Fleet mode (``--lease_timeout_s > 0``): the claim file is a
*lease* — it stays on disk until every request it admitted is terminal,
its mtime refreshed every poll as the heartbeat. A replica that dies
(SIGKILL — no cleanup) leaves stale leases; surviving watchers check the
owner's :class:`~video_features_tpu_torch.serve.lifecycle.ReplicaRegistry`
heartbeat and, once both heartbeats are stale, rename the claim back to
``<name>.json`` so the request re-enters the scan path (work stealing).
Steals prefer warm replicas: a claim on a model the stealing replica
does not have resident waits ``COLD_STEAL_FACTOR`` × longer, so a peer
with the executable already warm usually wins the reclaim race.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional

from video_features_tpu_torch.runtime import faults as faults_mod
from video_features_tpu_torch.serve.batcher import QueueFull
from video_features_tpu_torch.serve.lifecycle import (
    TERMINAL_STATES,
    BadRequest,
    DuplicateRequest,
)
from video_features_tpu_torch.serve.supervisor import DaemonStopped, ModelUnavailable

# a deferred file is retried after at most this long no matter how many
# times it has been deferred — backpressure is expected to clear
MAX_DEFER_S = 30.0

# a stale claim on a model this replica does NOT have warm waits this
# multiple of the lease timeout before being stolen — the affinity
# grace window in which a warm peer gets first crack at the reclaim
COLD_STEAL_FACTOR = 1.5

# filename scheduling hints: trailing .pN / .dMS segments before .json
_NAME_HINT_RE = re.compile(r"\.(p([0-9])|d([0-9]{1,9}))$")


def parse_spool_name(name: str) -> Dict[str, Any]:
    """Extract ``priority``/``deadline_ms`` hints from a spool filename
    (without its ``.json`` suffix). Unrecognized segments are simply part
    of the request name — this never raises."""
    hints: Dict[str, Any] = {}
    base = name
    while True:
        m = _NAME_HINT_RE.search(base)
        if m is None:
            return hints
        if m.group(2) is not None:
            hints.setdefault("priority", int(m.group(2)))
        else:
            hints.setdefault("deadline_ms", float(m.group(3)))
        base = base[: m.start()]


class SpoolWatcher:
    """Polls a spool directory and feeds ``daemon.submit``. One thread;
    start()/stop(); a single :meth:`poll_once` pass is the deterministic
    unit the tests drive directly (with an injectable clock, so deferral
    backoff is tested without sleeping)."""

    def __init__(
        self,
        daemon: Any,
        spool_dir: str,
        poll_s: float = 0.5,
        clock: Callable[[], float] = time.monotonic,
        replica_id: Optional[str] = None,
        lease_timeout_s: float = 0.0,
        registry: Any = None,
    ) -> None:
        self.daemon = daemon
        self.spool_dir = spool_dir
        self.poll_s = max(float(poll_s), 0.01)
        self._clock = clock
        # fleet identity: claims are per-replica lease files
        # <name>.json.claim.<replica>; lease_timeout_s > 0 turns on the
        # steal protocol (hold the claim until the request is terminal,
        # heartbeat its mtime each poll, reclaim peers' stale claims).
        # At 0 the claim is still replica-suffixed but deleted right
        # after admission — the single-replica behavior.
        self.replica_id = str(replica_id) if replica_id else f"r{os.getpid()}"
        self.lease_timeout_s = max(float(lease_timeout_s), 0.0)
        self.registry = registry  # lifecycle.ReplicaRegistry or None
        os.makedirs(spool_dir, exist_ok=True)
        # name -> (attempts, retry_at): files bounced by backpressure
        # (queue full / breaker open) are skipped until retry_at — the
        # jittered re-scan backoff that replaces the old tight spin
        self._deferred: Dict[str, Any] = {}
        # claim path -> request ids it covers; the lease is released
        # (claim unlinked) once every covered request is terminal
        self._inflight: Dict[str, Any] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread = threading.Thread(
            target=self._loop, name="serve-spool", daemon=True
        )

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 - the watcher must outlive one bad pass
                traceback.print_exc()
            self._stop.wait(self.poll_s)

    def _defer(self, name: str, path: str, claimed: str) -> None:
        """Un-claim and schedule the next attempt: exponential in this
        file's bounce count, deterministically jittered by name so a
        burst of deferred files does not re-arrive in lockstep."""
        try:
            os.replace(claimed, path)  # un-claim: spool = retry queue
        except OSError:
            pass
        attempts = int(self._deferred.get(name, (0, 0.0))[0]) + 1
        delay = min(
            faults_mod.backoff_delay(attempts, base=self.poll_s, key=name),
            MAX_DEFER_S,
        )
        self._deferred[name] = (attempts, self._clock() + delay)

    def poll_once(self) -> int:
        """One scan pass; returns how many files were admitted.
        ``.cancel`` files are handled first (a cancel racing its request
        in one scan must win); deferred files are skipped until their
        backoff expires; with leases on, held leases are heartbeat and
        peers' stale claims reclaimed before the scan."""
        try:
            # the chaos drill's kill point: --fault_inject
            # replica_kill:kill:N SIGKILLs this replica mid-poll (no
            # cleanup, no flush); any other kind here is a no-op
            faults_mod.fire("replica_kill")
        except Exception:  # noqa: BLE001 - only the kill kind is meaningful
            pass
        if self.registry is not None:
            self.registry.beat()
        self._lease_pass()
        try:
            names = sorted(os.listdir(self.spool_dir))
        except OSError:
            return 0
        now = self._clock()
        admitted = 0
        for name in names:
            if name.endswith(".cancel"):
                self._handle_cancel(name)
        for name in names:
            if not name.endswith(".json"):
                continue
            entry = self._deferred.get(name)
            if entry is not None and now < entry[1]:
                continue
            path = os.path.join(self.spool_dir, name)
            claimed = f"{path}.claim.{self.replica_id}"
            try:
                os.rename(path, claimed)  # the claim; losing the race is fine
            except OSError:
                continue
            try:
                with open(claimed, "r", encoding="utf-8") as fh:
                    payload = json.load(fh)
                if isinstance(payload, dict):
                    for k, v in parse_spool_name(name[: -len(".json")]).items():
                        payload.setdefault(k, v)
                rec = self.daemon.submit(payload, source="spool")
            except (QueueFull, DaemonStopped):
                # the whole queue is full, or a sticky device error stopped
                # the daemon (the file is left for a healthy replica): end
                # the pass
                self._defer(name, path, claimed)
                return admitted
            except ModelUnavailable:
                # one model's breaker is open; other files may still be
                # admissible, so defer this one and keep scanning
                self._defer(name, path, claimed)
            except DuplicateRequest:
                # already tracked live here (lease steal / reconcile
                # requeue race): this file is the losing copy — drop it,
                # the tracked request owns the outcome
                self._deferred.pop(name, None)
                self._unlink(claimed)
            except (ValueError, BadRequest) as exc:
                self._deferred.pop(name, None)
                self._quarantine(claimed, name, exc)
            else:
                admitted += 1
                self._deferred.pop(name, None)
                if self.lease_timeout_s > 0:
                    # the claim file IS the lease: held (mtime-heartbeat)
                    # until every covered request is terminal, so a
                    # SIGKILLed replica leaves a reclaimable stale lease
                    self._inflight[claimed] = self._request_ids(rec)
                else:
                    self._unlink(claimed)
        return admitted

    # -- lease protocol --------------------------------------

    @staticmethod
    def _request_ids(rec: Any) -> list:
        """Request ids covered by one admission record (a fan-out record
        covers one sub-request per model)."""
        if isinstance(rec, dict):
            if rec.get("fanout"):
                return [r.get("id") for r in rec.get("requests", {}).values()
                        if isinstance(r, dict) and r.get("id")]
            if rec.get("id"):
                return [rec["id"]]
        return []

    def _terminal(self, rid: str) -> bool:
        """A request unknown to the tracker counts as terminal — it was
        finished and swept by retention; holding its lease forever would
        block the file from ever being garbage-collected."""
        get = getattr(getattr(self.daemon, "tracker", None), "get", None)
        if get is None:
            return True
        rec = get(rid)
        return rec is None or rec.get("state") in TERMINAL_STATES

    def _lease_pass(self) -> None:
        """Release finished leases, heartbeat live ones, and reclaim
        peers' stale claims. ``lease_stall`` chaos stage: an injected
        raise skips THIS replica's heartbeat refresh (the replica is
        alive but wedged), so peers see its leases age out — the steal
        path is exercised without killing anyone."""
        if self.lease_timeout_s <= 0:
            return
        stalled = False
        try:
            faults_mod.fire("lease_stall")
        except Exception:  # noqa: BLE001 - any injected kind means 'stall'
            stalled = True
        for claim, rids in list(self._inflight.items()):
            if all(self._terminal(r) for r in rids):
                self._inflight.pop(claim, None)
                self._unlink(claim)
            elif not stalled:
                try:
                    os.utime(claim)
                except OSError:
                    # the claim was stolen out from under us (our own
                    # heartbeat stalled long enough): the thief owns the
                    # requests now, stop renewing
                    self._inflight.pop(claim, None)
        self._reclaim_stale()

    def _warm_feature_types(self) -> set:
        pool = getattr(self.daemon, "pool", None)
        try:
            return set(pool.feature_types()) if pool is not None else set()
        except Exception:  # noqa: BLE001 - affinity is advisory only
            return set()

    def _reclaim_stale(self) -> None:
        """Steal dead peers' claims: a ``<name>.json.claim.<other>``
        whose owner has no fresh registry heartbeat AND whose own mtime
        heartbeat is stale is renamed back to ``<name>.json``, putting
        the request back in the scan path. Affinity: a claim on a model
        this replica has warm is stolen at ``lease_timeout_s``; a cold
        one waits ``COLD_STEAL_FACTOR`` longer, giving warm peers first
        crack. mtimes are wall-clock — the one clock replicas share."""
        try:
            names = os.listdir(self.spool_dir)
        except OSError:
            return
        marker = ".json.claim."
        live = None
        if self.registry is not None:
            live = self.registry.live(self.lease_timeout_s)
        warm = self._warm_feature_types()
        now = time.time()
        for name in names:
            i = name.rfind(marker)
            if i < 0:
                continue
            owner = name[i + len(marker):]
            if not owner or owner == self.replica_id:
                continue
            if live is not None and owner in live:
                continue  # the owner replica is alive; its lease stands
            claim = os.path.join(self.spool_dir, name)
            try:
                age = now - os.stat(claim).st_mtime
            except OSError:
                continue
            threshold = self.lease_timeout_s
            ft = self._claim_feature_type(claim)
            if ft is not None and warm and ft not in warm:
                threshold *= COLD_STEAL_FACTOR
            if age <= threshold:
                continue
            original = os.path.join(self.spool_dir, name[: i + len(".json")])
            try:
                os.rename(claim, original)
            except OSError:
                continue  # a peer won the steal race; fine
            self._steal_telemetry(owner, ft, name[: i + len(".json")])

    @staticmethod
    def _claim_feature_type(claim: str) -> Optional[str]:
        try:
            with open(claim, "r", encoding="utf-8") as fh:
                payload = json.load(fh)
            if isinstance(payload, dict):
                ft = payload.get("feature_type")
                if isinstance(ft, str):
                    return ft
                fts = payload.get("feature_types")
                if isinstance(fts, list) and fts and isinstance(fts[0], str):
                    return fts[0]
        except (OSError, ValueError):
            pass
        return None

    def _steal_telemetry(self, owner: str, ft: Optional[str], name: str) -> None:
        telemetry = getattr(self.daemon, "telemetry", None)
        if telemetry is not None and getattr(telemetry, "enabled", False):
            telemetry.metrics.inc("lease_expired")
            telemetry.metrics.inc(f"lease_steals.{ft or 'unknown'}")
        manifest = getattr(getattr(self.daemon, "tracker", None), "manifest", None)
        if manifest is not None:
            manifest.event(
                "lease_stolen", file=name, from_replica=owner,
                by_replica=self.replica_id, feature_type=ft,
            )

    @staticmethod
    def _unlink(path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass

    def _handle_cancel(self, name: str) -> None:
        """``<id>.cancel``: delete the matching unclaimed ``<id>.json``
        if it is still here (cancelled before admission — terminal
        record included), else route through ``daemon.cancel``. The
        ``.cancel`` file is consumed either way."""
        rid = name[: -len(".cancel")]
        cancel_path = os.path.join(self.spool_dir, name)
        spooled = os.path.join(self.spool_dir, f"{rid}.json")
        try:
            os.unlink(spooled)
        except OSError:
            rec = self.daemon.cancel(rid)
            if rec is None:
                print(f"serve: spool cancel for unknown request {rid!r}")
        else:
            self._deferred.pop(f"{rid}.json", None)
            from video_features_tpu_torch.serve.lifecycle import ExtractionRequest

            self.daemon.tracker.finish(
                ExtractionRequest(
                    feature_type="", video_path="", id=rid, source="spool"
                ),
                "cancelled", error_class="cancelled",
                message="cancelled in spool before admission",
            )
        try:
            os.unlink(cancel_path)
        except OSError:
            pass

    def _quarantine(self, claimed: str, name: str, exc: Exception) -> None:
        bad = os.path.join(self.spool_dir, name + ".bad")
        why_tmp = bad + ".why.tmp"
        try:
            os.replace(claimed, bad)
            # staged like every durable publish: the .why sidecar
            # is what an operator reads to triage, so it must never be torn
            with open(why_tmp, "w", encoding="utf-8") as fh:
                fh.write(f"{type(exc).__name__}: {exc}\n")
            os.replace(why_tmp, bad + ".why")
        except OSError:
            pass
        print(f"serve: spool file {name} rejected: {exc}")
