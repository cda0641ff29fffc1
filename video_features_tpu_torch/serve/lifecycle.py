"""Request lifecycle: the manifest-backed record every serve request gets.

Counterpart of ``video_features_tpu/serve/lifecycle.py``, copied as it
is (stdlib only): the records under ``<output>/_requests/`` are the JAX
package's, so either package's tracker reads the other's.

A batch run's unit of record is the video (runtime/faults.py manifest);
the daemon's unit of record is the *request* — same video, different
identity: two users asking for the same clip are two requests, and each
one must end in a queryable terminal state. States:

    queued -> dispatched -> done | failed
    queued -> rejected                (backpressure / bad input / breaker)
    queued -> expired                 (deadline passed before dispatch)
    queued | dispatched -> cancelled  (DELETE /v1/requests/<id>, .cancel)

Every transition is appended to a :class:`~video_features_tpu_torch.runtime.
faults.RunManifest` rooted at ``<output>/_requests`` (so the extraction
manifest under ``<output>/_manifest`` stays purely per-video), and the
terminal state is additionally written as ``<output>/_requests/<id>.json``
— the durable per-request result record the status endpoint serves after
the in-memory map forgets (daemon restart). Failure records reuse the
``classify_error`` taxonomy from runtime/faults.py, so a request that
died of a transient decode flake reads exactly like the batch manifest
would read it.

Everything here runs on source/HTTP threads.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from video_features_tpu_torch.io.sink import atomic_write_json
from video_features_tpu_torch.runtime import faults as faults_mod
from video_features_tpu_torch.runtime.faults import RunManifest

REQUESTS_DIRNAME = "_requests"

# queued/dispatched are transitional; done/failed/rejected/expired/
# cancelled are terminal (merge_manifest treats all five as terminal
# when folding the request manifest, so a restart never resurrects a
# rejected/expired/cancelled request as live). 'deferred' and 'requeued'
# are manifest-only notes: the request left THIS process but its spool
# file is the durable copy that re-submits it.
REQUEST_STATES = (
    "queued", "dispatched", "done", "failed", "rejected", "expired", "cancelled",
)
TERMINAL_STATES = ("done", "failed", "rejected", "expired", "cancelled")

# non-terminal manifest statuses that need NO reconciliation after a
# crash: the spool file still exists and re-submits the request itself
_SPOOL_SAFE_STATES = ("deferred", "requeued")

# request ids become result filenames: constrain them so a hostile id
# can never traverse out of _requests/ (the HTTP source accepts ids)
_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,99}$")

# the admission key's catch-all bucket for requests that do not declare
# one: they still coalesce with each other (the extractor's own agg_key
# keeps truly mixed shapes out of one fused dispatch)
DEFAULT_BUCKET = "~"


class BadRequest(ValueError):
    """Malformed request payload (unknown feature type, missing path,
    unsafe id). Permanent by nature: re-sending the same bytes fails
    the same way."""


class DuplicateRequest(BadRequest):
    """A request id that is already tracked live in THIS process. Still
    a 400 for HTTP callers (it subclasses :class:`BadRequest`), but the
    spool source treats it as benign — after a lease steal or a
    reconcile requeue the same request can briefly exist as two spool
    files, and the loser must be dropped, not quarantined."""


class InvalidMedia(BadRequest):
    """The request was well-formed but its media failed the preflight
    probe (io/probe.py): HTTP callers get 422 ``invalid_media`` with the
    probe's reason, spool files quarantine via ``.bad``+``.why``, and —
    unlike a plain BadRequest — the request had an identity, so a
    durable ``rejected`` record is written before this is raised.
    Permanent, input-classified: never a breaker tick, never a retry."""

    def __init__(self, reason: str, record: Optional[Dict[str, Any]] = None):
        super().__init__(reason)
        self.reason = reason
        self.record = record or {}


@dataclasses.dataclass
class ExtractionRequest:
    """One admitted unit of work. ``bucket`` is the client's spatial-
    bucket hint — the coalescing half of the admission key; the fused
    dispatch itself is still guarded by the extractor's ``agg_key``, so
    a wrong hint costs batching efficiency, never correctness."""

    feature_type: str
    video_path: str
    id: str = dataclasses.field(default_factory=lambda: uuid.uuid4().hex[:12])
    bucket: str = DEFAULT_BUCKET
    source: str = "local"  # http | spool | warmup | local
    received_ts: float = dataclasses.field(default_factory=time.time)
    # scheduling hints: tier 0..9 (higher = more urgent) and a
    # latency budget in ms from admission; the batcher stamps the
    # absolute admitted_at/deadline_at on ITS clock at admit time, so
    # the fake-clock tests and the EDF ranks share one time base
    priority: int = 0
    deadline_ms: Optional[float] = None
    admitted_at: Optional[float] = None
    deadline_at: Optional[float] = None

    def key(self) -> Tuple[str, str]:
        """The admission-control key: same-(feature_type, bucket)
        requests may coalesce into one fused --video_batch group."""
        return (self.feature_type, self.bucket)


def parse_request(payload: Dict[str, Any], source: str) -> ExtractionRequest:
    """Validate one request dict (HTTP body or spool file) into an
    :class:`ExtractionRequest`; raises :class:`BadRequest` naming the
    problem (the sources turn that into 400 / a rejected record)."""
    if not isinstance(payload, dict):
        raise BadRequest(f"request body must be a JSON object, got {type(payload).__name__}")
    ft = payload.get("feature_type")
    if not ft or not isinstance(ft, str):
        raise BadRequest("missing 'feature_type'")
    video = payload.get("video_path")
    if not video or not isinstance(video, str):
        raise BadRequest("missing 'video_path'")
    kw: Dict[str, Any] = {"feature_type": ft, "video_path": video, "source": source}
    rid = payload.get("id")
    if rid is not None:
        if not isinstance(rid, str) or not _ID_RE.match(rid):
            raise BadRequest(
                "bad 'id': need 1-100 chars of [A-Za-z0-9._-] starting alphanumeric"
            )
        kw["id"] = rid
    bucket = payload.get("bucket")
    if bucket is not None:
        if not isinstance(bucket, str) or len(bucket) > 32:
            raise BadRequest("bad 'bucket': expected a short string like '640x480'")
        kw["bucket"] = bucket
    priority = payload.get("priority")
    if priority is not None:
        if isinstance(priority, bool) or not isinstance(priority, int) \
                or not 0 <= priority <= 9:
            raise BadRequest(
                "bad 'priority': expected an integer 0..9 (higher = more urgent)"
            )
        kw["priority"] = priority
    deadline_ms = payload.get("deadline_ms")
    if deadline_ms is not None:
        if isinstance(deadline_ms, bool) or not isinstance(deadline_ms, (int, float)) \
                or not 0 < float(deadline_ms) <= 7 * 24 * 3600 * 1000:
            raise BadRequest(
                "bad 'deadline_ms': expected a positive number of milliseconds "
                "(latency budget from admission)"
            )
        kw["deadline_ms"] = float(deadline_ms)
    return ExtractionRequest(**kw)


def requests_root(output_root: str) -> str:
    return os.path.join(output_root, REQUESTS_DIRNAME)


REPLICAS_DIRNAME = "_replicas"


class ReplicaRegistry:
    """Fleet membership over the shared output store: each
    serve replica periodically touches ``_requests/_replicas/<id>.json``;
    liveness is heartbeat-file mtime, on the WALL clock — the one clock
    N processes on a shared filesystem actually share. Survivors use
    :meth:`live` to decide which dead replicas' in-flight requests to
    reclaim (``RequestTracker.reconcile``) and which spool leases are
    stale (``SpoolWatcher``). Tests fake staleness with ``os.utime``."""

    def __init__(self, output_root: str, replica_id: str) -> None:
        self.dir = os.path.join(requests_root(output_root), REPLICAS_DIRNAME)
        self.replica_id = str(replica_id)
        self.path = os.path.join(self.dir, f"{self.replica_id}.json")

    def beat(self) -> None:
        """Refresh this replica's heartbeat (tmp + rename: a reader never
        sees a torn file, and the rename refreshes mtime atomically)."""
        try:
            atomic_write_json(
                self.path,
                {"replica": self.replica_id, "pid": os.getpid(),
                 "ts": round(time.time(), 3)},
            )
        except OSError:
            pass  # a missed beat is survivable; a crashed beat is not

    def retire(self) -> None:
        """Clean shutdown: drop the heartbeat so survivors reclaim this
        replica's leases immediately instead of after a timeout."""
        try:
            os.unlink(self.path)
        except OSError:
            pass

    def ages(self, now: Optional[float] = None) -> Dict[str, float]:
        """``{replica_id: heartbeat age in seconds}`` for every replica
        with a heartbeat file (including this one)."""
        now = time.time() if now is None else now
        out: Dict[str, float] = {}
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for name in names:
            if not name.endswith(".json"):
                continue
            try:
                mtime = os.stat(os.path.join(self.dir, name)).st_mtime
            except OSError:
                continue
            out[name[: -len(".json")]] = max(now - mtime, 0.0)
        return out

    def live(self, timeout_s: float, now: Optional[float] = None) -> set:
        """Replica ids whose heartbeat is fresher than ``timeout_s``.
        ``timeout_s <= 0`` means liveness is never inferred: everyone
        with a heartbeat file counts as live (steal protocol disabled)."""
        ages = self.ages(now)
        if timeout_s <= 0:
            return set(ages)
        return {rid for rid, age in ages.items() if age <= timeout_s}


class RequestTracker:
    """Thread-safe request registry + the manifest/result-file writers.

    Sources admit from their own threads, the batcher's dispatcher
    transitions from its thread, and the status endpoint reads from HTTP
    handler threads — one lock covers the in-memory map; the manifest
    has its own (runtime/faults.py)."""

    def __init__(
        self,
        output_root: str,
        telemetry: Any = None,
        slo: Any = None,
        clock: Any = time.monotonic,
        replica_id: Optional[str] = None,
    ) -> None:
        self.output_root = output_root
        self.results_dir = requests_root(output_root)
        self.manifest = RunManifest(self.results_dir)
        # fleet attribution: every manifest line this tracker
        # writes carries replica=<id>, so a survivor's reconcile can tell
        # a DEAD replica's in-flight requests from a live peer's
        self.replica_id = replica_id
        self.telemetry = telemetry
        # the daemon's SloTracker (runtime/telemetry.py) and its
        # scheduling clock: latency/queue-wait samples are measured on
        # the same (injectable) clock the batcher stamps admitted_at/
        # deadline_at with, so fake-clock tests and EDF ranks agree
        self.slo = slo
        self._clock = clock
        self._lock = threading.Lock()
        self._records: Dict[str, Dict[str, Any]] = {}
        self._spans: Dict[str, Any] = {}  # request id -> open telemetry token
        self._qspans: Dict[str, Any] = {}  # request id -> open queue_wait token

    # -- transitions ----------------------------------------------------

    def admit(self, req: ExtractionRequest) -> Dict[str, Any]:
        rec = {
            "id": req.id,
            "state": "queued",
            "feature_type": req.feature_type,
            "video_path": req.video_path,
            "bucket": req.bucket,
            "source": req.source,
            "received_ts": round(req.received_ts, 4),
        }
        if req.priority:
            rec["priority"] = int(req.priority)
        if req.deadline_ms is not None:
            rec["deadline_ms"] = float(req.deadline_ms)
        with self._lock:
            if req.id in self._records:
                raise DuplicateRequest(f"duplicate request id {req.id!r}")
            self._records[req.id] = rec
        self._count("requests_admitted")
        if self.telemetry is not None and self.telemetry.enabled:
            token = self.telemetry.begin(
                "request", video=req.video_path, request=req.id,
                feature_type=req.feature_type, bucket=req.bucket,
            )
            if token is not None:
                # the queue_wait child measures admission -> group
                # dispatch (closed in dispatched(), or at the terminal
                # transition for requests that never dispatch); explicit
                # parent= pins it under the request span regardless of
                # what is on the opener thread's span stack
                qtoken = self.telemetry.begin(
                    "queue_wait", video=req.video_path, request=req.id,
                    feature_type=req.feature_type, bucket=req.bucket,
                    parent=token.span_id,
                )
                with self._lock:
                    self._spans[req.id] = token
                    if qtoken is not None:
                        self._qspans[req.id] = qtoken
        # the queued record carries the full resubmittable payload: it
        # is what reconcile() rebuilds a request from after a crash
        extra: Dict[str, Any] = {}
        if req.priority:
            extra["priority"] = int(req.priority)
        if req.deadline_ms is not None:
            extra["deadline_ms"] = float(req.deadline_ms)
        self._record(
            f"request:{req.id}", "queued",
            feature_type=req.feature_type, video_path=req.video_path,
            bucket=req.bucket, source=req.source, **extra,
        )
        return dict(rec)

    def dispatched(self, req: ExtractionRequest, group_size: int) -> None:
        queue_wait = None
        if req.admitted_at is not None:
            queue_wait = max(self._clock() - req.admitted_at, 0.0)
        with self._lock:
            rec = self._records.get(req.id)
            if rec is not None:
                rec["state"] = "dispatched"
                rec["group_size"] = int(group_size)
                if queue_wait is not None:
                    rec["queue_wait_s"] = round(queue_wait, 4)
            qtoken = self._qspans.pop(req.id, None)
        if qtoken is not None:
            qtoken.finish(group_size=int(group_size))
        self._record(
            f"request:{req.id}", "dispatched", group_size=int(group_size)
        )

    def finish(
        self,
        req: ExtractionRequest,
        status: str,
        error_class: Optional[str] = None,
        error_type: Optional[str] = None,
        message: Optional[str] = None,
        features: Optional[List[str]] = None,
    ) -> Dict[str, Any]:
        """Terminal transition (done/failed/rejected): update the map,
        append the manifest record, write the durable result JSON,
        close the request telemetry span, and fold the SLO sample
        (latency, queue wait, deadline miss) into the daemon's
        rolling-window tracker."""
        assert status in TERMINAL_STATES, status
        now_mono = self._clock()
        # a deadline is missed when the request was supposed to finish
        # (ran or expired) and its budget had passed by the terminal
        # transition; cancellations/rejections are not missed promises
        missed = status == "expired" or (
            status in ("done", "failed")
            and req.deadline_at is not None
            and now_mono > req.deadline_at
        )
        with self._lock:
            rec = self._records.get(req.id)
            if rec is None:
                rec = {"id": req.id, "video_path": req.video_path,
                       "feature_type": req.feature_type, "bucket": req.bucket}
                self._records[req.id] = rec
            rec["state"] = status
            rec["finished_ts"] = round(time.time(), 4)
            rec["wall_s"] = round(rec["finished_ts"] - rec.get("received_ts", rec["finished_ts"]), 4)
            if missed:
                rec["deadline_missed"] = True
            if error_class is not None:
                rec["error_class"] = error_class
            if error_type is not None:
                rec["error_type"] = error_type
            if message is not None:
                rec["message"] = str(message)[:500]
            if features is not None:
                rec["features"] = list(features)
            out = dict(rec)
            token = self._spans.pop(req.id, None)
            qtoken = self._qspans.pop(req.id, None)
        if qtoken is not None:
            # never dispatched (expired/cancelled/rejected while queued):
            # the queue_wait interval ends at the terminal transition
            qtoken.finish(state=status)
        if token is not None:
            token.finish(state=status)
        self._count(f"requests_{status}")
        if missed:
            self._count("deadline_missed")
        if self.slo is not None:
            latency = (
                now_mono - req.admitted_at if req.admitted_at is not None
                else out["wall_s"]
            )
            self.slo.record(
                status,
                latency_s=max(float(latency), 0.0),
                queue_wait_s=out.get("queue_wait_s"),
                priority=int(req.priority or 0),
                deadline_missed=missed,
            )
        extra = {
            k: out[k]
            for k in ("error_class", "error_type", "message", "wall_s")
            if k in out
        }
        self._record(f"request:{req.id}", status, **extra)
        try:
            self._write_result(out)
        except OSError as exc:
            # degraded durability, not a lost outcome: the manifest line
            # above already landed, the in-memory record still answers
            # queries, and the event makes the gap auditable
            self.manifest.event(
                "result_write_failed", request=req.id,
                error_type=type(exc).__name__, message=str(exc)[:200],
            )
        return out

    def forget(self, req: ExtractionRequest) -> None:
        """Back out an admit that never reached the queue (spool
        backpressure): the spool file stays on disk and will be
        re-submitted later under the SAME id, so no live record may
        linger to collide with it. The append-only manifest keeps the
        'queued' line and gains a non-terminal 'deferred' one — a later
        re-admit simply re-records."""
        with self._lock:
            self._records.pop(req.id, None)
            token = self._spans.pop(req.id, None)
            qtoken = self._qspans.pop(req.id, None)
        if qtoken is not None:
            qtoken.finish(state="deferred")
        if token is not None:
            token.finish(state="deferred")
        self._count("requests_deferred")
        self._record(f"request:{req.id}", "deferred")

    def reject(self, req: ExtractionRequest, reason: str) -> Dict[str, Any]:
        """Backpressure / bad-input terminal state: the request never
        reached the admission queue."""
        return self.finish(
            req, "rejected", error_class="rejected", message=reason
        )

    def requeue(self, req: ExtractionRequest, spool_dir: str) -> None:
        """Durably re-queue a spool-sourced request that this process
        cannot finish (shutdown with an undrained backlog, or crash
        recovery): write its payload back into the spool — atomically,
        like any producer — so the next daemon re-admits it under the
        same id, then drop the live record. The manifest gains a
        'requeued' line: non-terminal by design, because the spool file
        is now the durable owner of the request."""
        payload: Dict[str, Any] = {
            "feature_type": req.feature_type,
            "video_path": req.video_path,
            "id": req.id,
        }
        if req.bucket != DEFAULT_BUCKET:
            payload["bucket"] = req.bucket
        if req.priority:
            payload["priority"] = int(req.priority)
        if req.deadline_ms is not None:
            # the latency budget restarts on re-admission: a requeued
            # request gets a fresh window, not an instant expiry
            payload["deadline_ms"] = float(req.deadline_ms)
        atomic_write_json(os.path.join(spool_dir, f"{req.id}.json"), payload)
        with self._lock:
            self._records.pop(req.id, None)
            token = self._spans.pop(req.id, None)
            qtoken = self._qspans.pop(req.id, None)
        if qtoken is not None:
            qtoken.finish(state="requeued")
        if token is not None:
            token.finish(state="requeued")
        self._count("requests_requeued")
        self._record(f"request:{req.id}", "requeued")

    # -- crash recovery + retention -------------------------------------

    def reconcile(
        self,
        spool_dir: Optional[str] = None,
        live_replicas: Optional[set] = None,
        require_replica: bool = False,
    ) -> Dict[str, int]:
        """Pass over prior/peer processes' request manifests: every
        request a dead daemon left non-terminal (queued/dispatched)
        reaches a durable state — re-queued into the spool when it came
        from one (and a spool is configured), else marked ``failed`` /
        interrupted with a result record the status endpoint can serve.

        Single-replica (both fleet arguments at their defaults) this is
        the startup pass it has always been: it runs before any source
        opens, so every folded record belongs to a previous process.
        Fleet mode: ``live_replicas`` is the set of replica
        ids with a fresh heartbeat — a request whose latest manifest line
        is attributed to a LIVE peer is skipped (it is that peer's
        in-flight work, not a casualty); ``require_replica=True`` (the
        survivors' periodic sweep) additionally skips records with no
        replica attribution at all, because mid-flight there is no way
        to tell an unattributed live request from a dead one — only the
        startup pass, which runs before any source opens, may disposition
        those legacy records."""
        folded: Dict[str, Dict[str, Any]] = {}
        for r in faults_mod.iter_manifest_records(self.results_dir):
            key = r.get("video")
            if not isinstance(key, str) or not key.startswith("request:"):
                continue
            rid = key[len("request:"):]
            cur = folded.setdefault(rid, {})
            status = r.get("status")
            if status:
                cur["state"] = status
                # attribution follows the state: the replica that wrote
                # the LATEST transition owns the request now (a requeued
                # request re-admitted elsewhere belongs to its new home)
                if r.get("replica") is not None:
                    cur["replica"] = r["replica"]
            for f in ("feature_type", "video_path", "bucket", "source",
                      "priority", "deadline_ms"):
                if r.get(f) is not None:
                    cur.setdefault(f, r[f])
        requeued = interrupted = 0
        for rid, rec in sorted(folded.items()):
            state = rec.get("state")
            if state in TERMINAL_STATES or state in _SPOOL_SAFE_STATES:
                continue
            owner = rec.get("replica")
            if owner is None and require_replica:
                continue
            if live_replicas is not None and owner is not None \
                    and owner in live_replicas:
                continue
            req = ExtractionRequest(
                feature_type=str(rec.get("feature_type") or ""),
                video_path=str(rec.get("video_path") or ""),
                id=rid,
                bucket=str(rec.get("bucket") or DEFAULT_BUCKET),
                source=str(rec.get("source") or "local"),
                priority=int(rec.get("priority") or 0),
                deadline_ms=rec.get("deadline_ms"),
            )
            if req.source == "spool" and spool_dir:
                self.requeue(req, spool_dir)
                requeued += 1
            else:
                self.finish(
                    req, "failed", error_class="interrupted",
                    message=f"daemon terminated while request was {state}; "
                            "resubmit to retry",
                )
                interrupted += 1
        return {"requeued": requeued, "interrupted": interrupted}

    def sweep(
        self,
        ttl_s: float,
        max_records: int,
        now: Optional[float] = None,
    ) -> int:
        """TTL/size-bounded retention: prune terminal result files (and
        prior-run manifest event files) older than ``ttl_s``, keep at
        most ``max_records`` result files (oldest dropped first), and
        age the in-memory map the same way — ``_requests/`` stops
        growing without bound under steady traffic. Returns how many
        records were pruned."""
        now = time.time() if now is None else now
        pruned = 0
        results: List[Tuple[float, str]] = []
        try:
            names = os.listdir(self.results_dir)
        except OSError:
            names = []
        for name in names:
            if not name.endswith(".json"):
                continue
            path = os.path.join(self.results_dir, name)
            try:
                if os.path.isfile(path):
                    results.append((os.stat(path).st_mtime, path))
            except OSError:
                continue
        results.sort()  # oldest first
        survivors: List[str] = []
        for mtime, path in results:
            if ttl_s > 0 and now - mtime > ttl_s:
                pruned += self._unlink(path)
            else:
                survivors.append(path)
        if max_records > 0 and len(survivors) > max_records:
            for path in survivors[: len(survivors) - max_records]:
                pruned += self._unlink(path)
        if ttl_s > 0:
            # prior-run manifest logs: after reconcile() every request
            # they describe is terminal (and result-file-backed), so an
            # aged-out events file carries no live state
            for path in glob.glob(
                os.path.join(self.results_dir, faults_mod.MANIFEST_DIRNAME,
                             "events-*.jsonl")
            ):
                if path == self.manifest.path:
                    continue
                try:
                    if now - os.stat(path).st_mtime > ttl_s:
                        pruned += self._unlink(path)
                except OSError:
                    continue
        with self._lock:
            terminal = sorted(
                (rec.get("finished_ts", 0.0), rid)
                for rid, rec in self._records.items()
                if rec.get("state") in TERMINAL_STATES
            )
            drop = [rid for ts, rid in terminal if ttl_s > 0 and now - ts > ttl_s]
            keep = len(terminal) - len(drop)
            if max_records > 0 and keep > max_records:
                dropped = set(drop)
                drop += [rid for ts, rid in terminal
                         if rid not in dropped][: keep - max_records]
            for rid in drop:
                self._records.pop(rid, None)
        return pruned + len(drop)

    @staticmethod
    def _unlink(path: str) -> int:
        try:
            os.unlink(path)
            return 1
        except OSError:
            return 0

    # -- queries --------------------------------------------------------

    def get(self, request_id: str) -> Optional[Dict[str, Any]]:
        """The live record, falling back to the durable result file for
        requests finished before a daemon restart."""
        with self._lock:
            rec = self._records.get(request_id)
            if rec is not None:
                return dict(rec)
        if not _ID_RE.match(request_id or ""):
            return None
        path = os.path.join(self.results_dir, f"{request_id}.json")
        try:
            with open(path, "r", encoding="utf-8") as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return None

    def counts(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {s: 0 for s in REQUEST_STATES}
            for rec in self._records.values():
                s = rec.get("state")
                if s in out:
                    out[s] += 1
        return out

    # -- internals ------------------------------------------------------

    def _count(self, name: str) -> None:
        if self.telemetry is not None and self.telemetry.enabled:
            self.telemetry.metrics.inc(name)

    def _record(self, key: str, status: str, **extra: Any) -> None:
        if self.replica_id is not None:
            extra.setdefault("replica", self.replica_id)
        self.manifest.record(key, status, **extra)

    def _write_result(self, rec: Dict[str, Any]) -> None:
        """tmp + rename so a status reader never sees a torn record."""
        faults_mod.fire("tracker_write")
        path = os.path.join(self.results_dir, f"{rec['id']}.json")
        atomic_write_json(path, rec, indent=1, sort_keys=True)
