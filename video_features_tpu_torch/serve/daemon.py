"""The long-lived extraction daemon: resident models, request sources,
and the ``serve`` CLI entry.

Counterpart of ``video_features_tpu/serve/daemon.py``. Pieces (each its
own module, wired here):

- :class:`ExtractorPool` — one resident ``BaseExtractor`` per served
  feature type, built lazily and kept for the daemon's lifetime: weights
  load once, and every group dispatch rides the existing
  ``extract/base.py`` group path (device preprocess, classified retries,
  the stop at a sticky device error — all per request, for free).
- :class:`~video_features_tpu_torch.serve.batcher.AdmissionController` —
  the bucket-keyed coalescing queue (bounded; the backpressure contract).
- :class:`~video_features_tpu_torch.serve.lifecycle.RequestTracker` —
  the manifest-backed queued/dispatched/done|failed record per request.
- sources — HTTP (:mod:`.server`) and the spool directory
  (:mod:`.sources`), both funneling into :meth:`ServeDaemon.submit`.
- the content-addressed feature cache (``--cache_dir``): a repeat of an
  extracted (content, config) pair goes terminal ``done`` at admission;
  and with more than one served model the shared-decode frame cache
  (``extract/plan.py``) decodes each clip once for all of them.

Every model runs on the daemon's one device (``devices.resolve_device``:
``cuda:<id>``, or the CPU only with ``--cpu``; a request never reruns on
the CPU). Groups dispatch from the dispatcher thread, or from the
watchdog's worker with ``--group_timeout_s > 0``: the extractors place
their tensors on that explicit device, and the kernel wrappers launch on
the current stream of the tensor's device, so no thread depends on
another's current-device state.

A sticky device error (``runtime/faults.py::is_sticky``: a CUDA error
other than an allocation failure) poisons the whole process: every later
launch of every resident model fails the same way, and a breaker's
half-open probe rebuilds into the same context. So when a group ends at
one (the extractor's loop stopped, ``extract/base.py::_stop_on_sticky``,
or the group raised it) the daemon fails that group's members, then
stops taking work for every model (``_stop_on_sticky``): ``submit``
refuses with :class:`DaemonStopped` (HTTP 503), ``/healthz`` answers 503
naming the error, the spool watcher stops claiming and this replica's
registry heartbeat stops, so fleet peers reclaim its leases; groups
still queued leave as the shutdown contract says (spool requests back to
the spool, the rest ``failed`` interrupted). ``serve_main`` then shuts
down without draining and returns 1, for a supervisor to restart the
process. This is the port's own: the JAX daemon has no sticky errors.

``serve warmup`` (or ``--warmup`` with traffic) loads each declared
model and drives a synthetic clip of each declared resolution through
the normal dispatch path: on the card that loads the weights and picks
cuDNN's algorithms before the first request (eager PyTorch compiles
nothing); each warmup line ends with the model's projected resident
device memory (``hbm=``), and ``--hbm_budget_bytes`` fails the warmup
when the resident models' projection exceeds it.

The device cost ledger (``telemetry/ledger.py``): the pooled extractors
record each model call's flops and memory at its first call, and a
:class:`~video_features_tpu_torch.telemetry.ledger.DeviceMemorySampler`
polls the daemon's device into the ``device_mem_*`` gauges (none on the
CPU). With ``--preempt on`` a :class:`~video_features_tpu_torch.serve.
preemptor.Preemptor` gates admission: a request for a model that is not
resident and whose projection does not fit the sampler's headroom first
evicts the lowest-value residents (their breakers tripped, a
``preempted`` event each), and a failed build of that model rolls the
victims back (``preemption_rollback``). Every ``torch.cuda`` memory call
names the daemon's device: groups dispatch from threads that made no
CUDA call of their own.
"""

from __future__ import annotations

import gc
import os
import signal
import threading
import time
import traceback
import uuid
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from video_features_tpu_torch.config import (
    ExtractionConfig,
    ServeConfig,
    parse_serve_args,
    sanity_check,
)
from video_features_tpu_torch.devices import resolve_device
from video_features_tpu_torch.extract.cache import FeatureCache, config_digest, feature_keys_for
from video_features_tpu_torch.extract.plan import cache_for
from video_features_tpu_torch.extract.registry import build_extractor, media_need_for
from video_features_tpu_torch.io.probe import ResourceCaps, preflight
from video_features_tpu_torch.io.sink import expected_output_files
from video_features_tpu_torch.io.video import set_frame_cache
from video_features_tpu_torch.runtime import faults
from video_features_tpu_torch.runtime import telemetry as telemetry_mod
from video_features_tpu_torch.runtime.telemetry import SloTracker, Telemetry
from video_features_tpu_torch.serve.batcher import AdmissionController, Key, QueueFull
from video_features_tpu_torch.serve.costmodel import ServiceTimeModel, default_model_path
from video_features_tpu_torch.serve.lifecycle import (
    TERMINAL_STATES,
    BadRequest,
    ExtractionRequest,
    InvalidMedia,
    ReplicaRegistry,
    RequestTracker,
    parse_request,
)
from video_features_tpu_torch.serve.preemptor import PreemptionPlan, Preemptor
from video_features_tpu_torch.serve.scheduler import build_scheduler
from video_features_tpu_torch.serve.supervisor import (
    CircuitBreaker,
    DaemonStopped,
    GroupTimeout,
    ModelUnavailable,
    Watchdog,
)
from video_features_tpu_torch.telemetry.exposition import (
    Family,
    families_from_ledger,
    families_from_snapshot,
    group_service_metric,
    render_families,
)
from video_features_tpu_torch.telemetry.ledger import (
    CostLedger,
    DeviceMemorySampler,
    default_ledger_path,
    format_bytes,
)
from video_features_tpu_torch.utils.synth import synth_video


class _OutcomeTee:
    """Wraps an extractor's manifest: every record still reaches the real
    per-video manifest; terminal per-video records (done/failed) are
    additionally captured so the dispatcher can map them back to the
    requests of the group it just ran, and so is a ``worker_death``
    event (a sticky device error stopped the loop). Lock-guarded —
    records arrive from decode workers and the dispatcher thread alike."""

    def __init__(self, inner: Any) -> None:
        self._inner = inner
        self._lock = threading.Lock()
        self._outcomes: Dict[str, Dict[str, Any]] = {}
        self._death: Optional[Dict[str, Any]] = None

    def record(self, video: Any, status: str, **kw: Any) -> None:
        self._inner.record(video, status, **kw)
        if status in ("done", "failed"):
            with self._lock:
                self._outcomes[str(video)] = {"status": status, **kw}

    def event(self, name: str, **fields: Any) -> None:
        self._inner.event(name, **fields)
        if name == "worker_death":
            with self._lock:
                self._death = dict(fields)

    def close(self) -> None:  # the extractor closes its manifest after each run
        self._inner.close()

    def take(self) -> Dict[str, Dict[str, Any]]:
        """Drain the outcomes captured since the last call (the
        dispatcher calls this once per group, on its own thread)."""
        with self._lock:
            out, self._outcomes = self._outcomes, {}
        return out

    def take_death(self) -> Optional[Dict[str, Any]]:
        """The ``worker_death`` event since the last call, or None."""
        with self._lock:
            out, self._death = self._death, None
        return out


class ExtractorPool:
    """Resident extractors, one per feature type, built once and reused
    for every subsequent request — the warm state a daemon exists to
    keep (no process startup, no weight reload)."""

    def __init__(
        self,
        cfg: ExtractionConfig,
        max_group_size: int,
        build: Callable[..., Any] = build_extractor,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._cfg = cfg
        self._max_group_size = max(int(max_group_size), 1)
        self._build = build
        self._clock = clock
        self._lock = threading.Lock()
        self._extractors: Dict[str, Any] = {}
        # per-feature-type build latch: the winning builder publishes and
        # sets it; losers wait OUTSIDE the pool lock (see get())
        self._building: Dict[str, threading.Event] = {}
        self.build_count: Dict[str, int] = {}
        # when each resident was (re)built, on the daemon's clock
        self.built_at: Dict[str, float] = {}

    def _serving_config(self, feature_type: str) -> ExtractionConfig:
        """The per-feature-type extraction config: the daemon's base
        flags with the serve invariants pinned (save outputs, no resume
        probing, group size = the admission group bound, and at least
        one decode worker so the fused group path is reachable)."""
        cfg = self._cfg.replace(
            feature_type=feature_type,
            video_paths=[],
            flow_paths=None,
            file_with_video_paths=None,
            video_dir=None,
            flow_dir=None,
            on_extraction=(
                self._cfg.on_extraction
                if self._cfg.on_extraction in ("save_numpy", "save_pickle")
                else "save_numpy"
            ),
            video_batch=self._max_group_size,
            decode_workers=max(int(self._cfg.decode_workers or 0), 1),
            resume=False,
            retry_failed=False,
            strict=False,
            show_pred=False,
        )
        return sanity_check(cfg)

    def get(self, feature_type: str) -> Any:
        """Return the resident extractor, building it on first use.

        The build (weights load) can take seconds and runs OUTSIDE
        ``_lock``: anything queued on the pool lock (``status()`` -> :meth:`feature_types`, eviction)
        must never block behind it. One build per feature type is
        serialized through a per-type latch; concurrent callers wait on
        the latch (timed, off-lock) and re-check. A failed build clears
        the latch so the next caller retries from scratch."""
        while True:
            with self._lock:
                ext = self._extractors.get(feature_type)
                if ext is not None:
                    return ext
                latch = self._building.get(feature_type)
                builder = latch is None
                if builder:
                    latch = self._building[feature_type] = threading.Event()
            if not builder:
                latch.wait(1.0)  # poll: a crashed builder clears the latch
                continue
            try:
                ext = self._build(self._serving_config(feature_type))
                ext.manifest = _OutcomeTee(ext.manifest)
                with self._lock:
                    self._extractors[feature_type] = ext
                    self.build_count[feature_type] = (
                        self.build_count.get(feature_type, 0) + 1
                    )
                    self.built_at[feature_type] = self._clock()
                return ext
            finally:
                with self._lock:
                    self._building.pop(feature_type, None)
                latch.set()

    def feature_types(self) -> List[str]:
        with self._lock:
            return sorted(self._extractors)

    def evict(self, feature_type: str) -> None:
        """Tear one resident extractor down (breaker opened, or a
        watchdog-abandoned worker may still hold its model state); the
        next :meth:`get` rebuilds from scratch through the same path.
        The extractor's tensors go back to the allocator once nothing
        holds them: a collection after the drop reclaims the ones held
        only by reference cycles, so a preemption's beneficiary builds
        into the memory its victims held. A watchdog-abandoned worker
        thread may still hold the old model's tensors, and until it lets
        go a rebuild holds two copies of the weights."""
        with self._lock:
            ext = self._extractors.pop(feature_type, None)
            self.built_at.pop(feature_type, None)
        if ext is not None:
            try:
                ext.telemetry.close()
            except Exception:  # noqa: BLE001 - eviction must finish
                pass
            del ext
            gc.collect()

    def close(self) -> None:
        with self._lock:
            exts = list(self._extractors.values())
        for ext in exts:
            try:
                ext.telemetry.close()
            except Exception:  # noqa: BLE001 - shutdown must finish
                pass


class ServeDaemon:
    """The daemon: glue between sources, admission, the pool, and the
    request tracker. Construct, :meth:`start`, then :meth:`shutdown`
    (drains by default)."""

    def __init__(
        self,
        scfg: ServeConfig,
        build: Callable[..., Any] = build_extractor,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.scfg = scfg
        self.cfg = scfg.extraction
        self.clock = clock
        # the one device every resident model runs on: raises without
        # CUDA unless --cpu, before any state is written
        self.device = resolve_device(self.cfg)
        os.makedirs(self.cfg.output_path, exist_ok=True)
        # serve-path stages (admission/serve_dispatch/tracker_write) fire
        # before any extractor exists; install the injector now — each
        # extractor build reinstalls the same specs (extract/base.py),
        # which only resets the counters
        faults.install_injector(self.cfg.fault_inject)
        # the daemon's own telemetry: request spans, admission gauge,
        # request counters, and the heartbeat line (which now reports
        # live queue depth — see Telemetry.heartbeat_line)
        self.telemetry = Telemetry(
            output_root=self.cfg.output_path,
            enabled=self.cfg.telemetry != "off",
            heartbeat_s=float(self.cfg.heartbeat_s or 0.0),
        )
        # the serve heartbeat replaces the batch-oriented default line
        # (videos/s, ETA) with queue depth / inflight / miss rate
        self.telemetry.heartbeat_provider = self._heartbeat_line
        self._start_mono = clock()
        self._hb_prev: Tuple[float, int] = (clock(), 0)
        # rolling SLO window + the online service-time estimator; both
        # live on the daemon's (injectable) scheduling clock
        self.slo = SloTracker(window_s=scfg.slo_window_s, clock=clock)
        self.cost_model = ServiceTimeModel(path=default_model_path(self.cfg))
        # device cost ledger: the pooled extractors record each model
        # call's flops and memory here (extract/base.py hooks the built
        # state at warmup); shared() so daemon and extractors see one
        # object per path. The sampler polls the daemon's device into the
        # registry (no gauge on the CPU)
        self.ledger = CostLedger.shared(default_ledger_path(self.cfg))
        self.sampler = DeviceMemorySampler(
            self.telemetry.metrics,
            interval_s=max(float(self.cfg.heartbeat_s or 0.0), 10.0),
            devices=[self.device],
        )
        # fleet identity: every manifest line is attributed
        # to this replica, and the registry heartbeat is how surviving
        # peers on a shared output store learn this process is alive
        self.replica_id = scfg.resolved_replica_id()
        self.registry = ReplicaRegistry(self.cfg.output_path, self.replica_id)
        self.registry.beat()
        self.tracker = RequestTracker(
            self.cfg.output_path, telemetry=self.telemetry,
            slo=self.slo, clock=clock, replica_id=self.replica_id,
        )
        # crash recovery BEFORE any source can admit: requests a dead
        # process left queued/dispatched reach a durable state (spool
        # files re-queued, HTTP requests failed 'interrupted'). In a
        # fleet (lease_timeout_s > 0) LIVE peers' in-flight requests are
        # not casualties — skip them; our own prior incarnation is never
        # "live" to us at startup, so a same-id restart still recovers.
        live_peers = None
        if scfg.lease_timeout_s > 0:
            live_peers = (
                self.registry.live(scfg.lease_timeout_s) - {self.replica_id}
            )
        self.recovered = self.tracker.reconcile(
            scfg.spool_dir, live_replicas=live_peers
        )
        if any(self.recovered.values()):
            print(f"serve: recovered prior run: {self.recovered['requeued']} "
                  f"requeued, {self.recovered['interrupted']} interrupted")
        self.tracker.sweep(scfg.request_ttl_s, scfg.max_request_records)
        # admission preflight (--preflight on): one caps snapshot shared
        # by every submit; the extractors re-derive the same caps from
        # the same config at build time (extract/base.py)
        self._caps = ResourceCaps.from_config(self.cfg)
        self.pool = ExtractorPool(
            self.cfg, scfg.max_group_size, build=build, clock=clock
        )
        # content-addressed feature cache (extract/cache.py): a repeat
        # request for an already-extracted (content, config) pair goes
        # terminal 'done' at admission — no queue, no decode, no device.
        # Misses populate the store through the pooled extractors' sink
        # path (extract/base.py carries the same cache_dir).
        self.cache: Any = None
        self._cache_keys: Dict[str, tuple] = {}  # ft -> (digest, keys, out, mode, direct)
        if self.cfg.cache_dir:
            self.cache = FeatureCache(self.cfg.cache_dir, hash_mode=self.cfg.cache_hash)
        # shared-decode frame cache (extract/plan.py): a daemon serving
        # >1 model decodes each clip once and fans the frames out to
        # every resident extractor; installed for the daemon's lifetime,
        # uninstalled in shutdown()
        self._frame_cache: Any = None
        if len(scfg.feature_types) > 1:
            self._frame_cache = cache_for(self.cfg, scfg.feature_types)
            if self._frame_cache is not None:
                set_frame_cache(self._frame_cache)
        self.batcher = AdmissionController(
            dispatch=self._dispatch_group,
            max_group_size=scfg.max_group_size,
            max_batch_wait_s=scfg.max_batch_wait_ms / 1000.0,
            max_queue=scfg.max_queue,
            clock=clock,
            metrics=self.telemetry.metrics,
            scheduler=build_scheduler(
                scfg.scheduler,
                default_slack_s=scfg.default_slack_ms / 1000.0,
                aging_s=scfg.aging_ms / 1000.0,
                cost_model=self.cost_model,
            ),
        )
        self.watchdog = Watchdog(scfg.group_timeout_s)
        self._breakers: Dict[str, CircuitBreaker] = {}
        # HBM-aware preemption (serve/preemptor.py): only constructed
        # when --preempt on; with it off, an overcommitting burst meets
        # no admission gate
        self.preemptor: Optional[Preemptor] = None
        self._preempt_plans: Dict[str, PreemptionPlan] = {}
        if scfg.preempt == "on":
            self.preemptor = Preemptor(
                ledger=self.ledger,
                cost_model=self.cost_model,
                pool=self.pool,
                breaker_for=self._breaker,
                headroom_fn=self._headroom_bytes,
                queued_fn=self.batcher.queued_by_feature_type,
                hbm_budget_bytes=scfg.hbm_budget_bytes,
                cooldown_s=scfg.preempt_cooldown_s,
                min_residency_s=scfg.preempt_min_residency_s,
                clock=clock,
                metrics=(self.telemetry.metrics
                         if self.telemetry.enabled else None),
                manifest=self.tracker.manifest,
            )
        self._cancel_pending: set = set()
        self._http_server: Any = None
        self._http_thread: Any = None
        self._spool: Any = None
        self._sweep_thread: Optional[threading.Thread] = None
        self._sweep_stop = threading.Event()
        self._lock = threading.Lock()
        self._started = False
        # a sticky device error's message once it stopped the daemon
        # (_stop_on_sticky); ``stop_requested`` wakes run_until_signalled
        self.stopped_by: Optional[str] = None
        self.stop_requested = threading.Event()

    def _breaker(self, feature_type: str) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(feature_type)
            if b is None:
                b = CircuitBreaker(
                    threshold=self.scfg.breaker_threshold,
                    cooldown_s=self.scfg.breaker_cooldown_s,
                    clock=self.clock,
                )
                self._breakers[feature_type] = b
            return b

    # -- the request path ------------------------------------------------

    def submit(self, payload: Dict[str, Any], source: str) -> Dict[str, Any]:
        """Parse, validate, lifecycle-admit, and queue one request.
        Raises :class:`BadRequest` (caller -> 400 / rejected record),
        :class:`QueueFull` (caller -> 503 / spool backpressure; the
        request is already recorded ``rejected``), or
        :class:`ModelUnavailable` (this feature type's breaker is open:
        HTTP -> 503 with Retry-After and a ``rejected`` record, spool ->
        defer the file untouched), or :class:`DaemonStopped` (a sticky
        device error stopped the daemon: HTTP -> 503, no record; spool ->
        the file stays unclaimed).

        A payload carrying ``feature_types`` (a LIST) is the multi-model
        fan-out form: one video, several models, one decode (see
        :meth:`_submit_fanout`)."""
        if self.stopped_by is not None:
            raise DaemonStopped(f"daemon stopped: {self.stopped_by}")
        if isinstance(payload, dict) and "feature_types" in payload:
            return self._submit_fanout(payload, source)
        req = parse_request(payload, source)
        # the admission span covers validation + preflight probe +
        # breaker gate + queue admit; tracker.admit's request span opens
        # inside it, so the per-request trace starts at admission
        with self.telemetry.span(
            "admission", video=req.video_path, request=req.id,
            feature_type=req.feature_type, bucket=req.bucket, source=source,
        ):
            if req.feature_type not in self.scfg.feature_types:
                raise BadRequest(
                    f"feature_type {req.feature_type!r} not served (serving: "
                    f"{', '.join(self.scfg.feature_types)})"
                )
            if not os.path.exists(req.video_path):
                raise BadRequest(f"video_path does not exist: {req.video_path}")
            self._preflight(req)
            files = self._cache_lookup(req)
            if files is not None:
                # content-addressed hit: the outputs are already on disk
                # under this exact config — the request goes terminal at
                # admission, skipping queue/scheduler/device entirely
                self.tracker.admit(req)
                return self.tracker.finish(req, "done", features=files)
            self._maybe_shed(req)
            faults.fire("admission")
            breaker = self._breaker(req.feature_type)
            if not breaker.allow_request():
                exc = ModelUnavailable(req.feature_type, breaker.retry_after_s())
                if req.source != "spool":
                    # terminal record for HTTP/local callers; the spool
                    # file is its own durable record and just waits out
                    # the open
                    self.tracker.reject(req, str(exc))
                raise exc
            self._hbm_gate(req)
            rec = self.tracker.admit(req)
            try:
                self.batcher.admit(req)
            except QueueFull:
                if self.telemetry.enabled:
                    self.telemetry.metrics.inc("requests_shed.queue_full")
                if req.source == "spool":
                    # the spool file survives and re-submits under the
                    # same id next poll: back the admit out, no terminal
                    # record
                    self.tracker.forget(req)
                else:
                    self.tracker.reject(req, f"queue full ({self.scfg.max_queue})")
                raise
            return rec

    def _preflight(self, req: ExtractionRequest) -> None:
        """Admission-time media vouching (``--preflight on``). Runs
        BEFORE the breaker gate on purpose: a corrupt upload must come
        back 422 ``invalid_media`` even while the model's breaker is
        open — it would never have reached the device anyway. A reject
        writes the durable ``rejected`` record first (the request had an
        identity; its terminal state must survive the process), then
        raises :class:`InvalidMedia` (HTTP -> 422 body with the record,
        spool -> ``.bad`` + ``.why`` quarantine)."""
        if getattr(self.cfg, "preflight", "off") != "on":
            return
        need = media_need_for(req.feature_type)
        report = preflight(req.video_path, need=need, caps=self._caps)
        if report.verdict != "reject":
            return
        reason = f"invalid media: {report.reason}"
        rec = self.tracker.reject(req, reason)
        raise InvalidMedia(reason, record=rec)

    # -- hit-rate-aware shedding --------------------------------------------

    def _maybe_shed(self, req: ExtractionRequest) -> None:
        """Saturation triage: past ``--shed_watermark`` × max_queue,
        shed requests the feature cache cannot answer. Runs AFTER
        :meth:`_cache_lookup`, so a cache hit has already gone terminal
        ``done`` and can never be shed; what reaches here is a known
        miss — the expensive kind — and shedding it keeps admission room
        for the ~ms hits. Only acts when the observed hit rate says hits
        are actually common (>= 50% over >= 20 lookups); a cold or
        miss-heavy cache sheds nothing and the plain queue bound rules."""
        wm = float(getattr(self.scfg, "shed_watermark", 0.0) or 0.0)
        if wm <= 0 or self.cache is None or not self.telemetry.enabled:
            return
        if self.batcher.depth() < wm * self.scfg.max_queue:
            return
        counters = self.telemetry.metrics.snapshot().get("counters", {})
        hits = sum(
            v for k, v in counters.items() if k.startswith("cache_hit.")
        )
        misses = sum(
            v for k, v in counters.items() if k.startswith("cache_miss.")
        )
        total = hits + misses
        if total < 20 or hits / total < 0.5:
            return
        self.telemetry.metrics.inc("requests_shed.likely_cache_miss")
        msg = (
            f"queue saturated ({self.batcher.depth()}/{self.scfg.max_queue})"
            " and this request missed the feature cache; shed to preserve"
            " admission room for cache hits"
        )
        if req.source != "spool":
            # terminal record for HTTP/local callers; a spool file is its
            # own durable record and simply retries after backoff
            self.tracker.reject(req, msg)
        raise QueueFull(msg)

    # -- HBM-aware preemption ------------------------------------------------

    def _headroom_bytes(self) -> Optional[int]:
        """The live ``device_mem_headroom_bytes`` gauge (set by the
        DeviceMemorySampler), or None on the CPU — the preemptor then
        falls back to the static ``--hbm_budget_bytes`` arithmetic."""
        gauges = self.telemetry.metrics.snapshot().get("gauges", {})
        h = gauges.get("device_mem_headroom_bytes")
        return int(h) if h is not None else None

    def _hbm_gate(self, req: ExtractionRequest) -> None:
        """Admission HBM arbitration (only with ``--preempt on``): a
        request for a non-resident model whose ledger-projected footprint
        cannot fit beside the resident set first tries to preempt the
        lowest-value residents; only if even that cannot make room is it
        refused (503 with the cooldown as Retry-After; spool files defer
        and retry, exactly like an open breaker)."""
        if self.preemptor is None:
            return
        verdict, needed, available = self.preemptor.check(req.feature_type)
        if verdict != "overcommit":
            return
        plan = self.preemptor.ensure_room(req.feature_type)
        if plan is not None:
            # remember the sacrifice until the beneficiary's build
            # succeeds — a failed build rolls the victims back
            with self._lock:
                self._preempt_plans[req.feature_type] = plan
            return
        if self.preemptor.check(req.feature_type)[0] != "overcommit":
            return  # a concurrent admission already made room
        exc = ModelUnavailable(
            req.feature_type, self.scfg.preempt_cooldown_s,
            reason=(
                f"model {req.feature_type!r} cannot fit: needs {needed} "
                f"bytes of HBM, {available} available, and no resident "
                f"extractor is preemptible right now; retry in "
                f"{self.scfg.preempt_cooldown_s:.1f}s"
            ),
        )
        if req.source != "spool":
            self.tracker.reject(req, str(exc))
        raise exc

    def _pop_plan(self, feature_type: str) -> Optional[PreemptionPlan]:
        with self._lock:
            return self._preempt_plans.pop(feature_type, None)

    # -- multi-model fan-out ----------------------------------------------

    def _submit_fanout(self, payload: Dict[str, Any], source: str) -> Dict[str, Any]:
        """One video, several models: expand ``feature_types`` into one
        sub-request per model (ids ``<base>.<feature_type>``) and submit
        each through the normal admission path. The daemon's shared-
        decode frame cache makes the expansion decode the clip ONCE; the
        content hash is memoized, so N models hash the bytes once too.

        Sub-requests already tracked under their derived id are returned
        as-is (idempotent: a spool file re-polled after a partial
        QueueFull admits only the missing members). QueueFull and
        InvalidMedia propagate — the caller's backpressure/quarantine
        contract is per-payload; already-admitted members stay admitted
        and the duplicate tolerance absorbs the re-submit."""
        fts = payload.get("feature_types")
        if (
            not isinstance(fts, list)
            or not fts
            or not all(isinstance(f, str) and f for f in fts)
        ):
            raise BadRequest(
                "bad 'feature_types': expected a non-empty list of strings"
            )
        if "feature_type" in payload:
            raise BadRequest(
                "pass either 'feature_type' or 'feature_types', not both"
            )
        fts = list(dict.fromkeys(fts))
        unserved = [f for f in fts if f not in self.scfg.feature_types]
        if unserved:
            # validate the WHOLE list before admitting anything: a fan-out
            # must not half-run because one member named a missing model
            raise BadRequest(
                f"feature_type(s) {', '.join(map(repr, unserved))} not served "
                f"(serving: {', '.join(self.scfg.feature_types)})"
            )
        base = {k: v for k, v in payload.items() if k != "feature_types"}
        base_id = base.pop("id", None) or uuid.uuid4().hex[:12]
        subs: Dict[str, Dict[str, Any]] = {}
        for ft in fts:
            sub_id = f"{base_id}.{ft.replace('/', '-')}"
            existing = self.tracker.get(sub_id)
            if existing is not None:
                subs[ft] = existing
                continue
            sub = dict(base)
            sub["feature_type"] = ft
            sub["id"] = sub_id
            subs[ft] = self.submit(sub, source)
        states = [r.get("state") for r in subs.values()]
        return {
            "id": base_id,
            "fanout": True,
            "state": "done" if all(s == "done" for s in states) else "queued",
            "video_path": payload.get("video_path"),
            "feature_types": fts,
            "requests": subs,
        }

    # -- content-addressed cache ------------------------------------------

    def _cache_key_for(self, feature_type: str) -> tuple:
        """(config digest, feature keys, output path, on_extraction,
        output_direct) for one served model — derived from the SAME
        serving config the pool builds extractors from, WITHOUT building
        the model (admission must never pay a weights load to answer a
        lookup). Memoized: the config is immutable for the daemon's
        lifetime."""
        with self._lock:
            got = self._cache_keys.get(feature_type)
        if got is not None:
            return got
        cfg = self.pool._serving_config(feature_type)
        out_path = (
            cfg.output_path
            if cfg.output_direct
            else os.path.join(cfg.output_path, feature_type)
        )
        got = (
            config_digest(cfg),
            feature_keys_for(cfg),
            out_path,
            cfg.on_extraction,
            cfg.output_direct,
        )
        with self._lock:
            self._cache_keys.setdefault(feature_type, got)
        return got

    def _cache_lookup(self, req: ExtractionRequest) -> Optional[List[str]]:
        """Admission-time content-addressed lookup: the materialized
        output files on a hit, None on a miss (or with caching off). Any
        cache-side failure is a miss — the normal dispatch path is
        always the fallback, never a wrong answer."""
        if self.cache is None:
            return None
        ft = req.feature_type
        try:
            chash = self.cache.content_hash(req.video_path)
        except OSError:
            return None
        digest, keys, out_path, on_ext, direct = self._cache_key_for(ft)
        cached = self.cache.lookup(chash, digest, keys)
        if cached is not None:
            try:
                files = self.cache.materialize(
                    cached,
                    self.cache.dest_files(
                        keys, req.video_path, out_path, on_ext, direct
                    ),
                )
            except OSError:
                cached = None  # payload vanished mid-copy: miss
            else:
                self.telemetry.metrics.inc(f"cache_hit.{ft}")
                return files
        self.telemetry.metrics.inc(f"cache_miss.{ft}")
        return None

    def _dispatch_group(self, key: Key, requests: List[ExtractionRequest]) -> None:
        """One coalesced group -> one resident-extractor run over the
        group's videos. Runs on the dispatcher thread; every outcome —
        including a build/dispatch crash, a watchdog timeout, or a
        breaker that opened after admission — lands as a terminal record
        on every member request.

        The group boundary is where scheduling decisions become final:
        cancel-requested members leave as ``cancelled`` and members whose
        deadline already passed leave as ``expired`` BEFORE the group
        touches the device — an expired request must not burn compute.

        A sticky device error inside the group stops the extractor's loop
        (no exception reaches here): every member ends ``failed`` — the
        attempted ones with the loop's own record, the rest with the
        error — nothing is retried, and the daemon stops
        (``_stop_on_sticky``); so does a group that raised a sticky
        error. A group taken after the stop never runs: its members
        leave as the shutdown contract says."""
        feature_type = key[0]
        breaker: Optional[CircuitBreaker] = None
        probing = False
        resolved = False  # has the probe slot reported a verdict?
        try:
            if self.stopped_by is not None:
                self._disposition_undispatched(requests)
                return
            live = self._boundary_filter(requests)
            if not live:
                return
            breaker = self._breaker(feature_type)
            probing = breaker.try_probe()
            if not probing and breaker.state() != "closed":
                # opened between admission and dispatch (or another
                # group holds the probe slot): nothing here may run
                self._shed_unavailable(live, feature_type, breaker)
                return
            try:
                ext = self.pool.get(feature_type)
                if probing:
                    # the probe group must prove the model END TO END
                    # before real traffic rides it: re-warm through the
                    # declared warmup pairs first
                    self._rewarm(ext, feature_type)
            except Exception as exc:  # noqa: BLE001 - build/re-warm failed: fail the group
                msg = f"extractor build failed: {type(exc).__name__}: {exc}"
                traceback.print_exc()
                if faults.is_sticky(exc):
                    self._stop_on_sticky(f"{type(exc).__name__}: {exc}")
                # breaker verdict FIRST: the tracker writes below can
                # themselves raise (fault injection, full disk), and a
                # half-open probe slot claimed but never resolved would
                # wedge this model's admissions forever
                if breaker.record_failure():
                    self.pool.evict(feature_type)
                resolved = True
                plan = self._pop_plan(feature_type)
                if plan is not None and self.preemptor is not None:
                    # this build was a preemption's beneficiary: hand the
                    # victims their slots back rather than serving neither
                    self.preemptor.rollback(plan)
                for r in live:
                    self.tracker.finish(
                        r, "failed", error_class=faults.classify_error(exc),
                        error_type=type(exc).__name__, message=msg,
                    )
                return
            self._pop_plan(feature_type)  # built: the preemption held up
            for r in live:
                self.tracker.dispatched(r, group_size=len(live))
            # module-level telemetry hooks (decode frame counters, bucket
            # notes) follow the extractor whose group is on the device now
            telemetry_mod.set_current(ext.telemetry)

            def body() -> None:
                faults.fire("serve_dispatch")  # hang: the watchdog's prey
                faults.fire("extractor")  # error/oom: resident model death
                with ext.telemetry.span(
                    "request",
                    group_size=len(live),
                    requests=[r.id for r in live],
                    feature_type=feature_type,
                    bucket=key[1],
                ):
                    ext.run_paths([r.video_path for r in live], self.device)

            t_run = self.clock()
            try:
                self.watchdog.run(body)
            except Exception as exc:  # noqa: BLE001 - loop-level crash: fail the group
                traceback.print_exc()
                if faults.is_sticky(exc):
                    self._stop_on_sticky(f"{type(exc).__name__}: {exc}")
                outcomes = ext.manifest.take()
                err = {
                    "error_class": faults.classify_error(exc),
                    "error_type": type(exc).__name__,
                    "message": str(exc)[:500],
                }
                for r in live:
                    got = outcomes.get(r.video_path)
                    if got is not None and got["status"] == "done":
                        self._finish_done(r, ext)
                    else:
                        self.tracker.finish(r, "failed", **err)
                # group-level failure: one breaker tick — UNLESS the
                # crash is input-classified (corrupt media, resource
                # caps). Hostile inputs fail their own requests but must
                # not accumulate toward opening a healthy model's
                # breaker: N corrupt uploads in a row is traffic, not an
                # infra incident. A timed-out worker is abandoned, so
                # its extractor must never be reused even if the
                # breaker stays closed.
                if faults.is_input_error(exc):
                    breaker.record_ignored()
                elif breaker.record_failure() or isinstance(exc, GroupTimeout):
                    self.pool.evict(feature_type)
                resolved = True
                return
            death = ext.manifest.take_death()
            if death is not None:
                # a sticky device error stopped the extractor's loop: the
                # members it attempted carry its failed records, the rest
                # none. Every later launch in this process fails the same
                # way, so nothing is retried and the daemon stops (first,
                # so no admission slips in while the members are written);
                # one breaker failure, as a loop-level crash counts
                self._stop_on_sticky(f"{death.get('error_type')}: {death.get('message')}")
                outcomes = ext.manifest.take()
                msg = ("the group stopped at a sticky device error: "
                       f"{death.get('error_type')}: {death.get('message')}")
                for r in live:
                    got = outcomes.get(r.video_path)
                    if got is not None and got["status"] == "done":
                        self._finish_done(r, ext)
                    else:
                        got = got or {"error_class": "permanent",
                                      "error_type": death.get("error_type"), "message": msg}
                        self.tracker.finish(
                            r, "failed", error_class=got.get("error_class"),
                            error_type=got.get("error_type"), message=got.get("message"),
                        )
                if breaker.record_failure():
                    self.pool.evict(feature_type)
                resolved = True
                return
            breaker.record_success()
            resolved = True
            if probing:
                # durable recovery trail: the re-warmed model just proved
                # itself end to end (pairs with the 'preempted' event
                # when the open was a preemption trip)
                self.tracker.manifest.event(
                    "rewarmed", feature_type=feature_type
                )
            # feed the online service-time estimator and the per-
            # (feature_type, bucket) /metrics histogram from the group
            # that just completed: the cost model only ever learns from
            # successful dispatches (crashes/timeouts are supervision
            # events, not service-time samples)
            group_s = max(self.clock() - t_run, 0.0)
            self.cost_model.observe(feature_type, key[1], len(live), group_s)
            if self.telemetry.enabled:
                self.telemetry.metrics.observe(
                    group_service_metric(feature_type, key[1]), group_s
                )
            outcomes = ext.manifest.take()
            for r in live:
                got = outcomes.get(r.video_path)
                if got is None:
                    self.tracker.finish(
                        r, "failed", error_class="permanent",
                        message="no terminal manifest record for this video",
                    )
                elif got["status"] == "done":
                    self._finish_done(r, ext)
                else:
                    self.tracker.finish(
                        r, "failed",
                        error_class=got.get("error_class"),
                        error_type=got.get("error_type"),
                        message=got.get("message"),
                    )
        finally:
            if probing and not resolved and breaker is not None:
                # safety net for any exception that escaped between
                # try_probe() and the breaker verdict: release the
                # half-open probe slot WITHOUT a verdict so the next
                # admitted group re-probes — a leaked slot would 503
                # this model until restart
                breaker.record_ignored()
            with self._lock:
                self._cancel_pending.difference_update(r.id for r in requests)

    def _stop_on_sticky(self, reason: str) -> None:
        """A sticky device error ended a group: stop taking work for every
        model. Admission refuses from now on (``submit`` raises
        :class:`DaemonStopped`, ``/healthz`` answers 503 with ``reason``),
        the spool watcher stops claiming and the retention sweep stops, so
        this replica's registry heartbeat ends and fleet peers reclaim its
        leases; ``stop_requested`` wakes ``run_until_signalled``, which
        shuts down without draining. The HTTP door stays up until then, so
        a health check reads the 503."""
        with self._lock:
            if self.stopped_by is not None:
                return
            self.stopped_by = reason
            spool, self._spool = self._spool, None
        print(f"serve: stopping: a sticky device error poisoned this process ({reason}); "
              "every later launch would fail the same way")
        self.tracker.manifest.event("daemon_stopped", message=reason[:300])
        if spool is not None:
            spool.stop()
        self._stop_sweep()
        self.stop_requested.set()

    def _stop_sweep(self) -> None:
        self._sweep_stop.set()
        with self._lock:
            thread, self._sweep_thread = self._sweep_thread, None
        if thread is not None and thread is not threading.current_thread():
            thread.join()

    def _disposition_undispatched(self, requests: List[ExtractionRequest]) -> None:
        """The shutdown contract for requests that never reached the
        device: spool requests go back to the spool (the next daemon
        re-admits them under the same id), the rest end ``failed``
        interrupted — never silently stranded."""
        for req in requests:
            if req.source == "spool" and self.scfg.spool_dir:
                self.tracker.requeue(req, self.scfg.spool_dir)
            else:
                self.tracker.finish(
                    req, "failed", error_class="interrupted",
                    message="daemon shutdown before dispatch; resubmit to retry",
                )

    def _boundary_filter(
        self, requests: List[ExtractionRequest]
    ) -> List[ExtractionRequest]:
        """The pre-dispatch sweep: cancel-requested members -> cancelled,
        past-deadline members -> expired; the rest run."""
        now = self.clock()
        with self._lock:
            pending = set(self._cancel_pending)
        live: List[ExtractionRequest] = []
        for r in requests:
            if r.id in pending:
                self.tracker.finish(
                    r, "cancelled", error_class="cancelled",
                    message="cancelled before dispatch",
                )
            elif r.deadline_at is not None and now > r.deadline_at:
                self.tracker.finish(
                    r, "expired", error_class="expired",
                    message=f"deadline_ms={r.deadline_ms:g} passed "
                            f"{now - r.deadline_at:.3f}s before dispatch",
                )
            else:
                live.append(r)
        return live

    def _shed_unavailable(
        self,
        requests: List[ExtractionRequest],
        feature_type: str,
        breaker: CircuitBreaker,
    ) -> None:
        """The breaker opened after these requests were admitted: spool
        requests go back to their durable home, others fail transient."""
        retry = breaker.retry_after_s()
        for r in requests:
            if r.source == "spool" and self.scfg.spool_dir:
                self.tracker.requeue(r, self.scfg.spool_dir)
            else:
                self.tracker.finish(
                    r, "failed", error_class="transient",
                    message=f"model {feature_type!r} unavailable (circuit "
                            f"breaker open); retry in {retry:.1f}s",
                )

    def _rewarm(self, ext: Any, feature_type: str) -> None:
        """Half-open probe preflight: drive this feature type's declared
        ``--warmup`` pairs through the rebuilt extractor so the probe
        proves the weights end to end, not just construction. No declared
        pairs -> the probe group itself is the only proof (still end to
        end). Raises when any warm clip fails."""
        pairs = [p for p in self.scfg.warmup_pairs() if p[0] == feature_type]
        if not pairs:
            return
        wdir = os.path.join(self.cfg.output_path, "_warmup")
        os.makedirs(wdir, exist_ok=True)
        paths: List[str] = []
        for i, (_ft, w, h) in enumerate(pairs):
            clip = os.path.join(wdir, f"warm-{w}x{h}.mp4")
            if not os.path.exists(clip):
                synth_video(clip, n_frames=8, width=w, height=h, seed=i)
            paths.append(clip)
        ext.run_paths(paths, self.device)
        outcomes = ext.manifest.take()
        bad = [p for p in paths
               if outcomes.get(p, {}).get("status") != "done"]
        if bad:
            raise RuntimeError(
                f"probe re-warm failed for {len(bad)}/{len(paths)} clip(s)"
            )

    def cancel(self, request_id: str) -> Optional[Dict[str, Any]]:
        """DELETE /v1/requests/<id> (and spool ``.cancel`` files): a
        still-queued request leaves the queue as terminal ``cancelled``;
        a dispatched one is marked cancel-requested (honored at the next
        group boundary it is still queued at — extraction already on the
        device is never interrupted). Returns the record (with
        ``cancel_requested`` set when not yet terminal), or None for an
        unknown id."""
        rec = self.tracker.get(request_id)
        if rec is None:
            return None
        if rec.get("state") in TERMINAL_STATES:
            return rec
        req = self.batcher.cancel(request_id)
        if req is not None:
            return self.tracker.finish(
                req, "cancelled", error_class="cancelled",
                message="cancelled while queued",
            )
        with self._lock:
            self._cancel_pending.add(request_id)
        # the dispatcher may have finished it between our two looks; the
        # boundary sweep discards stale ids, so only re-read the record
        rec = self.tracker.get(request_id) or {"id": request_id}
        if rec.get("state") in TERMINAL_STATES:
            with self._lock:
                self._cancel_pending.discard(request_id)
            return rec
        out = dict(rec)
        out["cancel_requested"] = True
        return out

    def _finish_done(self, req: ExtractionRequest, ext: Any) -> None:
        files = expected_output_files(
            ext.feature_keys(),
            req.video_path,
            ext.output_path,
            ext.config.on_extraction,
            ext.config.output_direct,
        )
        self.tracker.finish(req, "done", features=[f for f in files if os.path.exists(f)])

    # -- warmup preflight -------------------------------------------------

    def warmup(self, pairs: Optional[Sequence[Tuple[str, int, int]]] = None) -> List[Dict[str, Any]]:
        """Load the declared models and run each declared (feature_type,
        WxH) pair before accepting traffic: synthesize a short clip at
        exactly that resolution and run it through the normal dispatch
        path. On the card this loads the weights, picks cuDNN's
        algorithms and warms the allocator, so the first user request
        pays none of it (eager PyTorch compiles nothing). Returns the
        warmup requests' terminal records."""
        pairs = list(pairs if pairs is not None else self.scfg.warmup_pairs())
        out: List[Dict[str, Any]] = []
        wdir = os.path.join(self.cfg.output_path, "_warmup")
        os.makedirs(wdir, exist_ok=True)
        for i, (ft, w, h) in enumerate(pairs):
            clip = os.path.join(wdir, f"warm-{w}x{h}.mp4")
            if not os.path.exists(clip):
                synth_video(clip, n_frames=8, width=w, height=h, seed=i)
            req = ExtractionRequest(
                feature_type=ft, video_path=clip,
                bucket=f"{w}x{h}", source="warmup",
                id=f"warmup-{ft.replace('/', '-')}-{w}x{h}",
            )
            self.tracker.admit(req)
            self._dispatch_group(req.key(), [req])
            rec = self.tracker.get(req.id) or {}
            out.append(rec)
            print(
                f"serve: warmup {ft} {w}x{h}: {rec.get('state', '?')}"
                + (f" ({rec.get('message')})" if rec.get("state") == "failed" else "")
                + f" hbm={self._warmup_hbm(ft)}"
            )
        self._check_hbm_budget()
        return out

    def _warmup_hbm(self, feature_type: str) -> str:
        """The ledger's projected resident device memory for one model,
        for the warmup line — 'n/a' when the ledger has no device-memory
        entries for it (the CPU records flops only)."""
        proj = self.ledger.hbm_projection().get(feature_type)
        return format_bytes(proj["resident"]) if proj else "n/a"

    def _check_hbm_budget(self) -> None:
        """Fail warmup fast when the projected resident set for ALL the
        resident models exceeds --hbm_budget_bytes (0 = unlimited)."""
        budget = int(self.scfg.hbm_budget_bytes or 0)
        if budget <= 0:
            return
        projected = self.ledger.projected_resident_bytes(self.scfg.feature_types)
        if projected > budget:
            raise RuntimeError(
                f"serve: projected resident HBM {format_bytes(projected)} "
                f"exceeds --hbm_budget_bytes {format_bytes(budget)} for "
                f"models {', '.join(self.scfg.feature_types)} — shrink the "
                "resident set or raise the budget"
            )

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Warmup (if declared), then open the request sources."""
        with self._lock:
            if self._started:
                return
            self._started = True
        if self.scfg.warmup:
            self.warmup()
        self.sampler.start()
        self.batcher.start()
        if self.scfg.retention_sweep_s > 0:
            self._sweep_thread = threading.Thread(
                target=self._sweep_loop, name="serve-retention", daemon=True
            )
            self._sweep_thread.start()
        if self.scfg.spool_dir is not None:
            from video_features_tpu_torch.serve.sources import SpoolWatcher

            self._spool = SpoolWatcher(
                self, self.scfg.spool_dir, poll_s=self.scfg.spool_poll_s,
                replica_id=self.replica_id,
                lease_timeout_s=self.scfg.lease_timeout_s,
                registry=self.registry,
            )
            self._spool.start()
        if self.scfg.port is not None:
            from video_features_tpu_torch.serve.server import start_http_server

            self._http_server, self._http_thread = start_http_server(
                self, self.scfg.host, self.scfg.port
            )
            host, port = self._http_server.server_address[:2]
            print(f"serve: listening on http://{host}:{port} "
                  f"(models: {', '.join(self.scfg.feature_types)})")

    @property
    def http_port(self) -> Optional[int]:
        return self._http_server.server_address[1] if self._http_server else None

    def _sweep_loop(self) -> None:
        while not self._sweep_stop.wait(self.scfg.retention_sweep_s):
            try:
                self.tracker.sweep(
                    self.scfg.request_ttl_s, self.scfg.max_request_records
                )
                self._fleet_sweep()
            except Exception:  # noqa: BLE001 - retention must not kill serving
                traceback.print_exc()

    def _fleet_sweep(self) -> None:
        """The survivors' side of fleet recovery: refresh our
        own heartbeat, export a ``replica_up`` gauge per known replica,
        and disposition requests whose owning replica is dead —
        requeue/fail via reconcile, restricted to replica-attributed
        records (``require_replica``) so a live-but-unattributed request
        is never declared a casualty mid-flight."""
        if self.scfg.lease_timeout_s <= 0:
            return
        self.registry.beat()
        timeout = self.scfg.lease_timeout_s
        ages = self.registry.ages()
        if self.telemetry.enabled:
            for rid, age in ages.items():
                self.telemetry.metrics.set_gauge(
                    f"replica_up.{rid}", 1 if age <= timeout else 0
                )
        live = {rid for rid, age in ages.items() if age <= timeout}
        live.add(self.replica_id)  # we are provably alive
        recovered = self.tracker.reconcile(
            self.scfg.spool_dir, live_replicas=live, require_replica=True
        )
        if any(recovered.values()):
            print(f"serve: fleet sweep reclaimed a dead replica's work: "
                  f"{recovered['requeued']} requeued, "
                  f"{recovered['interrupted']} interrupted")

    def status(self) -> Dict[str, Any]:
        """The /healthz body: queue depth, per-state request counts,
        which models are warm, and every circuit breaker's state (a
        breaker exists once its model has seen traffic)."""
        with self._lock:
            breakers = {ft: b.snapshot() for ft, b in sorted(self._breakers.items())}
        degraded = any(b["state"] != "closed" for b in breakers.values())
        out = {
            "status": "stopped" if self.stopped_by else "degraded" if degraded else "ok",
            "queue_depth": self.batcher.depth(),
            "max_queue": self.scfg.max_queue,
            "requests": self.tracker.counts(),
            "serving": list(self.scfg.feature_types),
            "warm": self.pool.feature_types(),
            "scheduler": self.scfg.scheduler,
            "breakers": breakers,
            "watchdog_timeouts": self.watchdog.timeouts(),
            "replica": self.replica_id,
        }
        if self.preemptor is not None:
            out["preemptor"] = self.preemptor.snapshot()
        if self.stopped_by is not None:
            out["error"] = self.stopped_by
        return out

    def stats(self) -> Dict[str, Any]:
        """The /v1/stats body: /healthz plus the SLO window digest, the
        cost model's learned per-item service times, and the raw metrics
        snapshot — the JSON twin of /metrics."""
        out = self.status()
        out["uptime_s"] = round(max(self.clock() - self._start_mono, 0.0), 3)
        out["slo"] = self.slo.snapshot()
        out["cost_model"] = self.cost_model.snapshot()
        out["metrics"] = self.telemetry.metrics.snapshot()
        out["ledger"] = self.ledger.snapshot()
        hits, misses = self._cache_counts(out["metrics"])
        out["cache"] = {
            "enabled": self.cache is not None,
            "hits": hits,
            "misses": misses,
            "hit_rate": round(hits / (hits + misses), 4) if hits + misses else 0.0,
        }
        if self._frame_cache is not None:
            out["cache"]["frame_cache"] = self._frame_cache.stats()
        return out

    @staticmethod
    def _cache_counts(snapshot: Dict[str, Any]) -> Tuple[int, int]:
        """(hits, misses) summed over feature types from a metrics
        snapshot's ``cache_hit.<ft>`` / ``cache_miss.<ft>`` counters."""
        counters = snapshot.get("counters", {})
        hits = int(sum(
            v for k, v in counters.items() if k.startswith("cache_hit.")
        ))
        misses = int(sum(
            v for k, v in counters.items() if k.startswith("cache_miss.")
        ))
        return hits, misses

    def metrics_text(self) -> str:
        """The /metrics body: Prometheus text exposition (format 0.0.4)
        of the registry snapshot (request counters, queue gauges, stage
        and group service-time histograms) plus the serve-native
        families rendered directly from live daemon state (breakers,
        SLO quantiles, uptime, watchdog)."""
        fams = families_from_snapshot(self.telemetry.metrics.snapshot())
        fams.extend(families_from_ledger(self.ledger.snapshot()))
        fams.extend(self._serve_families())
        return render_families(fams)

    _BREAKER_STATE_CODE = {"closed": 0, "half-open": 1, "half_open": 1, "open": 2}

    def _serve_families(self) -> List[Family]:
        """Exposition families computed from live state rather than the
        metrics registry: circuit breakers, the rolling SLO window, and
        daemon uptime."""
        with self._lock:
            breakers = {ft: b.snapshot() for ft, b in sorted(self._breakers.items())}
        f_state = Family(
            "vft_breaker_state", "gauge",
            "Circuit breaker state per feature type (0=closed 1=half-open 2=open).",
        )
        f_opens = Family(
            "vft_breaker_opens_total", "counter",
            "Times each feature type's circuit breaker has opened.",
        )
        for ft, b in breakers.items():
            labels = {"feature_type": ft}
            f_state.add(labels, self._BREAKER_STATE_CODE.get(b["state"], 2))
            f_opens.add(labels, b.get("opens", 0))
        f_lat = Family(
            "vft_slo_latency_seconds", "gauge",
            "Rolling-window end-to-end request latency quantiles per priority tier.",
        )
        f_wait = Family(
            "vft_slo_queue_wait_seconds", "gauge",
            "Rolling-window queue-wait quantiles per priority tier.",
        )
        f_miss = Family(
            "vft_slo_deadline_miss_ratio", "gauge",
            "Rolling-window deadline-miss rate per priority tier "
            "(denominator: done/failed/expired requests).",
        )
        f_n = Family(
            "vft_slo_window_requests", "gauge",
            "Terminal requests inside the rolling SLO window per priority tier.",
        )
        slo = self.slo.snapshot()
        digests = {"overall": slo["overall"], **slo["tiers"]}
        quantiles = {"p50": "0.5", "p95": "0.95", "p99": "0.99"}
        for tier, d in sorted(digests.items()):
            for q, qlabel in quantiles.items():
                ql = {"tier": tier, "quantile": qlabel}
                f_lat.add(ql, d["latency_s"][q])
                f_wait.add(ql, d["queue_wait_s"][q])
            f_miss.add({"tier": tier}, d["miss_rate"])
            f_n.add({"tier": tier}, d["count"])
        f_up = Family("vft_uptime_seconds", "gauge",
                      "Seconds since the serve daemon constructed.")
        f_up.add(None, max(self.clock() - self._start_mono, 0.0))
        f_wd = Family("vft_watchdog_timeouts_total", "counter",
                      "Dispatch groups abandoned by the group watchdog.")
        f_wd.add(None, self.watchdog.timeouts())
        return [f_state, f_opens, f_lat, f_wait, f_miss, f_n, f_up, f_wd]

    def _heartbeat_line(self) -> str:
        """The serve heartbeat (replaces the batch videos/s line): queue
        depth + oldest wait, inflight groups, completion rate since the
        last beat, rolling deadline-miss rate, and any non-closed
        breakers. Runs on the telemetry drain thread."""
        now = self.clock()
        snap = self.telemetry.metrics.snapshot()
        completed = int(sum(
            snap["counters"].get(f"requests_{s}", 0)
            for s in ("done", "failed", "expired", "cancelled", "rejected")
        ))
        prev_t, prev_n = self._hb_prev
        self._hb_prev = (now, completed)
        rate = (completed - prev_n) / max(now - prev_t, 1e-9)
        inflight = int(snap["gauges"].get("groups_inflight", 0))
        with self._lock:
            open_breakers = sorted(
                ft for ft, b in self._breakers.items()
                if b.snapshot()["state"] != "closed"
            )
        line = (
            f"serve: queue={self.batcher.depth()} "
            f"oldest_wait={self.batcher.oldest_wait_s():.1f}s "
            f"inflight={inflight} completed/s={rate:.2f} "
            f"miss_rate={self.slo.miss_rate():.1%}"
        )
        if self.cache is not None:
            hits, misses = self._cache_counts(snap)
            total = hits + misses
            line += (
                f" cache_hit_rate={hits / total:.1%}" if total
                else " cache_hit_rate=n/a"
            )
        if open_breakers:
            line += " breakers_open=" + ",".join(open_breakers)
        headroom = snap["gauges"].get("device_mem_headroom_bytes")
        if headroom is not None:
            line += f" hbm_headroom={format_bytes(int(headroom))}"
        return line

    def shutdown(self, drain: bool = True) -> None:
        """Stop sources, drain (default) or durably disposition the
        backlog, close telemetry, and write the final summary.json.
        ``drain=False`` must still leave every undispatched request with
        a durable record: spool requests go back to the spool (the next
        daemon re-admits them under the same id), others are ``failed``
        interrupted — never silently stranded."""
        if self._http_server is not None:
            self._http_server.shutdown()
            self._http_server.server_close()
            if self._http_thread is not None:
                self._http_thread.join()
            self._http_server = None
            self._http_thread = None
        with self._lock:
            spool, self._spool = self._spool, None
        if spool is not None:
            spool.stop()
        self._stop_sweep()
        self.sampler.stop()  # idempotent; no-op when start() never ran
        self._disposition_undispatched(self.batcher.close(drain=drain))
        self.pool.close()
        # clean exit: drop the heartbeat so surviving replicas reclaim
        # anything we still lease immediately, not after a lease timeout
        self.registry.retire()
        if self._frame_cache is not None:
            # uninstall the shared-decode hook: a later daemon (or batch
            # run) in this process must not replay this daemon's frames
            set_frame_cache(None)
            self._frame_cache = None
        try:
            # persist the learned service times so the next daemon's
            # edf-cost scheduler starts warm
            self.cost_model.save()
        except OSError:
            pass
        self.telemetry.close()
        try:
            # two summaries: per-video extraction records (the pooled
            # extractors' manifest under <output>/_manifest) and the
            # per-request lifecycle records (<output>/_requests/_manifest)
            summary = faults.finalize_run(self.cfg.output_path)
            if summary is not None:
                print(faults.format_summary(summary))
            req_summary = faults.finalize_run(self.tracker.results_dir)
            if req_summary is not None:
                print("requests: " + faults.format_summary(req_summary))
        except Exception:  # noqa: BLE001 - shutdown must finish
            traceback.print_exc()


def serve_main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m video_features_tpu_torch serve [warmup] ...`` — parse,
    build, run; returns the process's exit code.

    ``serve warmup`` runs the declared warmup pairs and exits; plain
    ``serve`` warms (if ``--warmup`` pairs are declared) and then serves
    until SIGTERM/SIGINT (0), or until a sticky device error stops it
    (1, so that a supervisor restarts the process)."""
    scfg = parse_serve_args(argv)
    daemon = ServeDaemon(scfg)
    if scfg.warmup_only:
        results = daemon.warmup()
        daemon.shutdown()
        failed = [r for r in results if r.get("state") != "done"]
        if failed:
            raise SystemExit(f"serve warmup: {len(failed)}/{len(results)} pair(s) failed")
        return 0
    daemon.start()
    run_until_signalled(daemon)
    if daemon.stopped_by is not None:
        print(f"serve: exiting 1 after a sticky device error: {daemon.stopped_by}")
        return 1
    return 0


def run_until_signalled(daemon: ServeDaemon) -> None:
    """Serve until SIGTERM / SIGINT, then drain and shut down.

    SIGTERM used to kill the process mid-flight: only KeyboardInterrupt
    reached the old ``finally``, so ``kill <pid>`` (every process
    supervisor's stop signal) lost the final telemetry flush, the
    request summary, and the cost-model save. Both signals now funnel
    into one Event and :meth:`ServeDaemon.shutdown` runs in a
    ``finally``. Handler installation is guarded so tests can call this
    off the main thread (where ``signal.signal`` raises ValueError) and
    deliver the signal themselves. A sticky device error sets the same
    Event (``ServeDaemon._stop_on_sticky``); the shutdown then does not
    drain, since no later group could run."""
    stop = daemon.stop_requested

    def _handler(signum: int, frame: Any) -> None:
        print(f"serve: received signal {signum}; draining and shutting down")
        stop.set()

    installed: List[Tuple[int, Any]] = []
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            installed.append((sig, signal.signal(sig, _handler)))
        except ValueError:
            pass
    try:
        stop.wait()
    except KeyboardInterrupt:
        print("serve: interrupted; draining and shutting down")
    finally:
        for sig, prev in installed:
            try:
                signal.signal(sig, prev)
            except ValueError:
                pass
        daemon.shutdown(drain=daemon.stopped_by is None)
