"""HBM-aware extractor preemption: make room instead of rejecting.

Counterpart of ``video_features_tpu/serve/preemptor.py``, copied as it is
(stdlib only). A mixed-model burst whose projected footprint cannot fit
beside the resident set would otherwise get a 503 (the
``--hbm_budget_bytes`` warmup gate) or an out-of-memory gamble; the cost
ledger (``telemetry/ledger.py``) prices every resident model, and the
:class:`Preemptor` acts on the price at admission time:

- **Fit check** (:meth:`check`): a non-resident feature type's projected
  resident bytes (``CostLedger.hbm_projection`` — arguments maxed,
  generated code summed, the JAX package's approximation) are compared
  against live headroom: the ``device_mem_headroom_bytes`` gauge when
  the sampler runs, else ``--hbm_budget_bytes`` minus the projected
  resident set. No projection for the model (CPU platform entries
  project nothing, by design) or no headroom signal -> ``"unknown"``:
  preemption quietly disables itself, it never guesses and never crashes.
- **Value ranking** (:meth:`value_score`): residents are scored by
  (1 + max queued priority tier) x (1 + queued count x ServiceTimeModel
  demand EWMA) x (1 + the model's ledger entry count): the victim is the
  model whose eviction forfeits the least queued value and the least
  rebuild cost. Ties break lexicographically by feature type, so
  equal-value ranking is stable across runs.
- **Teardown through the breaker** (:meth:`ensure_room`): each victim is
  evicted from the pool AND its breaker is force-opened
  (:meth:`~video_features_tpu_torch.serve.supervisor.CircuitBreaker.trip`),
  so its traffic defers (503 / spool backoff) instead of racing a rebuild
  into the memory it just freed; the re-warm rides the normal cooldown ->
  half-open -> probe path. A ``preempted`` manifest event per victim and
  a ``rewarmed`` event when the probe closes the breaker make the trail
  durable.
- **Hysteresis**: a global ``--preempt_cooldown_s`` between preemptions
  plus a per-model min-residency guard (``--preempt_min_residency_s``
  since the victim's build) bound thrash — two bursts can trade 503s,
  they cannot trade evictions faster than the cooldown.
- **Rollback** (:meth:`rollback`): if the beneficiary's build fails, the
  plan's victims get their breakers force-closed so the pre-preemption
  resident set rebuilds on demand — the daemon never ends up with BOTH
  models down because one gamble failed.

``hbm_squeeze`` fault stage: an injected raise at the headroom read
collapses observed headroom to 0, forcing the overcommit path without a
real wall — the tests drive preemption on the CPU that way.

No torch import; everything here runs on admission (source/HTTP) threads.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from video_features_tpu_torch.runtime import faults as faults_mod
from video_features_tpu_torch.serve.lifecycle import DEFAULT_BUCKET


class PreemptionPlan:
    """The rollback token :meth:`Preemptor.ensure_room` returns: which
    residents were sacrificed for which beneficiary, and when."""

    def __init__(self, beneficiary: str, victims: List[str], at: float) -> None:
        self.beneficiary = beneficiary
        self.victims = list(victims)
        self.at = float(at)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"PreemptionPlan(beneficiary={self.beneficiary!r}, "
                f"victims={self.victims!r})")


class Preemptor:
    """Admission-time HBM arbiter over the resident extractor pool.

    Collaborators are injected (ledger, cost model, pool, a
    ``breaker_for(ft)`` accessor, a headroom callable, a queued-work
    callable, a clock), so the ranking/fit logic is testable without a
    daemon or a device."""

    def __init__(
        self,
        ledger: Any,
        cost_model: Any,
        pool: Any,
        breaker_for: Callable[[str], Any],
        headroom_fn: Optional[Callable[[], Optional[int]]] = None,
        queued_fn: Optional[Callable[[], Dict[str, Dict[str, Any]]]] = None,
        hbm_budget_bytes: int = 0,
        cooldown_s: float = 30.0,
        min_residency_s: float = 60.0,
        clock: Callable[[], float] = time.monotonic,
        metrics: Any = None,
        manifest: Any = None,
    ) -> None:
        self.ledger = ledger
        self.cost_model = cost_model
        self.pool = pool
        self.breaker_for = breaker_for
        self.headroom_fn = headroom_fn
        self.queued_fn = queued_fn
        self.hbm_budget_bytes = max(int(hbm_budget_bytes or 0), 0)
        self.cooldown_s = max(float(cooldown_s), 0.0)
        self.min_residency_s = max(float(min_residency_s), 0.0)
        self._clock = clock
        self._metrics = metrics
        self._manifest = manifest
        self._lock = threading.Lock()
        self._last_preempt: Optional[float] = None
        self._preemptions = 0  # lifetime count, for /healthz

    # -- fit check -------------------------------------------------------

    def _headroom(self) -> Optional[int]:
        """Live headroom bytes, or None when there is no signal. The
        ``hbm_squeeze`` chaos stage collapses it to 0 — the fake device-
        memory emergency the overcommit tests are built on."""
        try:
            faults_mod.fire("hbm_squeeze")
        except Exception:  # noqa: BLE001 - any injected kind means 'squeezed'
            return 0
        if self.headroom_fn is not None:
            h = self.headroom_fn()
            if h is not None:
                return int(h)
        if self.hbm_budget_bytes > 0:
            resident = self.pool.feature_types()
            return self.hbm_budget_bytes - int(
                self.ledger.projected_resident_bytes(resident)
            )
        return None

    def check(self, feature_type: str) -> Tuple[str, int, Optional[int]]:
        """``(verdict, needed_bytes, available_bytes)`` for admitting one
        request of ``feature_type``. Verdicts: ``"fits"`` (resident
        already, or projected to fit), ``"overcommit"`` (projected NOT to
        fit), ``"unknown"`` (no projection or no headroom signal — CPU
        backends land here and preemption stays out of the way)."""
        if feature_type in self.pool.feature_types():
            return ("fits", 0, None)
        proj = self.ledger.hbm_projection().get(feature_type)
        if not proj:
            return ("unknown", 0, None)
        needed = int(proj.get("resident", 0))
        available = self._headroom()
        if available is None:
            return ("unknown", needed, None)
        return ("fits" if needed <= available else "overcommit",
                needed, available)

    # -- value ranking ---------------------------------------------------

    def value_score(self, feature_type: str) -> float:
        """How much the fleet loses by evicting this resident now. See
        the module docstring for the three factors; all three floor at
        1.0 so an idle, cold, priority-0 model scores exactly 1.0 and
        equal-value ties rank purely by name (stable)."""
        stats = {}
        if self.queued_fn is not None:
            stats = self.queued_fn().get(feature_type, {}) or {}
        priority = 1.0 + float(stats.get("max_priority", 0) or 0)
        count = int(stats.get("count", 0) or 0)
        buckets = list(stats.get("buckets", [])) or [DEFAULT_BUCKET]
        demand_s = sum(
            float(self.cost_model.predict((feature_type, b), 1))
            for b in buckets
        ) / max(len(buckets), 1)
        demand = 1.0 + count * demand_s
        warm = 1 + sum(
            1 for e in self.ledger.entries()
            if e.get("model") == feature_type
        )
        return priority * demand * warm

    def _candidates(self, beneficiary: str, now: float) -> List[str]:
        """Residents eligible for eviction: not the beneficiary, and
        resident longer than the min-residency guard (a just-built model
        being torn down before serving a single group is pure thrash)."""
        built_at = getattr(self.pool, "built_at", {})
        out = []
        for ft in self.pool.feature_types():
            if ft == beneficiary:
                continue
            at = built_at.get(ft)
            if at is not None and now - at < self.min_residency_s:
                continue
            out.append(ft)
        return out

    # -- the preemption itself -------------------------------------------

    def ensure_room(self, feature_type: str) -> Optional[PreemptionPlan]:
        """Try to make the overcommitted ``feature_type`` fit by evicting
        the lowest-value residents. Returns the :class:`PreemptionPlan`
        when victims were sacrificed, None when nothing was done — which
        the caller must re-:meth:`check` to distinguish "already fits"
        from "could not help" (cooldown, no eligible victims, or not
        enough reclaimable bytes)."""
        verdict, needed, available = self.check(feature_type)
        if verdict != "overcommit":
            return None
        now = self._clock()
        with self._lock:
            if (
                self._last_preempt is not None
                and now - self._last_preempt < self.cooldown_s
            ):
                return None  # hysteresis: one preemption per cooldown
            proj = self.ledger.hbm_projection()
            candidates = self._candidates(feature_type, now)
            candidates.sort(key=lambda ft: (self.value_score(ft), ft))
            victims: List[str] = []
            reclaimed = 0
            for ft in candidates:
                if needed <= (available or 0) + reclaimed:
                    break
                victims.append(ft)
                reclaimed += int(proj.get(ft, {}).get("resident", 0))
            if needed > (available or 0) + reclaimed:
                return None  # even a full sweep cannot fit it: reject
            self._last_preempt = now
            self._preemptions += len(victims)
        for victim in victims:
            # trip FIRST: the victim's admissions start deferring before
            # its extractor vanishes, so no request can slip into a
            # build-race against the beneficiary
            self.breaker_for(victim).trip()
            self.pool.evict(victim)
            if self._metrics is not None:
                self._metrics.inc(f"preemptions.{victim}")
            if self._manifest is not None:
                self._manifest.event(
                    "preempted", feature_type=victim,
                    beneficiary=feature_type, value=round(
                        self.value_score(victim), 4),
                )
        return PreemptionPlan(feature_type, victims, now)

    def rollback(self, plan: PreemptionPlan) -> None:
        """The beneficiary's build failed: hand the evicted victims
        their slots back by force-closing their breakers — the next
        request rebuilds each on demand (warm compile cache), restoring
        the pre-preemption resident set without a cooldown penalty."""
        for victim in plan.victims:
            self.breaker_for(victim).force_close()
            if self._manifest is not None:
                self._manifest.event(
                    "preemption_rollback", feature_type=victim,
                    beneficiary=plan.beneficiary,
                )

    def snapshot(self) -> Dict[str, Any]:
        """The /healthz block."""
        with self._lock:
            return {
                "preemptions": self._preemptions,
                "cooldown_s": self.cooldown_s,
                "min_residency_s": self.min_residency_s,
            }


def simulate_overcommit(
    preemptor: Optional[Preemptor],
    bursts: Sequence[Tuple[str, int]],
    resident_fits: Callable[[str], bool],
    service_s: float = 1.0,
    deadline_s: float = 2.5,
    rewarm_s: float = 0.5,
) -> List[Dict[str, Any]]:
    """Deterministic replay of a mixed-model burst against an HBM wall
    (the JAX package's ``serve_preemption`` bench part and the pinned A/B
    tests).

    ``bursts`` is ``[(feature_type, n_requests), ...]`` in arrival
    order; ``resident_fits(ft)`` says whether ``ft`` fits WITHOUT
    preemption (the wall). A burst that fits dispatches as one fused
    group: every member's latency is ``service_s``. A burst that does
    not fit either clears the wall through ``preemptor.ensure_room``
    (preemption ON — its first group additionally pays the ``rewarm_s``
    eviction + rebuild toll) or, with no preemptor (preemption OFF —
    today's behavior), every member is rejected and scored as a
    deadline miss at ``deadline_s``. Returns one record per request:
    ``{"feature_type", "met", "latency_s"}``."""
    out: List[Dict[str, Any]] = []
    room: Dict[str, bool] = {}
    toll: Dict[str, float] = {}
    for ft, n in bursts:
        fits = room.get(ft)
        if fits is None:
            fits = bool(resident_fits(ft))
            toll[ft] = 0.0
            if not fits and preemptor is not None:
                if preemptor.ensure_room(ft) is not None \
                        or preemptor.check(ft)[0] == "fits":
                    fits = True
                    toll[ft] = float(rewarm_s)
            room[ft] = fits
        latency = float(service_s) + toll.get(ft, 0.0)
        toll[ft] = 0.0  # only the first fused group pays the re-warm
        for _ in range(int(n)):
            out.append({
                "feature_type": ft,
                "met": bool(fits) and latency <= deadline_s,
                "latency_s": round(latency if fits else deadline_s, 6),
            })
    return out
