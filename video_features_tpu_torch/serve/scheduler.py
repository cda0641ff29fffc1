"""Cross-key dispatch ordering for the serve daemon.

Counterpart of ``video_features_tpu/serve/scheduler.py``, copied as it
is (stdlib only). The dispatcher does not run ready groups in arrival
order: this module owns the dispatch ORDER across keys (the scheduler,
not the extractor, decides what reaches the device next), implementing
earliest-effective-deadline-first with priority tiers and
anti-starvation aging:

- every request carries an optional ``deadline_ms`` (stamped to an
  absolute ``deadline_at`` on the admission clock when admitted) and a
  ``priority`` tier (0..9, higher = more urgent);
- a ready group's *effective deadline* is the earliest deadline of its
  members; deadline-less members count as ``admitted_at +
  default_slack_s``, so best-effort traffic still ages toward the front
  instead of starving behind an endless deadline stream;
- groups rank by ``(effective priority tier desc, effective deadline
  asc, arrival)``; a group's tier is its most urgent member's, boosted
  one tier per ``aging_s`` its oldest member has waited — so a tier-0
  backlog can never be starved by a steady tier-9 stream (after at most
  ``9 * aging_s`` of waiting, any group reaches the top tier).

Everything here is a pure function of ``(groups, now)``: the batcher
calls :meth:`pick` under its own lock with its own (injectable) clock,
and the fake-clock tests drive the same code with synthetic groups — no
threads, no sleeps. ``fifo`` is the arrival-order baseline.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

# a group, as the batcher stores it: ((feature_type, bucket), [requests]).
# Duplicated shape (not imported from batcher) to keep this module
# import-light and cycle-free — batcher imports the scheduler.
Group = Tuple[Tuple[str, str], List[Any]]

# aging can promote a group at most this many tiers past its declared
# priority: enough to clear the 0..9 request range with room to spare,
# finite so an infinitely-old group (or a now=inf drain sweep) ranks
# deterministically instead of overflowing
MAX_AGING_BOOST = 16

SCHEDULER_NAMES = ("edf", "fifo", "edf-cost")


class EdfScheduler:
    """Earliest-effective-deadline-first across (feature_type, bucket)
    keys, with priority tiers and aging. Stateless between calls: rank
    is recomputed at each pick so aging reflects *dispatch-time* wait,
    not admission-time."""

    name = "edf"

    def __init__(self, default_slack_s: float = 30.0, aging_s: float = 10.0) -> None:
        self.default_slack_s = max(float(default_slack_s), 0.0)
        self.aging_s = float(aging_s)

    # -- rank components -------------------------------------------------

    def effective_deadline(self, requests: Sequence[Any], now: float) -> float:
        """Earliest member deadline; deadline-less members count as
        ``admitted_at + default_slack_s`` so they participate in EDF
        instead of sorting last forever."""
        best: float = float("inf")
        for r in requests:
            d = getattr(r, "deadline_at", None)
            if d is None:
                t0 = getattr(r, "admitted_at", None)
                d = (now if t0 is None else t0) + self.default_slack_s
            if d < best:
                best = d
        return now if best == float("inf") else best

    def _aging_boost(self, requests: Sequence[Any], now: float) -> int:
        if self.aging_s <= 0:
            return 0
        oldest = min(
            (t for r in requests
             if (t := getattr(r, "admitted_at", None)) is not None),
            default=None,
        )
        if oldest is None:
            return 0
        wait = now - oldest
        if wait >= self.aging_s * MAX_AGING_BOOST:
            return MAX_AGING_BOOST
        return int(wait / self.aging_s) if wait > 0 else 0

    def rank(self, group: Group, now: float) -> Tuple[float, float]:
        """Smaller ranks dispatch first. Priority tier (aged) dominates;
        effective deadline breaks ties within a tier; callers break
        remaining ties by arrival order (stable index)."""
        _key, requests = group
        tier = max((int(getattr(r, "priority", 0) or 0) for r in requests), default=0)
        tier += self._aging_boost(requests, now)
        return (-float(tier), self.effective_deadline(requests, now))

    # -- the batcher's surface -------------------------------------------

    def pick(self, groups: Sequence[Group], now: float) -> int:
        """Index of the group to dispatch next (``groups`` non-empty;
        index tie-break = arrival order, since the batcher appends ready
        groups in the order they became ready)."""
        return min(range(len(groups)), key=lambda i: (self.rank(groups[i], now), i))

    def order(self, groups: Sequence[Group], now: float) -> List[Group]:
        """All groups, best-first — the inline-drain and test surface."""
        idx = sorted(range(len(groups)), key=lambda i: (self.rank(groups[i], now), i))
        return [groups[i] for i in idx]


class FifoScheduler(EdfScheduler):
    """Arrival order only: the A/B baseline EDF is compared against."""

    name = "fifo"

    def rank(self, group: Group, now: float) -> Tuple[float, float]:
        return (0.0, 0.0)  # callers' index tie-break IS the order


class CostAwareEdfScheduler(EdfScheduler):
    """EDF with a calibrated service-time model (``--scheduler
    edf-cost``): rank by *latest feasible start time* and demote groups
    that cannot meet their deadline anyway.

    Plain EDF's overload pathology on a serial non-preemptive machine:
    the earliest deadline may belong to a group so expensive it is
    already doomed — running it first burns its whole service time AND
    dominoes every cheap group behind it past their own deadlines. Note
    that pure least-laxity (``deadline - predicted``) makes this
    *worse*: a doomed expensive group has the most negative laxity, so
    it ranks MORE urgent, and total work is conserved — reordering only
    renames which requests miss. The win comes from feasibility:

    - a group is **doomed** when ``now + predicted_service`` already
      exceeds its earliest *declared* member deadline (slack-derived
      effective deadlines never doom a group — missing them is a
      soft ordering preference, not a contract);
    - feasible groups rank by (aged priority tier desc, latest start
      time ``effective_deadline - predicted_service`` asc) — the group
      that must start soonest to still make it goes first, which is
      exactly EDF when predictions are equal (and exactly EDF with 0.0
      predictions, i.e. a cold :class:`~video_features_tpu_torch.serve.
      costmodel.ServiceTimeModel`);
    - doomed groups sort behind every feasible group (still mutually
      ordered by tier + latest-start), so their members expire at the
      dispatch boundary or run late — after the work that can still
      meet its promises.

    The model's ``predict`` is consulted under the batcher's condition
    variable; it takes only the model's own lock and does no I/O (the
    nesting batcher-cond -> model-lock is acyclic — nothing in costmodel
    calls back into the batcher)."""

    name = "edf-cost"

    def __init__(
        self,
        cost_model: Any,
        default_slack_s: float = 30.0,
        aging_s: float = 10.0,
    ) -> None:
        super().__init__(default_slack_s=default_slack_s, aging_s=aging_s)
        self.cost_model = cost_model

    def predicted_service_s(self, group: Group, now: float) -> float:
        key, requests = group
        try:
            return max(float(self.cost_model.predict(key, len(requests)) or 0.0), 0.0)
        except Exception:  # noqa: BLE001 - a broken model must not stop dispatch
            return 0.0

    @staticmethod
    def _earliest_declared_deadline(requests: Sequence[Any]) -> Optional[float]:
        best: Optional[float] = None
        for r in requests:
            d = getattr(r, "deadline_at", None)
            if d is not None and (best is None or d < best):
                best = d
        return best

    def rank(self, group: Group, now: float) -> Tuple[float, float, float]:
        neg_tier, eff_deadline = super().rank(group, now)
        pred = self.predicted_service_s(group, now)
        declared = self._earliest_declared_deadline(group[1])
        doomed = 1.0 if (
            pred > 0.0 and declared is not None and now + pred > declared
        ) else 0.0
        return (doomed, neg_tier, eff_deadline - pred)


def build_scheduler(
    name: str,
    default_slack_s: float = 30.0,
    aging_s: float = 10.0,
    cost_model: Any = None,
) -> EdfScheduler:
    if name not in SCHEDULER_NAMES:
        raise ValueError(f"unknown scheduler {name!r} (expected one of {SCHEDULER_NAMES})")
    if name == "edf-cost":
        if cost_model is None:
            from video_features_tpu_torch.serve.costmodel import ServiceTimeModel

            cost_model = ServiceTimeModel()
        return CostAwareEdfScheduler(
            cost_model, default_slack_s=default_slack_s, aging_s=aging_s
        )
    cls = FifoScheduler if name == "fifo" else EdfScheduler
    return cls(default_slack_s=default_slack_s, aging_s=aging_s)

