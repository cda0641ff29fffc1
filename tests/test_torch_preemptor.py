"""The port's HBM-aware preemption (``serve/preemptor.py`` and its wiring in
``serve/daemon.py``) against the JAX package's.

- A differential over the JAX package's preemptor scenarios
  (``tests/test_fleet.py``): the same fake pool, ledger, breakers, clock,
  headroom and queued work drive both packages' ``Preemptor``; every
  verdict, victim list, plan, breaker state, counter, manifest event and
  snapshot along the way is recorded, and the two records are equal.
  ``simulate_overcommit`` gives equal per-request records with and
  without a preemptor.
- The daemon's admission gate, eviction and rollback on the small CLIP
  tower with ``--cpu`` (``CLIP-ViT-B/32`` and ``CLIP-ViT-B/16`` both the
  small tower), mirroring the JAX package's daemon cases: the same
  requests through both packages' daemons end in the same states, with
  the same breakers, ``preempted`` / ``preemption_rollback`` events,
  ``preemptions.`` counters and ``preemptor`` status block.

Tolerance: exact (every compared value is a string, an int or a float
computed by the same arithmetic).
"""

import types

import pytest

from video_features_tpu.config import parse_serve_args as jax_parse_serve_args
from video_features_tpu.extract.registry import build_extractor as jax_build_extractor
from video_features_tpu.models.clip import model as jax_model
from video_features_tpu.runtime import faults as jax_faults
from video_features_tpu.runtime import telemetry as jtm
from video_features_tpu.serve import costmodel as jax_costmodel
from video_features_tpu.serve import lifecycle as jax_lifecycle
from video_features_tpu.serve import preemptor as jax_preemptor
from video_features_tpu.serve import supervisor as jax_supervisor
from video_features_tpu.serve.daemon import ServeDaemon as JaxServeDaemon
from video_features_tpu.telemetry import ledger as jax_ledger
from video_features_tpu_torch.config import parse_serve_args
from video_features_tpu_torch.extract.registry import build_extractor
from video_features_tpu_torch.models.clip import model as port_model
from video_features_tpu_torch.runtime import faults
from video_features_tpu_torch.runtime import telemetry as tm
from video_features_tpu_torch.serve import costmodel, lifecycle, preemptor, supervisor
from video_features_tpu_torch.serve.daemon import ServeDaemon
from video_features_tpu_torch.telemetry import ledger
from video_features_tpu_torch.utils.synth import synth_video

from test_torch_clip import SMALL
from torch_threads import one_torch_thread  # noqa: F401 - an autouse fixture

pytestmark = pytest.mark.serve

PORT = types.SimpleNamespace(
    Preemptor=preemptor.Preemptor, simulate_overcommit=preemptor.simulate_overcommit,
    CostLedger=ledger.CostLedger, CircuitBreaker=supervisor.CircuitBreaker,
    ServiceTimeModel=costmodel.ServiceTimeModel, MetricsRegistry=tm.MetricsRegistry,
    faults=faults)
JAX = types.SimpleNamespace(
    Preemptor=jax_preemptor.Preemptor, simulate_overcommit=jax_preemptor.simulate_overcommit,
    CostLedger=jax_ledger.CostLedger, CircuitBreaker=jax_supervisor.CircuitBreaker,
    ServiceTimeModel=jax_costmodel.ServiceTimeModel, MetricsRegistry=jtm.MetricsRegistry,
    faults=jax_faults)


@pytest.fixture(autouse=True)
def _clear_global_state():
    yield
    faults.install_injector(None)
    jax_faults.install_injector(None)
    tm.set_current(None)
    jtm.set_current(None)


# --- the preemptor, both packages through the same scenarios -------------------

class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class FakePool:
    def __init__(self, residents=(), built_at=None):
        self._resident = set(residents)
        self.built_at = dict(built_at or {})
        self.evicted = []

    def feature_types(self):
        return set(self._resident)

    def evict(self, ft):
        self._resident.discard(ft)
        self.built_at.pop(ft, None)
        self.evicted.append(ft)


class EventLog:
    def __init__(self):
        self.log = []

    def event(self, name, **fields):
        self.log.append((name, dict(fields)))


class Harness:
    """One package's preemptor with its collaborators, and the record of
    everything the scenario observed."""

    def __init__(self, pkg, entries, residents, built_at=None, headroom=None, queued=None,
                 budget=0, cooldown_s=0.0, min_residency_s=0.0, t=0.0, platform="cuda"):
        self.pkg = pkg
        self.clock = FakeClock(t)
        self.ledger = pkg.CostLedger(path=None)
        for model, resident in entries.items():
            self.ledger.record(model, "fam", "64x48", "queue", platform,
                               {"memory": {"argument_bytes": int(resident)}})
        self.pool = FakePool(residents, built_at)
        self.breakers = {}
        self.metrics = pkg.MetricsRegistry()
        self.events = EventLog()
        self.p = pkg.Preemptor(
            ledger=self.ledger, cost_model=pkg.ServiceTimeModel(path=None), pool=self.pool,
            breaker_for=lambda ft: self.breakers.setdefault(
                ft, pkg.CircuitBreaker(clock=self.clock)),
            headroom_fn=(lambda: headroom) if headroom is not None else None,
            queued_fn=(lambda: queued) if queued is not None else None,
            hbm_budget_bytes=budget, cooldown_s=cooldown_s, min_residency_s=min_residency_s,
            clock=self.clock, metrics=self.metrics, manifest=self.events)
        self.record = []

    def check(self, ft):
        self.record.append(("check", ft, self.p.check(ft)))

    def ensure(self, ft):
        plan = self.p.ensure_room(ft)
        self.record.append(("ensure", ft, None if plan is None else
                            (plan.beneficiary, plan.victims, plan.at)))
        return plan

    def score(self, ft):
        self.record.append(("score", ft, self.p.value_score(ft)))

    def done(self):
        self.record.append(("pool", sorted(self.pool.feature_types()), self.pool.evicted))
        self.record.append(("breakers", {ft: b.snapshot() for ft, b in self.breakers.items()}))
        self.record.append(("counters", self.metrics.snapshot()["counters"]))
        self.record.append(("events", self.events.log))
        self.record.append(("snapshot", self.p.snapshot()))
        return self.record


def unknown_without_projection(pkg):
    h = Harness(pkg, {}, {"a"}, headroom=0)
    h.ledger.record("m_cpu", "fam", "64x48", "queue", "cpu",
                    {"memory": {"argument_bytes": 10**9}})  # cpu: projects nothing
    h.check("m_cpu"), h.ensure("m_cpu"), h.score("m_cpu")
    return h.done()


def unknown_without_headroom(pkg):
    h = Harness(pkg, {"b": 500}, {"a"})  # no headroom signal, no budget
    h.check("b"), h.ensure("b")
    return h.done()


def resident_always_fits(pkg):
    h = Harness(pkg, {"a": 500}, {"a"}, headroom=0)
    h.check("a")
    return h.done()


def evicts_lowest_value(pkg):
    # b has queued work (priority 5); a is idle -> a is the victim
    queued = {"b": {"count": 3, "max_priority": 5, "buckets": ["64x48"]}}
    h = Harness(pkg, {"a": 400, "b": 400, "c": 500}, {"a", "b"},
                built_at={"a": 0.0, "b": 0.0}, headroom=200, queued=queued, t=100.0)
    h.score("a"), h.score("b"), h.check("c"), h.ensure("c"), h.check("c")
    return h.done()


def equal_value_tie_breaks_by_name(pkg):
    h = Harness(pkg, {"x": 400, "m": 400, "z": 400, "new": 300}, {"z", "x", "m"},
                headroom=0, t=100.0)
    h.score("x"), h.score("m"), h.score("z"), h.ensure("new")
    return h.done()


def min_residency_guard(pkg):
    h = Harness(pkg, {"a": 400, "b": 400}, {"a"}, built_at={"a": 95.0}, headroom=0,
                min_residency_s=60.0, t=100.0)
    h.ensure("b")  # a was built 5 s ago: too young to thrash
    h.clock.t = 200.0
    h.ensure("b")
    return h.done()


def cooldown_hysteresis(pkg):
    h = Harness(pkg, {"a": 400, "b": 400, "c": 400}, {"a", "b"}, headroom=0, cooldown_s=30.0)
    h.ensure("c")
    h.clock.t = 10.0  # within the cooldown: a second burst cannot evict
    h.ensure("c")
    h.clock.t = 31.0
    h.ensure("c")
    return h.done()


def rollback_restores_breakers(pkg):
    h = Harness(pkg, {"a": 400, "b": 400}, {"a"}, headroom=0)
    plan = h.ensure("b")
    h.p.rollback(plan)
    return h.done()


def full_sweep_cannot_fit(pkg):
    h = Harness(pkg, {"a": 100, "big": 10_000}, {"a"}, headroom=50)
    h.check("big"), h.ensure("big")
    return h.done()


def budget_arithmetic(pkg):
    # no live gauge: --hbm_budget_bytes minus the residents' projection
    h = Harness(pkg, {"a": 600, "b": 300, "c": 700}, {"a", "b"}, budget=1000)
    h.check("c"), h.ensure("c"), h.check("c")
    return h.done()


def hbm_squeeze_collapses_headroom(pkg):
    h = Harness(pkg, {"b": 10}, {"a"}, headroom=10**12)
    h.check("b")
    pkg.faults.install_injector(["hbm_squeeze:error:1"])
    h.check("b")  # squeezed: headroom 0
    pkg.faults.install_injector(None)
    return h.done()


SCENARIOS = [unknown_without_projection, unknown_without_headroom, resident_always_fits,
             evicts_lowest_value, equal_value_tie_breaks_by_name, min_residency_guard,
             cooldown_hysteresis, rollback_restores_breakers, full_sweep_cannot_fit,
             budget_arithmetic, hbm_squeeze_collapses_headroom]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_preemptor_scenario_equals_jax(scenario):
    ours = scenario(PORT)
    assert ours == scenario(JAX)
    assert ours[-1][0] == "snapshot"


def test_preemptor_scenarios_reach_every_verdict():
    verdicts = {r[2][0] for s in SCENARIOS for r in s(PORT) if r[0] == "check"}
    assert verdicts == {"fits", "overcommit", "unknown"}
    victims = evicts_lowest_value(PORT)
    assert ("ensure", "c", ("c", ["a"], 100.0)) in victims
    events = [r for r in rollback_restores_breakers(PORT) if r[0] == "events"][0][1]
    assert [n for n, _ in events] == ["preempted", "preemption_rollback"]


@pytest.mark.parametrize("with_preemptor", [False, True], ids=["off", "on"])
def test_simulate_overcommit_equals_jax(with_preemptor):
    def run(pkg):
        h = Harness(pkg, {"a": 400, "b": 500}, {"a"}, headroom=100)
        return pkg.simulate_overcommit(
            h.p if with_preemptor else None, [("a", 4), ("b", 6), ("a", 2)],
            resident_fits=lambda ft: ft == "a", service_s=1.0, deadline_s=2.5,
            rewarm_s=0.5)

    ours = run(PORT)
    assert ours == run(JAX)
    misses = sum(not r["met"] for r in ours)
    assert misses == (0 if with_preemptor else 6)


# --- the daemon's gate, eviction and rollback on the small CLIP tower ----------

A, B = "CLIP-ViT-B/32", "CLIP-ViT-B/16"


@pytest.fixture
def small_towers(monkeypatch):
    for ft in (A, B):
        monkeypatch.setitem(port_model.CONFIGS, ft, port_model.CLIPVisionConfig(**SMALL))
        monkeypatch.setitem(jax_model.CONFIGS, ft, jax_model.CLIPVisionConfig(**SMALL))


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("preempt_media")
    return [synth_video(str(d / f"v{i}.mp4"), n_frames=10, width=64, height=48, seed=i)
            for i in range(3)]


def _daemon(pkg, tmp_path, fail_build=False, **flags):
    argv = ["--feature_types", A, B, "--cpu", "--allow_random_init", "--extract_method",
            "uni_3", "--heartbeat_s", "0", "--output_path", str(tmp_path / pkg / "out"),
            "--tmp_path", str(tmp_path / pkg / "tmp"), "--preempt", "on"]
    for k, v in flags.items():
        argv += [f"--{k}", str(v)]
    if pkg == "jax":
        scfg, cls, build, extra = jax_parse_serve_args(argv + ["--decoder", "cv2"]), \
            JaxServeDaemon, jax_build_extractor, {}
    else:
        scfg, cls, build, extra = parse_serve_args(argv), ServeDaemon, build_extractor, {}

    def build_or_fail(cfg):
        if fail_build and cfg.feature_type == B:
            raise RuntimeError("out of memory: injected build failure")
        return build(cfg)

    d = cls(scfg, build=build_or_fail, **extra)
    # price both models as if a card had run them (CPU entries project nothing)
    d.ledger.record(A, "fam", "64x48", "queue", "cuda", {"memory": {"argument_bytes": 800}})
    d.ledger.record(B, "fam", "64x48", "queue", "cuda", {"memory": {"argument_bytes": 500}})
    return d


def _drain(d):
    for g in d.batcher.take_ready(now=float("inf")):
        d.batcher._run_group(g)


def _outcome(d, pkg, ids):
    mod = lifecycle if pkg == "port" else jax_lifecycle
    fault_mod = faults if pkg == "port" else jax_faults
    events = [r["event"] for r in fault_mod.iter_manifest_records(
        mod.requests_root(d.cfg.output_path)) if r.get("event") in (
            "preempted", "preemption_rollback", "rewarmed")]
    counters = d.telemetry.metrics.snapshot()["counters"]
    return {
        "states": {i: (d.tracker.get(i) or {}).get("state") for i in ids},
        "resident": sorted(d.pool.feature_types()),
        "breakers": {ft: d._breaker(ft).state() for ft in (A, B)},
        "events": events,
        "preemptions": {k: v for k, v in counters.items() if k.startswith("preemptions.")},
        "preemptor": d.status()["preemptor"],
    }


def _gate_preempts(pkg, tmp_path, videos):
    d = _daemon(pkg, tmp_path, hbm_budget_bytes=1000, preempt_min_residency_s=0,
                preempt_cooldown_s=0)
    try:
        d.submit({"feature_type": A, "video_path": videos[0], "id": "w1"}, source="local")
        _drain(d)
        # B needs 500 beside A's 800 in a budget of 1000: the idle resident
        # is preempted, the request is not refused
        d.submit({"feature_type": B, "video_path": videos[1], "id": "b1"}, source="local")
        _drain(d)
        return _outcome(d, pkg, ["w1", "b1"])
    finally:
        d.shutdown()


def _gate_refuses(pkg, tmp_path, videos):
    d = _daemon(pkg, tmp_path, hbm_budget_bytes=1000, preempt_min_residency_s=3600,
                preempt_cooldown_s=0)
    unavailable = supervisor.ModelUnavailable if pkg == "port" else \
        jax_supervisor.ModelUnavailable
    try:
        d.submit({"feature_type": A, "video_path": videos[0], "id": "w1"}, source="local")
        _drain(d)
        with pytest.raises(unavailable, match="cannot fit") as exc:
            d.submit({"feature_type": B, "video_path": videos[1], "id": "b1"},
                     source="local")
        out = _outcome(d, pkg, ["w1", "b1"])
        out["message"] = d.tracker.get("b1")["message"]
        assert str(exc.value) in out["message"] or "cannot fit" in out["message"]
        return out
    finally:
        d.shutdown()


def _rollback(pkg, tmp_path, videos):
    d = _daemon(pkg, tmp_path, fail_build=True, hbm_budget_bytes=1000,
                preempt_min_residency_s=0, preempt_cooldown_s=0)
    try:
        d.submit({"feature_type": A, "video_path": videos[0], "id": "w1"}, source="local")
        _drain(d)
        d.submit({"feature_type": B, "video_path": videos[1], "id": "b1"}, source="local")
        _drain(d)  # B's build fails: A's breaker is handed back
        d.submit({"feature_type": A, "video_path": videos[2], "id": "w2"}, source="local")
        _drain(d)  # A serves again at once, rebuilt on demand
        return _outcome(d, pkg, ["w1", "b1", "w2"])
    finally:
        d.shutdown()


@pytest.mark.parametrize("case", [_gate_preempts, _gate_refuses, _rollback],
                         ids=["gate_preempts", "gate_refuses", "rollback"])
def test_daemon_preemption_equals_jax(case, tmp_path, videos, small_towers):
    ours = case("port", tmp_path, videos)
    assert ours == case("jax", tmp_path, videos)
    if case is _gate_preempts:
        assert ours["states"] == {"w1": "done", "b1": "done"} and ours["resident"] == [B]
        assert ours["breakers"][A] == "open" and ours["events"] == ["preempted"]
        assert ours["preemptions"] == {f"preemptions.{A}": 1}
        assert ours["preemptor"]["preemptions"] == 1
    elif case is _gate_refuses:
        assert ours["states"]["b1"] == "rejected" and ours["resident"] == [A]
        assert "needs 500 bytes of HBM, 200 available" in ours["message"]
    else:
        assert ours["states"] == {"w1": "done", "b1": "failed", "w2": "done"}
        assert ours["breakers"][A] == "closed"
        assert ours["events"] == ["preempted", "preemption_rollback"]
