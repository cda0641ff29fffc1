"""The port's device lane (``runtime/telemetry.py``): ``device`` rows per
phase of a dispatch, the loop thread's ``stage_in`` / ``launch`` spans,
first-call ``compile`` spans (``telemetry/ledger.py``), and the readers
that take the device lane over the host spans.

- A tiny I3D + PWC and I3D + RAFT at ``--preprocess device`` through the
  pipelined loop: per stack the phases in launch order, contiguous, each
  row on the worker's own lane with its video and stack; ``stage_in`` and
  ``launch`` nested in ``dispatch`` on the loop thread; every row valid
  against the schema.
- The CUDA path on fake timing events: the anchor's conversion onto the
  host clock, a shared boundary between contiguous phases on one stream
  and none across a host span, no row before ``query()`` says the events
  completed, the pool's reuse, a card shared by two workers anchored only
  while quiet; and ``--telemetry off`` constructs no event.
- One ``compile`` span and one ``compiles`` tick at each new signature.
- ``utilization_report`` / ``overlap_report`` / the export's device
  lanes: the device rows where a process left them, its host spans where
  it did not.
"""

import jsonschema
import numpy as np
import pytest
import torch

from video_features_tpu_torch.config import ExtractionConfig, sanity_check
from video_features_tpu_torch.extract.registry import build_extractor
from video_features_tpu_torch.models.i3d.extract_i3d import ExtractI3D
from video_features_tpu_torch.runtime import telemetry as tm
from video_features_tpu_torch.telemetry import ledger, load_schema
from video_features_tpu_torch.utils import profiling
from video_features_tpu_torch.utils.synth import synth_video

from test_torch_aggregation import TinyFlow, TinyTower
from torch_threads import one_torch_thread  # noqa: F401 - an autouse fixture

I3D_PHASES = ["h2d", "preprocess", "i3d_rgb", "d2h", "preprocess", "flow_net", "preprocess",
              "i3d_flow", "d2h"]


@pytest.fixture(autouse=True)
def _no_current_telemetry():
    yield
    tm.set_current(None)


def _tiny_i3d(self, kind):
    return TinyTower(3 if kind == "rgb" else 2) if kind in ("rgb", "flow") else TinyFlow()


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("lane_media")
    # 23 frames at 25 fps, sampled at 12 fps: 11 frames, one stack of 10
    return [synth_video(str(d / f"v{i}.mp4"), n_frames=23, width=64, height=48, seed=i)
            for i in range(2)]


@pytest.mark.parametrize("flow_type", ["pwc", "raft"])
def test_i3d_stack_phases_on_their_own_lane(flow_type, clips, tmp_path, monkeypatch):
    monkeypatch.setattr(ExtractI3D, "_model", _tiny_i3d)
    cfg = sanity_check(ExtractionConfig(
        video_paths=list(clips), cpu=True, feature_type="i3d", flow_type=flow_type,
        stack_size=10, step_size=10, extraction_fps=12.0, preprocess="device",
        decode_workers=2, allow_random_init=True, on_extraction="save_numpy",
        output_path=str(tmp_path / "out"), tmp_path=str(tmp_path / "tmp"), decoder="cv2"))
    ex = build_extractor(cfg)
    ex(device=torch.device("cpu"))
    rows = ex.telemetry.spans()
    ex.telemetry.close()
    validator = jsonschema.Draft7Validator(load_schema())
    for row in rows:
        validator.validate(row)
    by_id = {r["span"]: r for r in rows}
    device = [r for r in rows if r["stage"] == "device"]
    assert {(r["thread"], r["thread_name"], r["parent"], r["worker"]) for r in device} == {
        (tm.device_lane_tid("cpu"), "device cpu", None, "cpu")}
    for video in clips:
        mine = sorted((r for r in device if r["video"] == video), key=lambda r: r["t0"])
        assert [r["stack"] for r in mine] == [0] * len(I3D_PHASES)
        assert [r["phase"] for r in mine] == I3D_PHASES
        # on the CPU every phase of a stack is contiguous with the last
        assert all(b["t0"] == a["t1"] >= a["t0"] for a, b in zip(mine, mine[1:]))
        (dispatch,) = [r for r in rows if r["stage"] == "dispatch" and r["video"] == video]
        (stage_in,) = [r for r in rows if r["stage"] == "stage_in" and r["video"] == video]
        launches = [r for r in rows if r["stage"] == "launch" and r["video"] == video]
        assert sorted(r["phase"] for r in launches) == sorted(I3D_PHASES)
        assert stage_in["parent"] == dispatch["span"] and stage_in["stack"] == 0
        for r in launches:  # h2d's inside stage_in, the others directly in dispatch
            assert r["parent"] == (stage_in if r["phase"] == "h2d" else dispatch)["span"]
            assert r["thread"] == dispatch["thread"] and r["stack"] == 0
        assert dispatch["t0"] <= stage_in["t0"] <= mine[0]["t0"] <= mine[-1]["t1"] \
            <= dispatch["t1"]
    compiles = [r for r in rows if r["stage"] == "compile"]
    assert sorted(r["fn"] for r in compiles) == sorted(["rgb", "flow", flow_type])
    assert all(r["captured"] is True and by_id[r["parent"]]["stage"] == "launch"
               for r in compiles)
    util = tm.utilization_report(rows)
    assert util["devices"]["cpu"]["spans"] == len(device)
    assert 0 < util["device_utilization"] <= 1


# --- the CUDA path on fake events ----------------------------------------------

class _Clock:
    """The fake device's time (the events' record times) and how far its
    work has completed."""

    def __init__(self):
        self.now = 100.0
        self.completed = -1.0


class _FakeEvent:
    made = 0
    clock = _Clock()

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.t = None

    def record(self, stream=None):
        self.t = self.clock.now
        self.stream = stream

    def query(self):
        return self.t <= self.clock.completed

    def synchronize(self):
        self.clock.completed = max(self.clock.completed, self.t)

    def elapsed_time(self, other):
        assert self.query() and other.query()
        return (other.t - self.t) * 1e3


@pytest.fixture
def fake_cuda(monkeypatch):
    _FakeEvent.made = 0
    _FakeEvent.clock = _Clock()
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(tm, "_cuda_stream", lambda device: "compute")
    return _FakeEvent.clock


def _stack(tele, dev, clock, stack):
    """One stack's phases as the I3D dispatch records them: h2d on the
    copy stream inside ``stage_in``, then two phases on the compute
    stream; each takes device time."""
    with tele.scope_span("stage_in", stack=stack):
        with tele.device_phase("h2d", dev, stream="copy", stack=stack):
            clock.now += 1.0
    for phase, took in (("preprocess", 2.0), ("flow_net", 3.0)):
        with tele.device_phase(phase, dev, stack=stack):
            clock.now += took


def test_cuda_lane_on_fake_events(fake_cuda):
    clock, dev = fake_cuda, torch.device("cuda", 0)
    tele = tm.Telemetry(enabled=True)
    tele.anchor_device(dev)
    (anchor,) = tele.device_anchors().values()
    with tele.device_scope(dev, "cuda:0", video="v"):
        _stack(tele, dev, clock, 0)
    # anchor 1, the scope's start 1, h2d 2, preprocess 2, flow_net shares 1
    assert _FakeEvent.made == 7
    assert tele.resolve_device() == 0 and not [r for r in tele.spans() if r["stage"] == "device"]
    clock.completed = clock.now
    rows = [r for r in tele.spans() if r["stage"] == "device"]
    assert [r["phase"] for r in rows] == ["h2d", "preprocess", "flow_net"]
    got = [(r["t0"] - anchor["t"], r["t1"] - anchor["t"]) for r in rows]
    assert got == pytest.approx([(0.0, 1.0), (1.0, 3.0), (3.0, 6.0)])
    assert rows[2]["t0"] == rows[1]["t1"]  # one shared event
    assert {(r["video"], r["stack"], r["worker"], r["thread_name"]) for r in rows} == {
        ("v", 0, "cuda:0", "device cuda:0")}
    # the next stack reuses the pool's events; a scope with no phase is
    # one ``forward`` row
    with tele.device_scope(dev, "cuda:0", video="w"):
        _stack(tele, dev, clock, 1)
    clock.completed = clock.now
    assert len([r for r in tele.spans() if r["stage"] == "device"]) == 6
    with tele.device_scope(dev, "cuda:0", video="x"):
        clock.now += 4.0
    clock.completed = clock.now
    assert _FakeEvent.made == 7
    rows = [r for r in tele.spans() if r["stage"] == "device"]
    assert [(r["video"], r["phase"]) for r in rows[3:]] == [
        ("w", "h2d"), ("w", "preprocess"), ("w", "flow_net"), ("x", "forward")]
    assert rows[-1]["t1"] - rows[-1]["t0"] == pytest.approx(4.0)
    # a host span between two phases on one stream: the second records
    # its own start, so the stream's idle under the span is a gap
    with tele.device_scope(dev, "cuda:0", video="y"):
        with tele.device_phase("i3d_rgb", dev, stack=0):
            clock.now += 1.0
        with tele.scope_span("stage_in", stack=1):
            clock.now += 0.5
        with tele.device_phase("i3d_rgb", dev, stack=1):
            clock.now += 1.0
    clock.completed = clock.now
    a, b = [r for r in tele.spans() if r["stage"] == "device" and r["video"] == "y"]
    assert b["t0"] - a["t1"] == pytest.approx(0.5)
    tele.close()


def test_a_shared_card_is_anchored_only_while_quiet(fake_cuda, monkeypatch):
    """Two workers on one card (``--device_ids 0 0``): a call takes a new
    anchor, and so waits, only while no other worker's scope is open on
    the lane and none of its phases is unread."""
    clock, dev = fake_cuda, torch.device("cuda", 0)
    waits = []
    monkeypatch.setattr(_FakeEvent, "synchronize", lambda self: waits.append(self.t)
                        or setattr(clock, "completed", max(clock.completed, self.t)))
    tele = tm.Telemetry(enabled=True)
    tele.anchor_device(dev)
    assert len(waits) == 1
    with tele.device_scope(dev, "w0", video="a"):
        with tele.device_phase("flow_net", dev, stack=0):
            clock.now += 5.0
        tele.anchor_device(dev)  # the other worker's call starts: no wait
        assert len(waits) == 1
    tele.anchor_device(dev)  # w0's phase not yet read: still none
    assert len(waits) == 1
    clock.completed = clock.now
    tele.anchor_device(dev)  # quiet: a new anchor, after the work
    assert len(waits) == 2 and waits[-1] == clock.now
    (row,) = [r for r in tele.spans() if r["stage"] == "device"]
    assert row["t1"] - row["t0"] == pytest.approx(5.0)
    tele.close()


def test_telemetry_off_creates_no_event(fake_cuda):
    clock, dev = fake_cuda, torch.device("cuda", 0)
    tele = tm.Telemetry(enabled=False)
    tele.anchor_device(dev)
    with tele.device_scope(dev, "cuda:0", video="v"):
        _stack(tele, dev, clock, 0)
    clock.completed = clock.now
    assert tele.resolve_device() == 0 and tele.spans() == []
    assert _FakeEvent.made == 0
    # on, but outside a device scope (a direct forward, a mesh): no event
    on = tm.Telemetry(enabled=True)
    with on.device_phase("preprocess", dev, stack=0):
        pass
    assert _FakeEvent.made == 0 and on.spans() == []
    on.close()


def test_spans_enter_record_function_while_a_profile_session_is_on(monkeypatch):
    entered = []

    class _Range:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", _Range)
    tele = tm.Telemetry(enabled=True)
    with tele.span("dispatch"):
        pass
    monkeypatch.setattr(profiling, "session_active", lambda: True)
    with tele.span("fetch"):
        pass
    assert entered == ["fetch"]
    tele.close()


# --- first calls ----------------------------------------------------------------

class _Lin(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(4, 4)

    def forward(self, x):
        return self.lin(x)


@pytest.mark.parametrize("with_ledger", [False, True], ids=["telemetry", "ledger"])
def test_first_call_at_each_signature_is_one_compile_span(with_ledger):
    tele = tm.Telemetry(enabled=True)
    led = ledger.CostLedger(None) if with_ledger else None
    state = {"rgb": _Lin()}
    ledger.instrument_state(state, led, model="i3d", telemetry=tele)
    with torch.inference_mode(), tele.span("dispatch"):
        state["rgb"](torch.zeros(2, 4))
        state["rgb"](torch.ones(2, 4))  # the same signature: no span
        state["rgb"](torch.zeros(3, 4))
    rows = tele.spans()
    compiles = [r for r in rows if r["stage"] == "compile"]
    assert [(r["fn"], r["bucket"], r["n"]) for r in compiles] == [("rgb", "2x4", 1),
                                                                  ("rgb", "3x4", 2)]
    (dispatch,) = [r for r in rows if r["stage"] == "dispatch"]
    assert all(r["parent"] == dispatch["span"] and r["t1"] >= r["t0"] for r in compiles)
    assert all(r.get("captured") is (True if with_ledger else None) for r in compiles)
    assert tele.metrics.counter("compiles") == 2
    assert len(led or ()) == (2 if with_ledger else 0)
    off, quiet = tm.Telemetry(enabled=False), {"rgb": _Lin()}
    ledger.instrument_state(quiet, None, model="i3d", telemetry=off)
    quiet["rgb"](torch.zeros(2, 4))
    assert off.metrics.counter("compiles") == 0 and off.spans() == []
    tele.close()


# --- the readers ----------------------------------------------------------------

def _host_and_lane_rows():
    """pid 1: host dispatch/fetch spans and the device lane's rows; pid 2:
    host spans alone."""
    rows = []
    for pid in (1, 2):
        rows += [{"stage": "prepare", "t0": 0.0, "t1": 1.0, "pid": pid, "worker": "cuda:0"},
                 {"stage": "dispatch", "t0": 1.0, "t1": 1.1, "pid": pid, "worker": "cuda:0"},
                 {"stage": "fetch", "t0": 1.1, "t1": 4.0, "pid": pid, "worker": "cuda:0"}]
    rows += [{"stage": "device", "phase": p, "t0": t0, "t1": t1, "pid": 1, "worker": "cuda:0",
              "thread": tm.device_lane_tid("cuda:0"), "thread_name": "device cuda:0"}
             for p, t0, t1 in (("preprocess", 1.05, 1.5), ("flow_net", 1.5, 3.0),
                               ("d2h", 3.5, 3.6))]
    return rows


def test_readers_take_the_lane_where_a_process_has_one():
    rows = _host_and_lane_rows()
    lanes = tm._device_intervals(rows)
    assert lanes[1] == {"cuda:0": [(1.05, 1.5), (1.5, 3.0), (3.5, 3.6)]}
    assert lanes[2] == {"cuda:0": [(1.0, 1.1), (1.1, 4.0)]}
    util = tm.utilization_report(rows)
    assert util["devices"]["cuda:0"]["busy_s"] == pytest.approx((3.0 - 1.05) + 0.1 + 3.0)
    assert util["devices"]["cuda:0"]["spans"] == 3 + 2
    assert util["device_wall_s"] == pytest.approx(8.0)
    rep = tm.overlap_report(rows)
    assert rep["device_busy_s"] == pytest.approx(2.05 + 3.0)
    trace = tm.spans_to_chrome_trace(rows, device_lanes=True)
    lanes_named = {(e["pid"], e["args"]["name"]) for e in trace["traceEvents"]
                   if e["ph"] == "M"}
    assert lanes_named == {(1, "device cuda:0"), (2, "device cuda:0")}
    mirrored = [e for e in trace["traceEvents"] if e["ph"] == "X" and e["pid"] == 2
                and e["tid"] != 0]
    assert sorted(e["name"] for e in mirrored) == ["dispatch", "fetch"]
    assert not [e for e in trace["traceEvents"] if e["ph"] == "X" and e["pid"] == 1
                and e["name"] in ("dispatch", "fetch") and e["tid"] != 0]
    assert np.isclose(tm.utilization_report(rows[:6])["device_busy_s"], 2 * 3.0)
