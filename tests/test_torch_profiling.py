"""The port's ``utils/profiling.py``: the refcounted ``device_trace``
session on ``torch.profiler`` and ``StageTimer``.

The cases of ``tests/test_profiling.py`` against a fake
``torch.profiler.profile`` (the contract under test is the session's
refcounting and clean failure, not the trace): a ``None`` directory never
touches the profiler, nested and concurrent regions share one session, a
raising body releases its ref, a missing directory is made, and a failed
start leaves a clean state and raises. One case runs the real CPU
profiler and reads the exported Chrome trace back.
"""

import json
import re
import threading

import pytest
import torch

from video_features_tpu_torch.utils import profiling
from video_features_tpu_torch.utils.profiling import StageTimer, device_trace


class _FakeSession:
    def __init__(self, log, broken):
        self.log, self.broken = log, broken

    def start(self):
        if self.broken.get("start"):
            raise RuntimeError("profiler wedged")
        self.log.append(("start", None))

    def stop(self):
        if self.broken.get("stop"):
            raise ValueError("no profiler session running")
        self.log.append(("stop", None))

    def export_chrome_trace(self, path):
        self.log.append(("export", path))


@pytest.fixture()
def fake_profiler(monkeypatch):
    log, broken = [], {}
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda activities=None: _FakeSession(log, broken))
    assert profiling._trace_refs == 0  # the suite's invariant between tests
    return log, broken


def _starts_stops(log):
    return [e for e in log if e[0] == "start"], [e for e in log if e[0] == "stop"]


def test_device_trace_none_dir_never_touches_profiler(fake_profiler):
    log, _ = fake_profiler
    with device_trace(None):
        pass
    with device_trace(""):
        pass
    assert log == [] and profiling._trace_refs == 0


def test_device_trace_nested_regions_share_one_session(fake_profiler, tmp_path):
    log, _ = fake_profiler
    with device_trace(str(tmp_path)):
        with device_trace(str(tmp_path)):
            assert profiling._trace_refs == 2
        assert log == [("start", None)]  # the inner exit keeps the session
    assert [e[0] for e in log] == ["start", "stop", "export"]
    assert re.fullmatch(r"trace-\d+-\d+\.json", log[-1][1].split("/")[-1])
    assert log[-1][1].startswith(str(tmp_path))
    assert profiling._trace_refs == 0


def test_device_trace_releases_ref_when_body_raises(fake_profiler, tmp_path):
    log, _ = fake_profiler
    with pytest.raises(RuntimeError):
        with device_trace(str(tmp_path)):
            raise RuntimeError("worker died mid-trace")
    assert [e[0] for e in log] == ["start", "stop", "export"]
    assert profiling._trace_refs == 0


def test_device_trace_creates_missing_profile_dir(fake_profiler, tmp_path):
    log, _ = fake_profiler
    target = tmp_path / "nested" / "prof"
    with device_trace(str(target)):
        pass
    assert target.is_dir()
    assert log[-1] == ("export", log[-1][1]) and log[-1][1].startswith(str(target))


@pytest.mark.parametrize("stop_raises", [False, True], ids=["stop-ok", "stop-raises"])
def test_device_trace_failed_start_leaves_clean_state(fake_profiler, tmp_path, stop_raises):
    """A start that raises leaves no ref and no half-started session, and
    the start's error is the one raised (a failing cleanup stop does not
    mask it); the next caller starts cleanly."""
    log, broken = fake_profiler
    broken.update(start=True, stop=stop_raises)
    with pytest.raises(RuntimeError, match="wedged"):
        with device_trace(str(tmp_path)):
            pass
    assert profiling._trace_refs == 0 and profiling._trace_session is None
    assert log == ([] if stop_raises else [("stop", None)])  # cleanup stop, best effort
    broken.clear()
    log.clear()
    with device_trace(str(tmp_path)):
        assert profiling._trace_refs == 1
    assert [e[0] for e in log] == ["start", "stop", "export"]
    assert profiling._trace_refs == 0


def test_device_trace_concurrent_workers_one_start_one_stop(fake_profiler, tmp_path):
    """8 threads through the region: starts and stops pair up, each stop
    exports once, and the count ends at 0."""
    log, _ = fake_profiler
    barrier = threading.Barrier(8)

    def worker():
        barrier.wait(timeout=10)
        with device_trace(str(tmp_path)):
            pass

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    starts, stops = _starts_stops(log)
    exports = [e[1] for e in log if e[0] == "export"]
    assert len(starts) == len(stops) == len(exports) >= 1
    assert len(set(exports)) == len(exports)  # a new file per session
    assert profiling._trace_refs == 0


def test_device_trace_writes_a_chrome_trace_of_the_region(tmp_path):
    """The real profiler (CPU activities here): the region's ops are in
    the exported trace."""
    with device_trace(str(tmp_path)):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    (path,) = tmp_path.glob("trace-*.json")
    trace = json.loads(path.read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    assert profiling._trace_refs == 0


def test_stage_timer_accumulates_seconds_and_counts(monkeypatch):
    ticks = iter([0.0, 0.25, 1.0, 1.5, 2.0, 2.125])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(ticks))
    t = StageTimer()
    with t.stage("decode"):
        pass
    with t.stage("decode"):
        pass
    with t.stage("device"):
        pass
    assert t.counts["decode"] == 2 and t.counts["device"] == 1
    assert t.seconds["decode"] == pytest.approx(0.75)
    assert t.seconds["device"] == pytest.approx(0.125)


def test_stage_timer_counts_raising_stage(monkeypatch):
    ticks = iter([0.0, 3.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(ticks))
    t = StageTimer()
    with pytest.raises(ValueError):
        with t.stage("sink"):
            raise ValueError("disk full")
    assert t.counts["sink"] == 1 and t.seconds["sink"] == pytest.approx(3.0)


def test_stage_timer_summary_format_matches_jax():
    from video_features_tpu.utils.profiling import StageTimer as JaxStageTimer

    ours, ref = StageTimer(), JaxStageTimer()
    assert ours.summary() == ref.summary() == ""
    for t in (ours, ref):
        for stage, s in (("device", 1.5), ("decode", 0.25), ("decode", 2.0)):
            t.seconds[stage] += s
            t.counts[stage] += 1
    assert ours.summary() == ref.summary()
    lines = ours.summary().splitlines()
    assert lines[0] == "per-stage wall time:"
    assert [ln.split()[0] for ln in lines[1:]] == ["decode", "device"]
    assert all(re.search(r"\d+\.\d\ds over \d+ calls$", ln) for ln in lines[1:])


def test_stage_timer_threaded_accumulation():
    t = StageTimer()
    n, per = 8, 50

    def worker():
        for _ in range(per):
            with t.stage("prep"):
                pass

    threads = [threading.Thread(target=worker) for _ in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    assert t.counts["prep"] == n * per and t.seconds["prep"] >= 0.0
