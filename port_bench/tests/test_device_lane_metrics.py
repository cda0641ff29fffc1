"""The readers of the port's device lane on made-up rows: device preprocess
per stack, the card's idle share between phases by the lane, host staging
per stack and set-up's first calls; each None where the run has nothing
for it (as on a program from before the device lane)."""

import pytest

from port_bench.harness import spec


def _read(name, ctx):
    return spec.metric(name).read(ctx)


def _device(phase, t0, t1, video="a.mp4", stack=0, worker="cuda:0"):
    return {"stage": "device", "phase": phase, "video": video, "stack": stack,
            "worker": worker, "t0": t0, "t1": t1}


HOST_ONLY = [{"stage": "dispatch", "t0": 0.0, "t1": 2.0, "video": "a.mp4"},
             {"stage": "fetch", "t0": 2.0, "t1": 3.0, "video": "a.mp4"}]


def test_preprocess_ms_per_stack_sums_each_stacks_phases():
    rows = HOST_ONLY + [
        _device("preprocess", 0.0, 0.010), _device("flow_net", 0.010, 0.5),
        _device("preprocess", 0.5, 0.520),  # flow_chain: the same stack's
        _device("preprocess", 1.0, 1.006, stack=1),
        _device("preprocess", 2.0, 2.014, video="b.mp4"),
        {"stage": "device", "phase": "preprocess", "videos": ["c.mp4", "d.mp4"], "video": None,
         "stack": 0, "worker": "cuda:0", "t0": 3.0, "t1": 3.010}]
    assert _read("preprocess.device_ms_per_stack", {"spans": rows}) == \
        pytest.approx((30 + 6 + 14 + 10) / 4)
    assert _read("preprocess.device_ms_per_stack", {"spans": HOST_ONLY}) is None


def test_device_idle_pct_is_the_mean_over_workers():
    rows = HOST_ONLY + [
        _device("h2d", 0.0, 1.0), _device("preprocess", 0.5, 2.0),  # overlap counts once
        _device("i3d_rgb", 3.0, 4.0),  # worker 0: busy 3 of 4
        _device("forward", 10.0, 11.0, worker="cuda:1"),
        _device("forward", 11.0, 12.0, worker="cuda:1")]  # worker 1: busy 2 of 2
    assert _read("loop.device_idle_between_phases_pct", {"spans": rows}) == pytest.approx((25.0 + 0.0) / 2)
    assert _read("loop.device_idle_between_phases_pct", {"spans": HOST_ONLY}) is None


def test_stage_in_ms_per_stack_is_the_mean_span():
    rows = HOST_ONLY + [{"stage": "stage_in", "t0": 0.0, "t1": 0.004},
                        {"stage": "stage_in", "t0": 1.0, "t1": 1.008}]
    assert _read("loop.stage_in_ms_per_stack", {"spans": rows}) == pytest.approx(6.0)
    assert _read("loop.stage_in_ms_per_stack", {"spans": HOST_ONLY}) is None


def test_first_calls_read_the_programs_current_telemetry_before_the_window(monkeypatch):
    from video_features_tpu_torch.runtime import telemetry

    class _Tele:
        def __init__(self, rows):
            self.rows = rows

        def spans(self):
            return self.rows

    rows = [{"stage": "compile", "fn": "rgb", "t0": 1.0, "t1": 3.5},
            {"stage": "compile", "fn": "pwc", "t0": 4.0, "t1": 5.0},
            {"stage": "compile", "fn": "flow", "t0": 20.0, "t1": 21.0},  # in the window
            {"stage": "prepare", "t0": 0.0, "t1": 6.0}]
    ctx = {"spans": [], "window": {"t_start": 10.0}}
    monkeypatch.setattr(telemetry, "_CURRENT", _Tele(rows))
    assert _read("setup.first_calls_s", ctx) == pytest.approx(3.5)
    monkeypatch.setattr(telemetry, "_CURRENT", _Tele(rows[2:]))
    assert _read("setup.first_calls_s", ctx) is None
    monkeypatch.setattr(telemetry, "_CURRENT", None)
    assert _read("setup.first_calls_s", ctx) is None
