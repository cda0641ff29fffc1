"""The trace's reduction on a made-up trace: busy time as a union, the
top kernels, idle gaps labelled by the loop thread's span, K2's launches;
and K2's roofline from whole forwards only."""

import importlib.util
import types

import pytest
from torch.autograd import DeviceType

from port_bench.harness import spec
from port_bench.harness.tracing import reduce_trace


def _event(name, start_us, end_us, device=DeviceType.CUDA, index=0):
    return types.SimpleNamespace(name=name, device_type=device, device_index=index,
                                 is_user_annotation=False,
                                 time_range=types.SimpleNamespace(start=start_us, end=end_us))


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_reduce_trace_busy_gaps_and_labels():
    origin = 100.0  # monotonic seconds at the profiler's start
    events = [_event("gemm", 0, 400), _event("gemm", 300, 500),  # union 500
              _event("gemm", 300, 500),  # the same record twice counts once
              _event("local_correlation_kernel<float>", 1500, 1600),
              _event("cudaLaunchKernel", 0, 10, DeviceType.CPU)]
    spans = [{"stage": "dispatch", "thread": 1, "t0": origin + 0.0004, "t1": origin + 0.0012},
             {"stage": "prepare", "thread": 2, "t0": origin, "t1": origin + 0.002}]
    out = reduce_trace(_Prof(events), spans, origin)
    assert out["busy_s"] == pytest.approx(600e-6)  # 500 + the K2 launch's 100
    assert out["window_s"] == pytest.approx(1600e-6)
    # a name's records overlapping themselves count once
    assert out["device_ops"][0] == ["gemm", pytest.approx(500e-6)]
    assert out["idle_gaps"] == [["dispatch", pytest.approx(1000e-6)]]
    assert out["k2"] == [(pytest.approx(1500e-6), pytest.approx(100e-6), 0)]
    assert reduce_trace(_Prof(events[-1:]), spans, origin) is None


def _k2_reader():
    path = spec.BENCH_DIR / "metrics" / "k2_roofline.py"
    mod_spec = importlib.util.spec_from_file_location("k2_roofline", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def test_k2_roofline_counts_whole_forwards_only():
    from port_bench.counts.correlation import correlation_bound, pwc_levels

    config = spec.config("i3d_pwc")
    dims = config["sizes"]["pwc"]["level_dims"]
    bound = sum(correlation_bound(s)[0] for s in pwc_levels(256, 340, 64, dims))
    whole = [(0.0 + 0.001 * i, bound / 5 * 2, 0) for i in range(5)]  # each at half its roofline
    cut = [(1.0, 1.0, 0), (1.001, 1.0, 0)]  # a forward the trace cut: left out
    ctx = {"trace": {"k2": whole + cut}, "config": config, "video_hw": (256, 340)}
    assert _k2_reader().read(ctx) == pytest.approx(50.0)
    assert _k2_reader().read({"trace": {"k2": []}, "config": config}) is None


def test_reduce_trace_averages_busy_over_cards_and_labels_each_cards_loop():
    events = [_event("gemm", 0, 1000, index=0), _event("gemm", 0, 400, index=1),
              _event("gemm", 900, 1000, index=1)]
    spans = [{"stage": "dispatch", "thread": 7, "worker": "cuda:1", "t0": 0.0004, "t1": 0.0008},
             {"stage": "fetch", "thread": 6, "worker": "cuda:0", "t0": 0.0004, "t1": 0.0008}]
    out = reduce_trace(_Prof(events), spans, 0.0)
    assert out["cards"] == 2
    assert out["busy_s"] == pytest.approx(0.5 * (1000 + 500) * 1e-6)
    assert out["idle_gaps"] == [["dispatch", pytest.approx(500e-6)]]
