"""What a ``--trace 1`` run records around the program, from the
benchmark's own files (the program is not edited):

- in the window, CUDA events recorded on the current stream before and
  after each call of each built model (forward pre- and post-hooks),
  resolved after it: the device time of each model, per stack;
- after the window, a ``torch.profiler`` trace (CUDA activity) of a
  steady stretch of its own: a call over a few videos, the trace started
  after its first stack and stopped once ``trace_seconds`` have passed,
  from the hook of the stack's last model on the loop's own thread. The
  profiler slows every launch and leaves CUPTI's cost behind it, so it
  runs after the window and not in it.

``reduce_trace`` turns the trace into the device's busy and idle time,
the kernels that took most of it, the longest idle gaps labelled by the
port's telemetry span the loop thread was in (the trace's times count
from the profiler's start, whose ``time.monotonic`` the hook keeps), and
K2's launches.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

K2_KERNEL = "local_correlation_kernel"


class ModelEvents:
    """CUDA events around every call of the given ``(kind, module)`` pairs
    while ``recording`` (one pair per model and card; queue mode's workers
    call them from their own threads, each on its own card); the armed
    profiler runs over ``trace_seconds`` of stacks, from the end of the
    first stack (``last`` is the kind each stack ends with)."""

    def __init__(self, modules: List[Tuple[str, torch.nn.Module]], last: str,
                 trace_seconds: float) -> None:
        self.calls: Dict[str, list] = {kind: [] for kind, _ in modules}
        self._open: Dict[int, torch.cuda.Event] = {}
        self._lock = threading.Lock()
        self.last = last
        self.trace_seconds = trace_seconds
        self.prof: Optional[torch.profiler.profile] = None
        self._t_prof = 0.0
        self.state = "idle"  # the profiler: idle (none), armed, on, off
        self.recording = False
        self.origin = 0.0  # time.monotonic() at the profiler's start
        self.handles = []
        for kind, mod in modules:
            self.handles.append(mod.register_forward_pre_hook(self._pre))
            self.handles.append(mod.register_forward_hook(self._post(kind)))

    def _pre(self, module, args):
        if self.recording:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._open[id(module)] = ev

    def _post(self, kind):
        def hook(module, args, out):
            if self.recording:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                with self._lock:
                    self.calls[kind].append((self._open.pop(id(module)), ev))
            if kind == self.last:
                self._stack_done()
        return hook

    def _stack_done(self) -> None:
        with self._lock:
            if self.state == "armed":
                self.origin = time.monotonic()
                self.prof.start()
                self._t_prof = time.monotonic()
                self.state = "on"
            elif self.state == "on" and time.monotonic() - self._t_prof >= self.trace_seconds:
                self.prof.stop()
                self.state = "off"

    def trace(self) -> None:
        """Arm the profiler for the next call's stacks."""
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.state = "armed"

    def stop_trace(self) -> None:
        """Stop a trace its call left running."""
        with self._lock:
            if self.state == "on":
                self.prof.stop()
                self.state = "off"

    def finish(self) -> None:
        for h in self.handles:
            h.remove()
        self.stop_trace()

    def device_ms(self) -> Dict[str, List[float]]:
        torch.cuda.synchronize()
        return {kind: [a.elapsed_time(b) for a, b in pairs] for kind, pairs in self.calls.items()}


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


LOOP_STAGES = ("h2d", "dispatch", "fetch", "sink", "extract")


def reduce_trace(prof: torch.profiler.profile, spans: List[dict], origin: float) -> Optional[dict]:
    """Busy and idle device time (``busy_s`` the mean over the cards the
    trace saw), the top kernels, the longest idle gaps of each card
    labelled by its loop thread's innermost telemetry span (``spans``,
    ``time.monotonic`` stamps, ``worker`` naming the card; ``origin`` the
    profiler's start on that clock), and K2's launches (start, duration, card);
    all in seconds. None when the trace holds no device activity."""
    from torch.autograd import DeviceType

    device = {(e.time_range.start, e.time_range.end, e.name, e.device_index)
              for e in prof.events()
              if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)}
    if not device:
        return None
    cards = sorted({d for *_, d in device})
    busy = {d: _merge([(s, e) for s, e, _, dd in device if dd == d]) for d in cards}
    t0 = min(b[0][0] for b in busy.values())
    t1 = max(b[-1][1] for b in busy.values())
    busy_us = sum(sum(e - s for s, e in b) for b in busy.values()) / len(cards)
    # a name's time is the union of its records on a card: the trace can
    # hold one launch twice, in overlapping records
    intervals: Dict[tuple, list] = {}
    for s, e, name, d in device:
        intervals.setdefault((name, d), []).append((s, e))
    by_name: Dict[str, float] = {}
    for (name, _), iv in intervals.items():
        by_name[name] = by_name.get(name, 0.0) + sum(e - s for s, e in _merge(iv))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    def us(t):
        return (t - origin) * 1e6

    timed = [(us(r["t0"]), us(r["t1"]), r["stage"], r["thread"], r.get("worker"))
             for r in spans if "t0" in r and "t1" in r]
    gaps = []
    for d in cards:
        b = busy[d]
        # the card's loop thread: the one that dispatches for its worker
        # (one card: every loop thread)
        loop = {t for _, _, stage, t, w in timed
                if stage in LOOP_STAGES and (len(cards) == 1 or w == f"cuda:{d}")}
        gaps += [(b[i + 1][0] - b[i][1], b[i][1], b[i + 1][0], loop) for i in range(len(b) - 1)]
    labelled = []
    for length, g0, g1, loop in sorted(gaps, key=lambda g: -g[0])[:10]:
        mid = 0.5 * (g0 + g1)
        on_loop = [(e - s, stage) for s, e, stage, t, _ in timed if t in loop and s <= mid <= e]
        decoding = any(stage == "prepare" and s <= mid <= e for s, e, stage, _, _ in timed)
        label = (min(on_loop)[1] if on_loop
                 else "loop waits for prepare" if decoding else "loop, no span")
        labelled.append([label, length * 1e-6])
    k2 = sorted((s * 1e-6, (e - s) * 1e-6, d) for s, e, name, d in device if K2_KERNEL in name)
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": (t1 - t0) * 1e-6,
        "cards": len(cards),
        "device_ops": [[name[:160], v * 1e-6] for name, v in top],
        "idle_gaps": labelled,
        "k2": k2,
    }
