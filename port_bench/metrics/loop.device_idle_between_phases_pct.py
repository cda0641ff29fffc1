"""Per cent of the window in which the card ran none of the port's device
phases, by the program's own device lane: for each worker, 100 x (1 - the
union of its ``device`` rows over the time from their first start to their
last end), the mean over the workers. The rows are CUDA events on the
streams that run each phase, so this sees idle between phases (the stream
run dry while the host stages a stack or between dispatches) and not idle
inside one: a stream waiting inside a phase for the host's next launch
counts as busy, and only a profiler splits that from work
(``device.idle_pct``). None where the program records no device lane."""

LAYER = "loop: extract/base.py dispatch/fetch, in the window"
UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "videos_per_s"


def read(ctx):
    lanes = {}
    for r in ctx["spans"]:
        if r.get("stage") == "device":
            lanes.setdefault(r.get("worker"), []).append((r["t0"], r["t1"]))
    shares = []
    for intervals in lanes.values():
        intervals.sort()
        busy, end = 0.0, None
        for t0, t1 in intervals:
            if end is None or t0 > end:
                busy += t1 - t0
                end = t1
            elif t1 > end:
                busy += t1 - end
                end = t1
        whole = max(t1 for _, t1 in intervals) - intervals[0][0]
        if whole > 0:
            shares.append(100.0 * (1.0 - busy / whole))
    return sum(shares) / len(shares) if shares else None
