"""Milliseconds of device preprocess a stack in the window: the sum of the
port's ``device`` rows of phase ``preprocess`` (the device resize and
scaling, the flow net's input, ``flow_chain``: CUDA events on the stream
that runs them, on the host's clock), over the distinct (video, stack)
they belong to. None where the program records no device lane."""

LAYER = "device preprocess: ops/window.py, ops/resize.py, ops/preprocess.py"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "videos_per_s"


def read(ctx):
    per_stack = {}
    for r in ctx["spans"]:
        if r.get("stage") == "device" and r.get("phase") == "preprocess":
            key = (r.get("video") or tuple(r.get("videos") or ()), r.get("stack"))
            per_stack[key] = per_stack.get(key, 0.0) + (r["t1"] - r["t0"])
    return 1e3 * sum(per_stack.values()) / len(per_stack) if per_stack else None
