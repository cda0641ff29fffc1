"""Mean milliseconds of the port's ``stage_in`` spans in the window: the
loop thread's host staging of one stack inside ``dispatch`` (stacking the
frames, padding them onto the bucket, the pinned copy and the H2D issue;
``models/i3d/extract_i3d.py::_dispatch_stacks``). Host work, so the host
clock is sound for it. None where the program records no such span."""

LAYER = "loop: _dispatch_stacks host staging"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "videos_per_s"


def read(ctx):
    spans = [r["t1"] - r["t0"] for r in ctx["spans"] if r.get("stage") == "stage_in"]
    return 1e3 * sum(spans) / len(spans) if spans else None
