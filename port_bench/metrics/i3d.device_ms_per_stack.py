"""Mean device milliseconds of both I3D streams on one stack (the built
``rgb`` and ``flow`` modules' calls, added): CUDA events recorded on the
current stream by the benchmark's forward pre- and post-hooks."""

LAYER = "models/i3d/model.py"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "videos_per_s"


def read(ctx):
    ms = ctx["model_ms"] or {}
    rgb, flow = ms.get("rgb"), ms.get("flow")
    if not rgb or not flow:
        return None
    return sum(rgb) / len(rgb) + sum(flow) / len(flow)
