"""Mean device milliseconds of one call of the built ``pwc`` module (one
stack of 64 pairs): CUDA events recorded on the current stream by the
benchmark's forward pre- and post-hooks, read after the window."""

LAYER = "models/pwc/model.py"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "videos_per_s"


def read(ctx):
    calls = (ctx["model_ms"] or {}).get("pwc")
    return sum(calls) / len(calls) if calls else None
