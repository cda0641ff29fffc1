"""Mean device milliseconds of one call of the built ``raft`` module (one
stack of 64 pairs): CUDA events recorded on the current stream by the
benchmark's forward pre- and post-hooks, read after the window."""

LAYER = "models/raft/model.py"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "videos_per_s"


def read(ctx):
    calls = (ctx["model_ms"] or {}).get("raft")
    return sum(calls) / len(calls) if calls else None
