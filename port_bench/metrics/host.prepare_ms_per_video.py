"""Mean milliseconds of the port's ``prepare`` spans in the window
(``extract/base.py::_run_pipelined`` on its decode threads: probe, decode,
sampling): host work, so the host clock is sound for it."""

LAYER = "loop: extract/base.py _run_pipelined prepare, io/video.py decode"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "videos_per_s"


def read(ctx):
    spans = [r["t1"] - r["t0"] for r in ctx["spans"] if r["stage"] == "prepare"]
    return 1e3 * sum(spans) / len(spans) if spans else None
