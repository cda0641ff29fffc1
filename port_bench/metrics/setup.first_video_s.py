"""Seconds of the first video, run alone through the loop after the build:
the first call at the cell's shapes (cuDNN's plans, K2's load, the
decoder's choice), by the benchmark's clock around the call."""

LAYER = "set-up: extract/registry.py, BaseExtractor.warmup, models/common/weights.py"
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "setup_s"


def read(ctx):
    return ctx["setup"]["first_video_s"]
