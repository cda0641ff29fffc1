"""Seconds of ``BaseExtractor.warmup(device)``: every model built on the
card and its weights read from ``--weights_path``
(``models/common/weights.py``), by the benchmark's clock around the call."""

LAYER = "set-up: extract/registry.py, BaseExtractor.warmup, models/common/weights.py"
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "setup_s"


def read(ctx):
    return ctx["setup"]["load_s"]
