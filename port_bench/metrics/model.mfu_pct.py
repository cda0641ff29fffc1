"""The whole step's share of the cards' fp32 peak, in per cent: the
operations of one video (``counts/flops.py``: the reference's forward
counted on ``meta`` tensors, plus PWC's correlation) times the traced run's
videos per second (its window, before the trace), over 165 TFLOP/s a card
(``counts/peaks.py``) times the cards."""

LAYER = "whole step: decode to features"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "videos_per_s"


def read(ctx):
    from port_bench.counts.flops import flops_per_stack
    from port_bench.counts.peaks import FLOPS_PER_S

    rate = ctx["window"]["rate"]
    if not rate:
        return None
    per_video = ctx["stacks_per_video"] * flops_per_stack(ctx["config"], *ctx["video_hw"])
    return 100.0 * per_video * rate / (FLOPS_PER_S[ctx["config"]["dtype"]] * ctx["chips"])
