"""Per cent of the traced stretch in which no operation ran on the card:
100 x (1 - the union of device-activity intervals over the stretch from the
first to the last of them), from the ``torch.profiler`` trace."""

LAYER = "device: the card"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "videos_per_s"


def read(ctx):
    t = ctx["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
