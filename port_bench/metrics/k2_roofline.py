"""K2's share of its roofline, in per cent: the least time of its launches
over their device time in the ``torch.profiler`` trace. Each PWC forward
launches K2 five times (levels 6 to 2), a few ms apart at most, while
forwards are an I3D pass apart (tens of ms): launches less than 25 ms
apart on one card are one forward, and only whole forwards count. A launch's least time is
the larger of its bytes (inputs read once, the 81 planes written once) over
HBM bandwidth and its operations over the fp32 peak (``counts/``)."""

import sys

LAYER = "ops/correlation.py K2: csrc/local_correlation.cu"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "videos_per_s"

_GAP_S = 25e-3


def read(ctx):
    from port_bench.counts.correlation import correlation_bound, pwc_levels

    t = ctx["trace"]
    if not t or not t["k2"]:
        return None
    groups, last = [], {}
    for start, dur, card in t["k2"]:
        if card not in last or start - last[card][0] > _GAP_S:
            last[card] = [0.0, []]
            groups.append(last[card][1])
        last[card][1].append(dur)
        last[card][0] = start + dur
    config = ctx["config"]
    sizes = config["sizes"]["pwc"]
    shapes = pwc_levels(*ctx["video_hw"], config["pipeline"]["stack_size"], sizes["level_dims"])
    bounds = [correlation_bound(s, config["dtype"], sizes["max_displacement"])[0] for s in shapes]
    whole = [g for g in groups if len(g) == len(shapes)]
    if len(whole) < len(groups):
        print(f"k2_roofline: {len(groups) - len(whole)} of {len(groups)} forwards cut by the "
              "trace's ends or split", file=sys.stderr)
    if not whole:
        return None
    return 100.0 * len(whole) * sum(bounds) / sum(sum(g) for g in whole)
