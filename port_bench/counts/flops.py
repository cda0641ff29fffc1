"""Operations of one video, counted once from shapes on the reference's
models (``torch.utils.flop_counter.FlopCounterMode`` over their forward
on ``meta`` tensors), plus PWC's correlation (``counts/correlation.py``),
which is elementwise work that the counter does not see. So the count is
the work of the algorithm, whatever implements it.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.counts.correlation import correlation_flops, pwc_levels
from port_bench.harness.inputs import reference_models


def flops_per_stack(config: dict, height: int, width: int, width_div: int = 1) -> int:
    """One stack: the flow net over ``stack_size`` pairs at the frames'
    (``height``, ``width``) after the ``min_side`` resize, and both I3D
    streams over ``stack_size`` frames at ``crop``."""
    pipe = config["pipeline"]
    t, crop = pipe["stack_size"], pipe["crop"]
    models = reference_models(config, width_div)
    flow_type = config["flow_type"]
    total = 0
    with torch.no_grad(), torch.device("meta"):
        counter = FlopCounterMode(display=False)
        with counter:
            models["rgb"](torch.empty(1, 3, t, crop, crop))
            models["flow"](torch.empty(1, 2, t, crop, crop))
            if flow_type == "raft":
                models["raft"](torch.empty(t + 1, 3, -(-height // 8) * 8, -(-width // 8) * 8))
            else:
                models["pwc"].estimate(torch.empty(t + 1, 3, height, width))
        total += counter.get_total_flops()
    if flow_type == "pwc":
        sizes = config["sizes"]["pwc"]
        total += sum(correlation_flops(s, sizes["max_displacement"])
                     for s in pwc_levels(height, width, t, sizes["level_dims"]))
    return int(total)
