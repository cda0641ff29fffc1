"""The operation and byte counts against hand counts at tiny sizes."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.counts.correlation import (
    correlation_bound,
    correlation_bytes,
    correlation_flops,
    pwc_levels,
)
from port_bench.counts.flops import flops_per_stack
from port_bench.counts.peaks import FLOPS_PER_S, HBM_BYTES_PER_S
from port_bench.harness import spec
from port_bench.reference.i3d import Unit3D


def test_correlation_counts_by_hand():
    shape = (2, 3, 4, 5)  # 120 input values a map
    assert correlation_flops(shape) == 2 * 81 * 120
    assert correlation_bytes(shape) == (2 * 120 + 2 * 81 * 20) * 4
    t, which = correlation_bound(shape)
    assert t == max((2 * 120 + 2 * 81 * 20) * 4 / HBM_BYTES_PER_S,
                    2 * 81 * 120 / FLOPS_PER_S["float32"])
    assert which == "bytes"


def test_pwc_levels_stretch_to_64_and_halve():
    dims = spec.config("i3d_pwc")["sizes"]["pwc"]["level_dims"]
    assert pwc_levels(256, 340, 64, dims) == [(64, 196, 4, 6), (64, 128, 8, 12),
                                              (64, 96, 16, 24), (64, 64, 32, 48),
                                              (64, 32, 64, 96)]


def test_the_counter_counts_a_conv_as_two_per_multiply_add():
    with torch.device("meta"):
        unit = Unit3D(3, 8, (3, 3, 3))
        counter = FlopCounterMode(display=False)
        with counter:
            unit(torch.empty(1, 3, 4, 6, 6))
    # SAME pads keep 4x6x6 outputs; each is 3*27 multiply-adds per channel
    assert counter.get_total_flops() == 2 * 8 * 4 * 6 * 6 * 3 * 27


def test_pwc_stack_adds_the_correlation_the_counter_cannot_see():
    config = spec.config("i3d_pwc")
    config["pipeline"]["stack_size"] = 16
    with_corr = flops_per_stack(config, 64, 64, width_div=8)
    sizes = config["sizes"]["pwc"]
    corr = sum(correlation_flops(s) for s in pwc_levels(64, 64, 16, sizes["level_dims"]))
    assert corr == 2 * 81 * 16 * (196 + 128 * 4 + 96 * 16 + 64 * 64 + 32 * 256)
    assert with_corr > corr
