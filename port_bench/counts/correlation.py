"""PWC's 81-plane local correlation (K2): its operations, bytes and least
time from its shapes, frozen here so no change to the program moves them.

One multiply and one add per (plane, channel, pixel); f1 and f2 read once,
the planes written once. The least time is the larger of the bytes over
HBM bandwidth and the operations over the dtype's peak.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from port_bench.counts.peaks import FLOPS_PER_S, HBM_BYTES_PER_S

_ITEMSIZE = {"float32": 4, "bfloat16": 2}


def correlation_flops(shape: Sequence[int], max_displacement: int = 4) -> int:
    n, c, h, w = shape
    return 2 * (2 * max_displacement + 1) ** 2 * n * c * h * w


def correlation_bytes(shape: Sequence[int], dtype: str = "float32",
                      max_displacement: int = 4) -> int:
    n, c, h, w = shape
    planes = (2 * max_displacement + 1) ** 2
    return (2 * n * c * h * w + n * planes * h * w) * _ITEMSIZE[dtype]


def correlation_bound(shape: Sequence[int], dtype: str = "float32",
                      max_displacement: int = 4) -> Tuple[float, str]:
    """(least seconds, 'bytes' or 'operations': which bound sets it)."""
    t_bytes = correlation_bytes(shape, dtype, max_displacement) / HBM_BYTES_PER_S
    t_ops = correlation_flops(shape, max_displacement) / FLOPS_PER_S[dtype]
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def pwc_levels(h: int, w: int, pairs: int, level_dims: Sequence[int]):
    """The (N, C, H, W) of each K2 launch of one PWC forward, in launch
    order (levels 6 to 2), for (h, w) frames: PWC stretches them to the next
    multiple of 64 and level l is 2^l smaller."""
    hp, wp = -(-h // 64) * 64, -(-w // 64) * 64
    return [(pairs, level_dims[lvl - 1], hp >> lvl, wp >> lvl) for lvl in (6, 5, 4, 3, 2)]
