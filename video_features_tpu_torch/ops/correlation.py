"""PWC's 81-channel cost volume: the plain version and the way to K2.

Counterpart of ``video_features_tpu/ops/correlation.py::local_correlation``
(:77-127). Output channel ``(dy+d)*(2d+1) + (dx+d)`` holds the mean over C
of ``f1[c, y, x] * f2[c, y+dy, x+dx]``, with f2 zero outside its plane.

A CPU tensor goes to ``local_correlation_reference``; a CUDA tensor
launches the Hopper kernel (``ops/correlation_kernel.py``) at every size,
or raises. The JAX package's size router (``DEFAULT_PALLAS_MIN_HW``,
``corr_routing.json``) was measured for a TPU and has no counterpart here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from video_features_tpu_torch.ops.correlation_kernel import local_correlation_kernel
from video_features_tpu_torch.telemetry.ledger import kernel_flops

METHODS = ("auto", "plain")


def local_correlation_reference(
    f1: torch.Tensor, f2: torch.Tensor, max_displacement: int = 4
) -> torch.Tensor:
    """The shifted reduce: 81 products of f1 with a shifted zero-padded
    f2, each meaned over C in fp32, cast back to the input dtype."""
    N, C, H, W = f1.shape
    d = max_displacement
    f2p = F.pad(f2, (d, d, d, d))
    planes = []
    for dy in range(-d, d + 1):
        for dx in range(-d, d + 1):
            shifted = f2p[:, :, d + dy : d + dy + H, d + dx : d + dx + W]
            planes.append((f1 * shifted).mean(1, dtype=torch.float32))
    return torch.stack(planes, 1).to(f1.dtype)


def local_correlation(
    f1: torch.Tensor,
    f2: torch.Tensor,
    max_displacement: int = 4,
    method: str = "auto",
) -> torch.Tensor:
    """(N, C, H, W) x2 -> (N, (2d+1)^2, H, W). ``method='plain'`` forces
    the plain version on any device; ``'auto'`` takes the kernel on the
    card and the plain version on the CPU. Inside a cost-ledger capture
    the call counts ``correlation_flops`` whichever version runs
    (``telemetry/ledger.py::kernel_flops``)."""
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    with kernel_flops(correlation_flops(f1, max_displacement) if f1.dim() == 4 else 0):
        if method == "plain" or (f1.device.type == "cpu" and f2.device.type == "cpu"):
            return local_correlation_reference(f1, f2, max_displacement)
        return local_correlation_kernel(f1, f2, max_displacement)


def correlation_flops(f1: torch.Tensor, max_displacement: int = 4) -> int:
    """K2's operations, as the cost ledger counts them: one multiply and
    one add per (plane, channel, pixel), 2 * 81 * N * C * H * W at d=4."""
    n, c, h, w = f1.shape
    return 2 * (2 * max_displacement + 1) ** 2 * n * c * h * w
