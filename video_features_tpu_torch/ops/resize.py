"""Bilinear resize with ``F.interpolate`` semantics.

Counterpart of ``video_features_tpu/ops/resize.py::resize_bilinear``
(:54-89), which PWC bakes into its forward (the /64 stretch of its input
and the resize of its flow back). With ``align_corners=False`` torch
clamps negative source coordinates to 0 and reads the last row for
coordinates past it, which is the JAX version's clamp to ``[0, in-1]``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size, align_corners: bool = False) -> torch.Tensor:
    """Resize the last two axes of ``x`` (..., H, W) to ``size`` = (H', W')."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    lead = x.shape[:-2]
    y = F.interpolate(
        x.reshape(-1, 1, *x.shape[-2:]), size=tuple(size), mode="bilinear",
        align_corners=align_corners, antialias=False,
    )
    return y.reshape(*lead, *size)
