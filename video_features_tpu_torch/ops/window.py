"""Frame-batch padding to a few bucket sizes, and the spatial buckets of
``--preprocess device``.

Counterpart of ``video_features_tpu/ops/window.py``: a video's sampled
frames are zero-padded up to a bucket (``uni_12`` -> 16) and the pad
rows' features are dropped after the forward, so both packages run the
model on the same batch. Under ``--preprocess device`` raw frames pad up
to a spatial bucket as well (``spatial_bucket``), so videos of nearby
resolutions share one shape and can fuse into one ``--video_batch``
group. Each spatial and flow-output bucket is noted to the run's
telemetry (``buckets_seen``), as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

from video_features_tpu_torch.runtime import telemetry


def bucket_size(n: int, multiple: int = 8, buckets: Optional[Sequence[int]] = None) -> int:
    """Smallest allowed padded size >= n."""
    if buckets:
        for b in sorted(buckets):
            if n <= b:
                return b
        return int(math.ceil(n / multiple) * multiple)
    return max(int(math.ceil(n / multiple) * multiple), multiple)


def pad_batch(x: np.ndarray, to: int) -> np.ndarray:
    """Zero-pad axis 0 of ``x`` up to ``to`` rows."""
    if x.shape[0] == to:
        return x
    return np.pad(x, [(0, to - x.shape[0])] + [(0, 0)] * (x.ndim - 1))


def spatial_bucket(
    h: int, w: int, multiple: int = 64,
    buckets: Optional[Sequence[Tuple[int, int]]] = None,
) -> Tuple[int, int]:
    """The padded (bucket_h, bucket_w) a raw frame rounds up to under
    ``--preprocess device``: each axis to the next ``multiple`` (floor
    ``multiple``), or the smallest of the explicit (h, w) ``buckets``
    that fits both axes. The pad carries zero resize weight
    (``ops/resize.py::fused_resize_crop_matrices``), so bucketing changes
    only the shape the videos of a bucket share, never the output."""
    if buckets:
        for bh, bw in sorted(buckets, key=lambda b: b[0] * b[1]):
            if h <= bh and w <= bw:
                telemetry.note_bucket((int(bh), int(bw)))
                return int(bh), int(bw)
    out = bucket_size(h, multiple), bucket_size(w, multiple)
    telemetry.note_bucket(out)
    return out


def flow_output_bucket(
    oh: int, ow: int, multiple: int = 64, div: int = 8, min_size: int = 128,
) -> Tuple[int, int]:
    """Output-side bucket of a shape-contracted flow grid: the resized
    (oh, ow) rounds up to RAFT's padded input grid (``/div`` multiples,
    ``min_size`` floor), then up to ``multiple``. ``multiple=div`` makes
    the bucket the exact padder grid."""
    tgt_h = max(int(math.ceil(oh / div) * div), min_size)
    tgt_w = max(int(math.ceil(ow / div) * div), min_size)
    out = bucket_size(tgt_h, multiple), bucket_size(tgt_w, multiple)
    telemetry.note_bucket(("flow",) + out)
    return out


def pad_hw(x: np.ndarray, to_h: int, to_w: int) -> np.ndarray:
    """Zero-pad the (H, W) axes of (..., H, W, C) frames up to the
    spatial bucket."""
    h, w = x.shape[-3], x.shape[-2]
    if h == to_h and w == to_w:
        return x
    return np.pad(x, [(0, 0)] * (x.ndim - 3) + [(0, to_h - h), (0, to_w - w), (0, 0)])
