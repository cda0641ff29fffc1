"""Frame-batch padding to a few bucket sizes.

Counterpart of ``video_features_tpu/ops/window.py``: a video's sampled
frames are zero-padded up to a bucket (``uni_12`` -> 16) and the pad
rows' features are dropped after the forward, so both packages run the
model on the same batch.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np


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
