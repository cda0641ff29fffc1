"""Frame-delta gating (``--frame_delta_threshold``, the CLIP family).

Counterpart of ``video_features_tpu/ops/sampler.py::frame_delta_keep_mask``
and ``copy_forward`` (:108-138). Adjacent sampled frames of real video are
largely redundant: the gate runs on the host over the decoded uint8
frames, a near-duplicate frame never crosses to the device, and at fetch
its feature row is copied from the latest kept frame. The grid sampler of
that module is left unported on purpose (the port uses torch's
``grid_sample``).
"""

from __future__ import annotations

import numpy as np


def frame_delta_keep_mask(frames, threshold: float) -> np.ndarray:
    """Boolean keep-mask over ``frames`` (a sequence of HWC uint8 arrays).

    Frame 0 is always kept. Frame i is skipped when its mean absolute
    uint8 delta against the last *kept* frame is strictly below
    ``threshold``: against the last kept frame, so a slow drift re-keys
    once it has added up to the threshold; strictly, so ``threshold=0``
    keeps every frame (the flag's zero value gives the ungated
    features)."""
    n = len(frames)
    keep = np.ones(n, dtype=bool)
    if n <= 1 or threshold <= 0:
        return keep
    last = np.asarray(frames[0], dtype=np.int16)
    for i in range(1, n):
        cur = np.asarray(frames[i], dtype=np.int16)
        if float(np.mean(np.abs(cur - last))) < threshold:
            keep[i] = False
        else:
            last = cur
    return keep


def copy_forward(rows: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """Expand the kept frames' feature ``rows`` (``keep.sum()`` of them)
    to the full sampling grid: position i takes the row of the latest kept
    frame at or before i (``keep[0]`` is always True)."""
    keep = np.asarray(keep, dtype=bool)
    return rows[np.cumsum(keep) - 1]
