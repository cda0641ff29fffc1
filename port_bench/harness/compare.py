"""The numbers that decide ``correct``."""

from __future__ import annotations

import math

import numpy as np


def rel_l2_rows(got: np.ndarray, ref: np.ndarray) -> float:
    """The worst row's ``||got - ref|| / ||ref||`` (a row is one stack's
    1024 features), in float64; inf when the shapes differ or a value is
    not finite."""
    if got.shape != ref.shape or not np.all(np.isfinite(got)):
        return math.inf
    got, ref = got.astype(np.float64), ref.astype(np.float64)
    num = np.linalg.norm(got - ref, axis=-1)
    den = np.maximum(np.linalg.norm(ref, axis=-1), np.finfo(np.float64).tiny)
    return float(np.max(num / den))
