"""Parity ceilings — the port's committed (family, dtype, kind) drift table.

Counterpart of ``video_features_tpu/analysis/parity.py``: the same
``rel_drift``, ``max_rel_drift`` and ``assert_drift_within``, reading the
ceilings from ``config.PARITY_CEILINGS`` (the JAX package's committed
``max_rel`` values, copied there) instead of a ``parity_budget.json``.
GC804 (``analysis/numerics.py``) cross-checks that table against
``config.LOW_PRECISION_MODEL_FAMILIES`` and asks
``tests/test_torch_bfloat16.py`` to assert each admitted pair through
these helpers. The JAX package's ``--update-budgets`` drift scenarios are
left out: a ceiling is a reviewed edit of ``config.py``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

Ceilings = Dict[Tuple[str, str, str], float]


def _ceilings(table: Optional[Ceilings]) -> Ceilings:
    if table is not None:
        return table
    from video_features_tpu_torch.config import PARITY_CEILINGS

    return PARITY_CEILINGS


def max_rel_drift(
    family: str, dtype: str, kind: str, table: Optional[Ceilings] = None
) -> float:
    """The committed drift ceiling, or a KeyError that says where to
    commit one (the GC804 contract: no ceiling, no admission)."""
    try:
        return float(_ceilings(table)[(family, dtype, kind)])
    except KeyError:
        raise KeyError(
            f"no parity ceiling for ({family!r}, {dtype!r}, {kind!r}) in "
            "config.PARITY_CEILINGS: commit one before admitting the pair"
        ) from None


def rel_drift(low, ref) -> float:
    """Relative L2: ||low - ref|| / ||ref||, in float64."""
    import numpy as np

    low = np.asarray(low, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(low - ref) / max(np.linalg.norm(ref), 1e-12))


def assert_drift_within(
    family: str,
    dtype: str,
    kind: str,
    low,
    ref,
    table: Optional[Ceilings] = None,
) -> float:
    """Assert ``rel_drift(low, ref)`` stays under the committed ceiling;
    returns the measured drift so tests can also pin a nonzero floor
    (identical outputs would mean the low-precision graph never ran)."""
    ceiling = max_rel_drift(family, dtype, kind, table=table)
    measured = rel_drift(low, ref)
    assert measured <= ceiling, (
        f"({family}, {dtype}, {kind}) drift {measured:.5f} exceeds the "
        f"committed ceiling {ceiling} in config.PARITY_CEILINGS"
    )
    return measured
