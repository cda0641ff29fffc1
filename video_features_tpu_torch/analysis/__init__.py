"""graftcheck for the port — the static-analysis suite of
``video_features_tpu_torch/``.

Counterpart of ``video_features_tpu/analysis/``, retargeted at PyTorch
and CUDA. The checker families turn the design rules the port's hot path
and runtime depend on into tier-1 test failures instead of review-time
folklore:

- GC10x host-sync lint (:mod:`.hostsync`) — no hidden device->host
  syncs (``.item()``, ``.cpu()``, ``float()`` of a device tensor,
  ``synchronize``) inside the per-video hot loop.
- GC301 thread-safety lint (:mod:`.thread_safety`) — module-level
  mutable state on thread-reachable paths is locked, thread-local, or
  explicitly waived.
- GC31x concurrency lint (:mod:`.concurrency`) — lock ordering, no
  blocking I/O, builds or device syncs under a held lock on dispatch
  paths.
- GC505 mesh admission (:mod:`.sharding_contract`) — every type admitted
  for ``--sharding mesh`` reaches the port's mesh path.
- GC60x durability contracts (:mod:`.durability`) — durable publishes
  stage-then-``os.replace`` (``torch.save``, ``save_msgpack`` and
  ``save_orbax`` included), claim/lease sites branch on losing and
  heartbeat what they hold, renames carry the right semantics.
- GC70x observability contracts (:mod:`.obs_contract`) — every metric
  name maps to a curated exposition family (and every family has a
  producer), fault stages match ``fire()`` sites both directions, and
  config.py's flags / dataclass fields / sanity checks stay in sync.
- GC80x numerics & dtype-flow contracts (:mod:`.numerics`) — no f64
  reaches a model's forward, sensitive reductions under bf16 pin fp32,
  host-side float32 casts on frame payloads are declared islands, every
  admitted (family, dtype) pair has a ``config.PARITY_CEILINGS`` entry and
  an e2e assertion, and each CUDA kernel keeps its build, counter, plain
  twin, card test and fp32 accumulators.

Run ``python -m video_features_tpu_torch.analysis`` (CLI) or
``pytest -m analysis`` (tier-1). Waive individual findings with inline
``# graftcheck: <rule> — reason`` comments; audit them all with
``git grep 'graftcheck:'``. Nothing here imports JAX or the JAX package.
"""

from video_features_tpu_torch.analysis.core import (
    Finding,
    Rule,
    all_rules,
    collect_sources,
    run_checks,
)
from video_features_tpu_torch.analysis.parity import (
    assert_drift_within,
    max_rel_drift,
    rel_drift,
)

__all__ = [
    "Finding",
    "Rule",
    "all_rules",
    "assert_drift_within",
    "collect_sources",
    "max_rel_drift",
    "rel_drift",
    "run_checks",
]
