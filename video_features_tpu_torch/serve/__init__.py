"""The long-lived extraction daemon (``python -m video_features_tpu_torch
serve``).

Counterpart of ``video_features_tpu/serve/``. Modules: :mod:`.lifecycle`
(request records), :mod:`.scheduler` (cross-key dispatch order),
:mod:`.costmodel` (online service-time estimate), :mod:`.batcher`
(bucket-keyed coalescing admission), :mod:`.supervisor` (watchdog and
circuit breaker), :mod:`.preemptor` (HBM-aware eviction at admission),
:mod:`.daemon` (extractor pool + wiring + CLI),
:mod:`.server` (HTTP source), :mod:`.sources` (spool source). Import via
the submodules — this package re-exports nothing, so importing it never
drags in torch (only daemon.py touches the models).
"""
