"""Telemetry consumers: the span schema and
``python -m video_features_tpu_torch.telemetry``.

Counterpart of ``video_features_tpu/telemetry/__init__.py``. The
recording engine lives in :mod:`video_features_tpu_torch.runtime.telemetry`
(it is part of the hot path); this package is the read side: the span
JSONL schema (``spans_schema.json``, byte-equal to the JAX package's) and
the CLI consumers in ``__main__.py``. The engine's public names are
re-exported here so consumers can import one module. The serve daemon's
Prometheus text (``GET /metrics``) is rendered by ``exposition.py``, and
the device cost ledger (each model call's flops and memory, the resident
projection, the live device-memory gauges) lives in ``ledger.py``.
"""

from __future__ import annotations

import json
import os

from video_features_tpu_torch.runtime.telemetry import (  # noqa: F401
    DEVICE_STAGES,
    HOST_STAGES,
    STAGES,
    MetricsRegistry,
    SloTracker,
    Telemetry,
    collect,
    overlap_report,
    read_spans,
    request_trace_rows,
    spans_to_chrome_trace,
    utilization_report,
)

SCHEMA_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "spans_schema.json")


def load_schema() -> dict:
    with open(SCHEMA_PATH, "r", encoding="utf-8") as f:
        return json.load(f)
