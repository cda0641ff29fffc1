"""Online group service-time estimation for cost-aware scheduling.

Counterpart of ``video_features_tpu/serve/costmodel.py``, copied as it
is (stdlib only), but for :func:`default_model_path`: the port has no
compile cache, so the model always persists under the run's
``_telemetry`` directory.

The EDF scheduler (serve/scheduler.py)
ranks every ready group as if service time were equal, so a cheap
tier-0 group never slots into the slack before an expensive deadline
group. :class:`ServiceTimeModel` closes that gap — an online estimator
of fused-group service time, fed by the dispatcher from the completed
group spans it already times (the same intervals the
``group_service_s.<feature_type>|<bucket>`` histograms record), and
consulted by the ``edf-cost`` scheduler's feasibility ranking.

Estimation is deliberately simple (*any* calibrated cost beats assuming
uniform cost):

- per (feature_type, bucket) key, an EWMA of **per-item** service
  seconds (group seconds / group size), so group-size scaling is
  linear: ``predict(key, n) = ewma_per_item * n``;
- fallback hierarchy when a key has no observations yet: the feature
  type's own aggregate across buckets, then the feature type's weight
  class (:func:`weight_class` — light/medium/heavy, a static prior over
  model families), then the global aggregate, then 0.0 — and a 0.0
  prediction makes ``edf-cost`` rank exactly like plain EDF, so a cold
  daemon degrades to the proven baseline instead of guessing;
- persistence: a JSON file under ``<output>/_telemetry/``, loaded at
  construction and rewritten atomically (throttled) so a restarted
  daemon schedules with yesterday's costs from its first request.

Thread-safety: `observe`/`predict` run on the dispatcher and scheduler
paths under the batcher's condition variable; all state here is behind
one lock with no I/O inside it — :meth:`save` snapshots under the lock
and writes outside it.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional, Tuple, Union

# Static priors over model families: the coarse cost tier a feature
# type starts in before its own observations arrive. Heavy = per-frame
# optical flow / 3D convs; light = small CNN / audio; medium = the rest.
WEIGHT_CLASSES: Dict[str, str] = {
    "resnet18": "light",
    "resnet34": "light",
    "resnet50": "medium",
    "resnet101": "heavy",
    "resnet152": "heavy",
    "CLIP-ViT-B/32": "medium",
    "CLIP-ViT-B/16": "heavy",
    "CLIP4CLIP-ViT-B-32": "medium",
    "i3d": "heavy",
    "r21d_rgb": "heavy",
    "raft": "heavy",
    "pwc": "heavy",
    "vggish": "light",
    "vggish_torch": "light",
}

MODEL_FILENAME = "service_time_model.json"
SCHEMA_VERSION = 1

Key = Union[str, Tuple[str, str]]


def weight_class(feature_type: str) -> str:
    return WEIGHT_CLASSES.get(feature_type, "medium")


def default_model_path(cfg: Any) -> str:
    """Where the estimator persists: the run's ``_telemetry`` directory
    (the JAX package's compile-cache location has no counterpart here)."""
    return os.path.join(cfg.output_path, "_telemetry", MODEL_FILENAME)


def _key_str(key: Key) -> str:
    if isinstance(key, str):
        return key
    ft, bucket = key
    return f"{ft}|{bucket}"


class _Ewma:
    __slots__ = ("value", "n")

    def __init__(self, value: float = 0.0, n: int = 0) -> None:
        self.value = float(value)
        self.n = int(n)

    def update(self, x: float, alpha: float) -> None:
        self.value = x if self.n == 0 else alpha * x + (1.0 - alpha) * self.value
        self.n += 1


class ServiceTimeModel:
    """Per-(feature_type, bucket) EWMA of per-item group service time
    with feature-type / weight-class / global fallbacks. See module
    docstring for the estimation and persistence contract."""

    def __init__(
        self,
        path: Optional[str] = None,
        alpha: float = 0.25,
        save_every: int = 16,
    ) -> None:
        self.path = path
        self.alpha = float(alpha)
        self.save_every = max(int(save_every), 1)
        self._lock = threading.Lock()
        self._keys: Dict[str, _Ewma] = {}
        self._fts: Dict[str, _Ewma] = {}
        self._classes: Dict[str, _Ewma] = {}
        self._global = _Ewma()
        self._observations = 0
        self._dirty = 0
        if path is not None:
            self._load(path)

    # -- the write side (dispatcher thread) ------------------------------

    def observe(
        self, feature_type: str, bucket: str, group_size: int, seconds: float
    ) -> None:
        """Fold one completed group's wall seconds in; throttled
        auto-save when a path is configured (file write happens outside
        the model lock)."""
        if seconds < 0 or group_size < 1:
            return
        per_item = float(seconds) / max(int(group_size), 1)
        save_now = False
        with self._lock:
            self._keys.setdefault(_key_str((feature_type, bucket)), _Ewma()) \
                .update(per_item, self.alpha)
            self._fts.setdefault(feature_type, _Ewma()).update(per_item, self.alpha)
            self._classes.setdefault(weight_class(feature_type), _Ewma()) \
                .update(per_item, self.alpha)
            self._global.update(per_item, self.alpha)
            self._observations += 1
            self._dirty += 1
            if self.path is not None and self._dirty >= self.save_every:
                self._dirty = 0
                save_now = True
        if save_now:
            self.save()

    # -- the read side (scheduler rank, /v1/stats) -----------------------

    def predict(self, key: Key, group_size: int) -> float:
        """Predicted service seconds for a group of ``group_size`` at
        ``key`` (``(feature_type, bucket)`` or the ``"ft|bucket"``
        string). 0.0 when nothing relevant has been observed — the
        edf-cost scheduler then ranks exactly like plain EDF."""
        ks = _key_str(key)
        ft = ks.split("|", 1)[0]
        with self._lock:
            for est in (
                self._keys.get(ks),
                self._fts.get(ft),
                self._classes.get(weight_class(ft)),
                self._global,
            ):
                if est is not None and est.n > 0:
                    return est.value * max(int(group_size), 1)
        return 0.0

    def observations(self) -> int:
        with self._lock:
            return self._observations

    def snapshot(self) -> Dict[str, Any]:
        """The /v1/stats block: per-key per-item estimates + fallbacks."""
        with self._lock:
            return {
                "observations": self._observations,
                "keys": {
                    k: {"per_item_s": round(e.value, 6), "n": e.n}
                    for k, e in sorted(self._keys.items())
                },
                "feature_types": {
                    k: {"per_item_s": round(e.value, 6), "n": e.n}
                    for k, e in sorted(self._fts.items())
                },
                "weight_classes": {
                    k: {"per_item_s": round(e.value, 6), "n": e.n}
                    for k, e in sorted(self._classes.items())
                },
                "global": {"per_item_s": round(self._global.value, 6),
                           "n": self._global.n},
            }

    # -- persistence ------------------------------------------------------

    def save(self, path: Optional[str] = None) -> Optional[str]:
        """Atomic rewrite of the persistence file. Snapshot under the
        lock, write outside it (no blocking I/O under a lock on
        the dispatch path). Returns the path written, or None."""
        path = path or self.path
        if path is None:
            return None
        with self._lock:
            doc = {
                "version": SCHEMA_VERSION,
                "alpha": self.alpha,
                "observations": self._observations,
                "keys": {k: [e.value, e.n] for k, e in self._keys.items()},
                "feature_types": {k: [e.value, e.n] for k, e in self._fts.items()},
                "weight_classes": {k: [e.value, e.n] for k, e in self._classes.items()},
                "global": [self._global.value, self._global.n],
            }
        from video_features_tpu_torch.io.sink import atomic_write_json

        return atomic_write_json(path, doc)

    def _load(self, path: str) -> None:
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return  # no/torn prior state: start cold
        if not isinstance(doc, dict) or doc.get("version") != SCHEMA_VERSION:
            return

        def fold(src: Any) -> Dict[str, _Ewma]:
            out: Dict[str, _Ewma] = {}
            if isinstance(src, dict):
                for k, pair in src.items():
                    try:
                        v, n = float(pair[0]), int(pair[1])
                    except (TypeError, ValueError, IndexError):
                        continue
                    if n > 0 and v >= 0:
                        out[str(k)] = _Ewma(v, n)
            return out

        with self._lock:
            self._keys = fold(doc.get("keys"))
            self._fts = fold(doc.get("feature_types"))
            self._classes = fold(doc.get("weight_classes"))
            g = doc.get("global")
            try:
                self._global = _Ewma(float(g[0]), int(g[1]))
            except (TypeError, ValueError, IndexError):
                self._global = _Ewma()
            self._observations = int(doc.get("observations") or 0)
