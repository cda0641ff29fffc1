"""``--show_pred``: top-5 classes against ImageNet-1k or Kinetics-400.

Counterpart of ``video_features_tpu/utils/labels.py``. The class-name
lists are this package's own copies (``video_features_tpu_torch/data/``).
Each row prints ``logit softmax class`` for its top 5, then a blank line.
"""

from __future__ import annotations

import functools
import json
import os
from typing import List

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")
_DATASET_FILES = {
    "imagenet": "imagenet_classes.json",
    "kinetics": "kinetics400_classes.json",
}


@functools.lru_cache(maxsize=None)
def load_classes(dataset: str) -> List[str]:
    try:
        fname = _DATASET_FILES[dataset]
    except KeyError:
        raise NotImplementedError(f"unknown label dataset: {dataset}") from None
    with open(os.path.join(_DATA_DIR, fname)) as f:
        return json.load(f)


def show_predictions_on_dataset(logits: np.ndarray, dataset: str, k: int = 5) -> None:
    """Print the top-k (logit, softmax, class) of each row."""
    classes = load_classes(dataset)
    logits = np.asarray(logits, dtype=np.float32)
    if logits.ndim == 1:
        logits = logits[None]
    z = logits - logits.max(axis=-1, keepdims=True)
    softmaxes = np.exp(z) / np.exp(z).sum(axis=-1, keepdims=True)
    top_idx = np.argsort(-softmaxes, axis=-1)[:, :k]
    for b in range(len(logits)):
        for idx in top_idx[b]:
            print(f"{logits[b, idx]:.3f} {softmaxes[b, idx]:.3f} {classes[idx]}")
        print()
