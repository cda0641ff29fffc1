"""Checkpoint loading and the random-init gate, shared by every model.

Counterpart of ``video_features_tpu/models/common/weights.py``. Weights
come from local files only: ``.pt``/``.pth`` torch pickles (loaded with
``weights_only``) or ``.npz`` archives.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A torch/npz checkpoint as a flat {name: float32 ndarray}."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"weights not found: {path}")
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: np.asarray(z[k]) for k in z.files}
    if not path.endswith((".pt", ".pth", ".pytorch", ".bin")):
        raise ValueError(
            f"unsupported checkpoint format: {path} "
            "(expected .npz or a torch pickle .pt/.pth/.pytorch/.bin)"
        )
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {
        k: v.detach().to(torch.float32).numpy()
        for k, v in obj.items()
        if isinstance(v, torch.Tensor)
    }


def check_all_consumed(sd, consumed, model_name: str) -> None:
    """A converter must account for every checkpoint tensor: silent drops
    are how weight-porting bugs hide."""
    left = {k for k in set(sd) - set(consumed) if not k.endswith("num_batches_tracked")}
    if left:
        raise ValueError(
            f"{model_name} converter left {len(left)} tensors unconsumed, e.g. "
            f"{sorted(left)[:5]}"
        )


def random_init_fallback(config, model_name: str, expected: str) -> None:
    """The gate in front of random init: raises unless
    ``--allow_random_init`` was passed, and warns loudly when it was."""
    if getattr(config, "allow_random_init", False):
        print(
            f"WARNING: {model_name}: no pretrained weights loaded — running "
            "with seeded random init; extracted features are MEANINGLESS "
            "(--allow_random_init)."
        )
        return
    raise RuntimeError(
        f"{model_name}: no pretrained weights. Expected {expected}. "
        "Pass --weights_path, or --allow_random_init to run with random "
        "weights (meaningless features; tests/benchmarks only)."
    )


def load_checked(model: torch.nn.Module, sd, model_name: str) -> None:
    """``model.load_state_dict(sd)``, where a checkpoint may lack only
    BatchNorm's ``num_batches_tracked`` counters (eval never reads them)."""
    res = model.load_state_dict(sd, strict=False)
    bad = res.unexpected_keys + [
        k for k in res.missing_keys if not k.endswith("num_batches_tracked")
    ]
    if bad:
        raise ValueError(f"{model_name} state dict does not fit the model, e.g. {bad[:5]}")
