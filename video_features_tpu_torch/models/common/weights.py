"""Checkpoint loading and the random-init gate, shared by every model.

Counterpart of ``video_features_tpu/models/common/weights.py``. Weights
come from local files only: ``.pt``/``.pth`` torch pickles (loaded with
``weights_only``) or ``.npz`` archives. ``compute_dtype`` and
``cast_for_compute`` give a built model the parameters of its
``--dtype bfloat16`` graph; converters stay fp32 in and fp32 out.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

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


def compute_dtype(config) -> torch.dtype:
    """The torch dtype of ``--dtype`` (``config.dtype``)."""
    return torch.bfloat16 if getattr(config, "dtype", "float32") == "bfloat16" else torch.float32


def cast_for_compute(module: torch.nn.Module, dtype: torch.dtype,
                     exclude: Sequence[str] = ()) -> torch.nn.Module:
    """Cast, in place, the floating parameters of ``ndim >= 2`` (conv and
    linear weights, embeddings) to ``dtype``, the JAX package's
    ``cast_floats_for_compute`` rule: 1-d parameters and buffers (norm
    scales and statistics) stay fp32, and so does every parameter with a
    name component in ``exclude`` (a head kept fp32, e.g. CLIP's
    ``proj``). The bias beside a cast weight (``<prefix>bias`` next to
    ``<prefix>weight``) is cast with it, since ``F.conv*``/``F.linear``
    take the input's dtype: the rounding of JAX's ``b.astype(dtype)`` at
    use. fp32 returns the module untouched. Call it after the weights are
    loaded."""
    if dtype == torch.float32:
        return module
    params = dict(module.named_parameters())
    cast = {
        name for name, p in params.items()
        if p.is_floating_point() and p.dim() >= 2
        and not set(name.split(".")) & set(exclude)
    }
    cast |= {name for name in params
             if name.endswith("bias") and name[: -len("bias")] + "weight" in cast}
    with torch.no_grad():
        for name in cast:
            params[name].data = params[name].data.to(dtype)
    return module
