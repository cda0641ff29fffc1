"""Checkpoint loading and the random-init gate, shared by every model.

Counterpart of ``video_features_tpu/models/common/weights.py``. Weights
come from local files only, in the formats the JAX package's
``load_params`` takes: ``.pt``/``.pth`` torch pickles (loaded with
``weights_only``) or ``.npz`` archives in the reference's layout, and the
JAX package's converted Flax trees, a ``.msgpack`` file (read by
``flax_msgpack``) or an orbax checkpoint directory (read by ``orbax``,
the port's own OCDBT and zarr codec); neither needs an extra package.
``compute_dtype`` and ``cast_for_compute`` give a built model the
parameters of its ``--dtype bfloat16`` graph; converters stay fp32 in
and fp32 out.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from video_features_tpu_torch.models.common.orbax import is_orbax_checkpoint, load_orbax


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
            "(expected .npz or a torch pickle .pt/.pth/.pytorch/.bin; a converted "
            "Flax .msgpack or an orbax checkpoint directory goes through load_params)"
        )
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {
        k: v.detach().to(torch.float32).numpy()
        for k, v in obj.items()
        if isinstance(v, torch.Tensor)
    }


def _host_leaves(tree):
    """A converted tree with every leaf a numpy array: ``bfloat16`` leaves
    (torch tensors from ``flax_msgpack`` and ``orbax``) widened to float32,
    which holds each of them exactly."""
    if isinstance(tree, dict):
        return {k: _host_leaves(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree


def load_params(path: str, convert: Callable, from_jax: Callable):
    """The port's state dict of the checkpoint at ``--weights_path``, in the
    JAX package's ``load_params`` order: an orbax directory or a
    ``.msgpack`` holds the JAX package's converted Flax tree (a
    ``{"params": ...}`` wrapper stripped), which ``from_jax`` turns into
    the port's state dict; anything else is a reference-layout state dict
    for ``convert``.

    Each process reads the whole checkpoint into host memory, also in a
    mesh across launched processes, where the JAX package restores each
    orbax shard onto its own process (its CLIP extractor's
    ``load_orbax`` with a mesh). The port needs no shard-by-shard
    restore: its model axis stays inside a process, so a process runs
    every model shard of its own data rows (CLIP cuts them from this
    host copy, ``sharding.clip_vit_shard_state``) and the other families
    replicate whole weights on every row. A host copy per process is
    what each process needs either way."""
    if is_orbax_checkpoint(path):
        return from_jax(_host_leaves(load_orbax(path)))
    if path.endswith(".msgpack"):
        if not os.path.exists(path):
            raise FileNotFoundError(f"weights not found: {path}")
        from video_features_tpu_torch.models.common.flax_msgpack import load_msgpack

        tree = load_msgpack(path)
        if isinstance(tree, dict) and set(tree) == {"params"}:
            tree = tree["params"]
        return from_jax(_host_leaves(tree))
    return convert(load_state_dict(path))


# --- the port's state dict -> the JAX package's Flax tree (params_to_jax) ---

def to_numpy(t) -> np.ndarray:
    """A state-dict tensor as the float32 array ``load_state_dict`` gives
    the JAX package's converters."""
    return t.detach().to(torch.float32).cpu().numpy()


def linear_kernel(w: np.ndarray) -> np.ndarray:
    """Linear weight (out, in) -> Flax Dense kernel (in, out)."""
    return np.ascontiguousarray(w.T)


def conv_kernel(w: np.ndarray) -> np.ndarray:
    """Conv weight (O, I, *k) -> Flax kernel (*k, I, O), 2-d or 3-d."""
    k = tuple(range(2, w.ndim))
    return np.ascontiguousarray(np.transpose(w, k + (1, 0)))


def bn_to_jax(sd, prefix: str) -> Dict[str, np.ndarray]:
    """BatchNorm ``weight``/``bias``/``running_mean``/``running_var`` ->
    the JAX package's ``scale``/``bias``/``mean``/``var``."""
    return {"scale": to_numpy(sd[f"{prefix}.weight"]), "bias": to_numpy(sd[f"{prefix}.bias"]),
            "mean": to_numpy(sd[f"{prefix}.running_mean"]),
            "var": to_numpy(sd[f"{prefix}.running_var"])}


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
