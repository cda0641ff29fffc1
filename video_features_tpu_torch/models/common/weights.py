"""Checkpoint loading and the random-init gate, shared by every model.

Counterpart of ``video_features_tpu/models/common/weights.py``. Weights
come from local files only, in the formats the JAX package's
``load_params`` takes: ``.pt``/``.pth`` torch pickles (loaded with
``weights_only``) or ``.npz`` archives in the reference's layout, and the
JAX package's converted Flax trees, a ``.msgpack`` file (read by
``flax_msgpack``, no extra package) or an orbax checkpoint directory
(read through ``tensorstore``, imported only there). ``compute_dtype``
and ``cast_for_compute`` give a built model the parameters of its
``--dtype bfloat16`` graph; converters stay fp32 in and fp32 out.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Sequence

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


def is_orbax_checkpoint(path: str) -> bool:
    """An orbax checkpoint directory, told from a plain weights directory
    (I3D's directory of reference-named files) by its marker file."""
    return os.path.isdir(path) and (
        os.path.exists(os.path.join(path, "_CHECKPOINT_METADATA"))
        or os.path.exists(os.path.join(path, "_METADATA"))
    )


def load_orbax(path: str) -> Dict[str, Any]:
    """An orbax ``StandardCheckpointer`` directory -> its nested dict of
    numpy arrays.

    ``_METADATA``'s ``tree_metadata`` lists each leaf's keys; the leaf is
    a zarr array named by the dotted keys in the directory's ocdbt
    key-value store (orbax's defaults; a checkpoint written with
    ``use_ocdbt`` off or ``use_zarr3`` on is refused). ``tensorstore``
    reads them, imported here and nowhere else; without it this refuses
    the checkpoint, since a ``.msgpack`` of the same tree needs no extra
    package.

    The whole tree is read on this host. That is enough while every mesh
    is one process: CLIP's mesh cuts its shards from the host tree and the
    other families replicate it. A multi-process mesh would restore each
    shard on its own process instead."""
    path = os.path.abspath(path)
    try:
        import tensorstore as ts
    except ImportError:
        raise RuntimeError(
            f"{path} is an orbax checkpoint directory, and reading one needs the "
            "tensorstore package, which is not installed here. Convert the weights to a "
            ".msgpack file instead (python -m video_features_tpu_torch.convert_weights), "
            "which needs no extra package."
        ) from None
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", True) or meta.get("use_zarr3"):
        raise ValueError(f"{path}: an orbax layout this reader does not take (use_ocdbt "
                         f"{meta.get('use_ocdbt')}, use_zarr3 {meta.get('use_zarr3')})")
    ctx = ts.Context()
    opened = {}
    for entry in meta["tree_metadata"].values():
        keys = [k["key"] for k in entry["key_metadata"]]
        kinds = {k.get("key_type") for k in entry["key_metadata"]}
        value = entry.get("value_metadata", {}).get("value_type")
        if kinds - {2} or value not in ("np.ndarray", "jax.Array"):
            raise ValueError(f"{path}: leaf {'.'.join(map(str, keys))} is not an array "
                             f"under dict keys ({value}, key types {sorted(kinds)})")
        kvstore = {"driver": "ocdbt", "base": f"file://{path}/", "path": ".".join(keys)}
        opened[tuple(keys)] = ts.open({"driver": "zarr", "kvstore": kvstore},
                                      open=True, read=True, context=ctx)
    tree: Dict[str, Any] = {}
    for keys, store in opened.items():
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.asarray(store.result().read().result())
    return tree


def _host_leaves(tree):
    """A converted tree with every leaf a numpy array: ``bfloat16`` leaves
    (torch tensors from ``flax_msgpack``, or tensorstore's own numpy type)
    widened to float32, which holds each of them exactly."""
    if isinstance(tree, dict):
        return {k: _host_leaves(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    if getattr(getattr(tree, "dtype", None), "name", "") == "bfloat16":
        return np.asarray(tree, np.float32)
    return tree


def load_params(path: str, convert: Callable, from_jax: Callable):
    """The port's state dict of the checkpoint at ``--weights_path``, in the
    JAX package's ``load_params`` order: an orbax directory or a
    ``.msgpack`` holds the JAX package's converted Flax tree (a
    ``{"params": ...}`` wrapper stripped), which ``from_jax`` turns into
    the port's state dict; anything else is a reference-layout state dict
    for ``convert``."""
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
