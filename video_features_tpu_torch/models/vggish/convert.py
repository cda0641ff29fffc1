"""Checkpoints into the port's VGGish.

Counterpart of ``video_features_tpu/models/vggish/convert.py``. The
port's module names are torchvggish's, so:

- ``convert_state_dict``: ``vggish-10086976.pth`` loads as it is, once a
  DataParallel ``module.`` prefix is stripped; every tensor must be
  consumed;
- ``convert_pca_params``: the PCA file's ``pca_eigen_vectors`` (128, 128)
  and ``pca_means`` (128,), for :func:`model.postprocess`;
- ``params_from_jax``: the JAX package's Flax param tree (numpy leaves),
  the inverse of its ``convert_state_dict``: HWIO conv kernels -> OIHW,
  Dense kernels transposed.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from video_features_tpu_torch.models.common.weights import check_all_consumed
from video_features_tpu_torch.models.vggish.model import CONV_INDICES, EMBEDDING_INDICES

StateDict = Dict[str, torch.Tensor]


def expected_keys():
    return [f"features.{i}.{p}" for i in CONV_INDICES for p in ("weight", "bias")] + [
        f"embeddings.{i}.{p}" for i in EMBEDDING_INDICES for p in ("weight", "bias")
    ]


def convert_state_dict(sd: Dict[str, np.ndarray]) -> StateDict:
    """A torchvggish state dict -> the port's."""
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    keys = expected_keys()
    missing = [k for k in keys if k not in sd]
    if missing:
        raise ValueError(f"VGGish checkpoint lacks {len(missing)} tensors, e.g. {missing[:5]}")
    check_all_consumed(sd, keys, "VGGish")
    return {k: torch.tensor(np.ascontiguousarray(sd[k], np.float32)) for k in keys}


def convert_pca_params(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {
        "pca_eigen_vectors": torch.tensor(np.asarray(sd["pca_eigen_vectors"], np.float32)),
        "pca_means": torch.tensor(np.asarray(sd["pca_means"], np.float32).reshape(-1)),
    }


def params_from_jax(params) -> StateDict:
    """The JAX package's VGGish param tree -> the port's state dict."""
    out: Dict[str, np.ndarray] = {}
    for i in CONV_INDICES:
        p = params[f"features_{i}"]
        out[f"features.{i}.weight"] = np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))
        out[f"features.{i}.bias"] = np.asarray(p["bias"])
    for i in EMBEDDING_INDICES:
        p = params[f"embeddings_{i}"]
        out[f"embeddings.{i}.weight"] = np.asarray(p["kernel"]).T
        out[f"embeddings.{i}.bias"] = np.asarray(p["bias"])
    return convert_state_dict(out)
