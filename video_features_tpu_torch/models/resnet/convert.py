"""Checkpoints into the port's ResNet.

Counterpart of ``video_features_tpu/models/resnet/convert.py``. The
port's module names are torchvision's, so:

- ``convert_state_dict``: a torchvision ``resnetXX`` state dict loads as
  it is, once a DataParallel ``module.`` prefix is stripped; every tensor
  must be consumed (BatchNorm's ``num_batches_tracked`` may be absent).
- ``params_from_jax``: the JAX package's Flax param tree (numpy leaves),
  the inverse of its ``convert_state_dict``: HWIO kernels -> OIHW,
  ``layer1_0`` -> ``layer1.0``, ``downsample_conv``/``downsample_bn`` ->
  ``downsample.0``/``downsample.1``, the fc kernel transposed.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from video_features_tpu_torch.models.common.weights import check_all_consumed
from video_features_tpu_torch.models.resnet.model import ResNet

StateDict = Dict[str, torch.Tensor]

_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
# flax submodule of a block -> torch prefix
_DOWNSAMPLE = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}


def expected_keys(arch: str):
    return [k for k in ResNet(arch).state_dict() if not k.endswith("num_batches_tracked")]


def convert_state_dict(sd: Dict[str, np.ndarray], arch: str) -> StateDict:
    """A torchvision ResNet state dict -> the port's."""
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    keys = expected_keys(arch)
    missing = [k for k in keys if k not in sd]
    if missing:
        raise ValueError(f"{arch} checkpoint lacks {len(missing)} tensors, e.g. {missing[:5]}")
    check_all_consumed(sd, keys, f"ResNet[{arch}]")
    return {k: torch.tensor(np.ascontiguousarray(sd[k], np.float32)) for k in keys}


def params_from_jax(params, arch: str) -> StateDict:
    """The JAX package's ResNet param tree -> the port's state dict."""
    out: Dict[str, np.ndarray] = {}

    def unit(name, p):
        if "kernel" in p:  # a conv
            out[f"{name}.weight"] = np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))
        else:
            for jax_name, torch_name in _BN.items():
                out[f"{name}.{torch_name}"] = np.asarray(p[jax_name])

    for name, p in params.items():
        if name == "fc":
            out["fc.weight"] = np.asarray(p["kernel"]).T
            out["fc.bias"] = np.asarray(p["bias"])
        elif name.startswith("layer"):
            prefix = name.replace("_", ".")
            for sub, q in p.items():
                unit(f"{prefix}.{_DOWNSAMPLE.get(sub, sub)}", q)
        else:
            unit(name, p)
    return convert_state_dict(out, arch)
