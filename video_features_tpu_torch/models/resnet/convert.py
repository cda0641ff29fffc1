"""Checkpoints into the port's ResNet.

Counterpart of ``video_features_tpu/models/resnet/convert.py``. The
port's module names are torchvision's, so:

- ``convert_state_dict``: a torchvision ``resnetXX`` state dict loads as
  it is, once a DataParallel ``module.`` prefix is stripped; every tensor
  must be consumed (BatchNorm's ``num_batches_tracked`` may be absent).
- ``params_from_jax``: the JAX package's Flax param tree (numpy leaves),
  the inverse of its ``convert_state_dict``: HWIO kernels -> OIHW,
  ``layer1_0`` -> ``layer1.0``, ``downsample_conv``/``downsample_bn`` ->
  ``downsample.0``/``downsample.1``, the fc kernel transposed;
- ``params_to_jax``: the port's state dict -> that Flax tree, what the
  JAX package's ``convert_state_dict`` gives for the same torchvision
  checkpoint (layout only).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from video_features_tpu_torch.models.common.weights import (
    bn_to_jax,
    check_all_consumed,
    conv_kernel,
    linear_kernel,
    to_numpy,
)
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


def params_to_jax(sd: StateDict) -> Dict:
    """The port's ResNet state dict -> the JAX package's param tree; the
    blocks and their convs are read off the state dict's keys, so one
    function serves every ``arch``."""
    params = {
        "conv1": {"kernel": conv_kernel(to_numpy(sd["conv1.weight"]))},
        "bn1": bn_to_jax(sd, "bn1"),
        "fc": {"kernel": linear_kernel(to_numpy(sd["fc.weight"])),
               "bias": to_numpy(sd["fc.bias"])},
    }
    stage = 1
    while f"layer{stage}.0.conv1.weight" in sd:
        b = 0
        while f"layer{stage}.{b}.conv1.weight" in sd:
            ref, blk, k = f"layer{stage}.{b}", {}, 1
            while f"{ref}.conv{k}.weight" in sd:
                blk[f"conv{k}"] = {"kernel": conv_kernel(to_numpy(sd[f"{ref}.conv{k}.weight"]))}
                blk[f"bn{k}"] = bn_to_jax(sd, f"{ref}.bn{k}")
                k += 1
            if f"{ref}.downsample.0.weight" in sd:
                blk["downsample_conv"] = {
                    "kernel": conv_kernel(to_numpy(sd[f"{ref}.downsample.0.weight"]))}
                blk["downsample_bn"] = bn_to_jax(sd, f"{ref}.downsample.1")
            params[f"layer{stage}_{b}"] = blk
            b += 1
        stage += 1
    return params
