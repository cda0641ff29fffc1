"""Checkpoints into the port's I3D.

Counterpart of ``video_features_tpu/models/i3d/convert.py``. The port's
module names are the reference's, so:

- ``convert_state_dict``: ``i3d_rgb.pt`` / ``i3d_flow.pt`` load as they
  are, once a DataParallel ``module.`` prefix is stripped; every tensor
  must be consumed (BatchNorm's ``num_batches_tracked`` may be absent).
- ``params_from_jax``: the JAX package's Flax param tree (numpy leaves),
  the inverse of its ``convert_state_dict``: conv kernels (kT, kH, kW, I,
  O) -> (O, I, kT, kH, kW), ``batch3d`` scale/bias/mean/var -> BatchNorm
  weight/bias/running_mean/running_var;
- ``params_to_jax``: the port's state dict -> that Flax tree, what the
  JAX package's ``convert_state_dict`` gives for the same reference
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
    to_numpy,
)
from video_features_tpu_torch.models.i3d.model import I3D

StateDict = Dict[str, torch.Tensor]

_MIXED = (
    "mixed_3b", "mixed_3c",
    "mixed_4b", "mixed_4c", "mixed_4d", "mixed_4e", "mixed_4f",
    "mixed_5b", "mixed_5c",
)
_STEM = ("conv3d_1a_7x7", "conv3d_2b_1x1", "conv3d_2c_3x3")
# flax branch name -> torch branch prefix
_BRANCHES = {
    "branch_0": "branch_0",
    "branch_1_0": "branch_1.0",
    "branch_1_1": "branch_1.1",
    "branch_2_0": "branch_2.0",
    "branch_2_1": "branch_2.1",
    "branch_3_1": "branch_3.1",
}
_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def expected_keys(in_channels: int = 3):
    return [k for k in I3D(in_channels).state_dict() if not k.endswith("num_batches_tracked")]


def convert_state_dict(sd: Dict[str, np.ndarray]) -> StateDict:
    """A reference I3D state dict (rgb or flow) -> the port's."""
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    stem = "conv3d_1a_7x7.conv3d.weight"
    if stem not in sd:
        raise ValueError(f"I3D checkpoint lacks {stem}")
    keys = expected_keys(int(np.shape(sd[stem])[1]))
    missing = [k for k in keys if k not in sd]
    if missing:
        raise ValueError(f"I3D checkpoint lacks {len(missing)} tensors, e.g. {missing[:5]}")
    check_all_consumed(sd, keys, "I3D")
    return {k: torch.tensor(np.ascontiguousarray(sd[k], np.float32)) for k in keys}


def params_from_jax(params) -> StateDict:
    """The JAX package's I3D param tree -> the port's state dict."""
    out: Dict[str, np.ndarray] = {}

    def unit(prefix, p):
        out[f"{prefix}.conv3d.weight"] = np.transpose(np.asarray(p["conv3d"]["kernel"]),
                                                     (4, 3, 0, 1, 2))
        if "bias" in p["conv3d"]:
            out[f"{prefix}.conv3d.bias"] = np.asarray(p["conv3d"]["bias"])
        for jax_name, torch_name in _BN.items() if "batch3d" in p else ():
            out[f"{prefix}.batch3d.{torch_name}"] = np.asarray(p["batch3d"][jax_name])

    for name in _STEM:
        unit(name, params[name])
    for mixed in _MIXED:
        for flax_name, torch_name in _BRANCHES.items():
            unit(f"{mixed}.{torch_name}", params[mixed][flax_name])
    unit("conv3d_0c_1x1", params["conv3d_0c_1x1"])
    return convert_state_dict(out)


def params_to_jax(sd: StateDict) -> Dict:
    """The port's I3D state dict (rgb or flow) -> the JAX package's param
    tree."""
    def unit(prefix, bias=False):
        conv = {"kernel": conv_kernel(to_numpy(sd[f"{prefix}.conv3d.weight"]))}
        if bias:
            conv["bias"] = to_numpy(sd[f"{prefix}.conv3d.bias"])
        out = {"conv3d": conv}
        if f"{prefix}.batch3d.weight" in sd:
            out["batch3d"] = bn_to_jax(sd, f"{prefix}.batch3d")
        return out

    params = {name: unit(name) for name in _STEM}
    for mixed in _MIXED:
        params[mixed] = {flax_name: unit(f"{mixed}.{torch_name}")
                         for flax_name, torch_name in _BRANCHES.items()}
    params["conv3d_0c_1x1"] = unit("conv3d_0c_1x1", bias=True)
    return params
