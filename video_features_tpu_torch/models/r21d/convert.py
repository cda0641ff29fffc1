"""Checkpoints into the port's R(2+1)D-18.

Counterpart of ``video_features_tpu/models/r21d/convert.py``. The port's
module names are torchvision's ``r2plus1d_18``, so:

- ``convert_state_dict``: its state dict loads as it is, once a
  DataParallel ``module.`` prefix is stripped; every tensor must be
  consumed (BatchNorm's ``num_batches_tracked`` may be absent).
- ``params_from_jax``: the JAX package's Flax param tree (numpy leaves),
  the inverse of its ``convert_state_dict``: (kT, kH, kW, I, O) kernels
  -> (O, I, kT, kH, kW); ``stem_conv1``/``stem_bn1``/``stem_conv2``/
  ``stem_bn2`` -> ``stem.{0,1,3,4}``; a block's ``conv{k}``
  (``spatial``, ``bn_mid``, ``temporal``) -> ``conv{k}.0.{0,1,3}`` and
  ``bn{k}`` -> ``conv{k}.1``; the fc kernel transposed;
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
from video_features_tpu_torch.models.r21d.model import R2Plus1D

StateDict = Dict[str, torch.Tensor]

_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_STEM = {"stem_conv1": "stem.0", "stem_bn1": "stem.1", "stem_conv2": "stem.3",
         "stem_bn2": "stem.4"}
_CONV2PLUS1D = {"spatial": "0", "bn_mid": "1", "temporal": "3"}
# flax submodule of a block -> torch prefix (besides conv{k})
_BLOCK = {"bn1": "conv1.1", "bn2": "conv2.1", "downsample_conv": "downsample.0",
          "downsample_bn": "downsample.1"}


def expected_keys():
    return [k for k in R2Plus1D().state_dict() if not k.endswith("num_batches_tracked")]


def convert_state_dict(sd: Dict[str, np.ndarray]) -> StateDict:
    """A torchvision r2plus1d_18 state dict -> the port's."""
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    keys = expected_keys()
    missing = [k for k in keys if k not in sd]
    if missing:
        raise ValueError(f"R(2+1)D checkpoint lacks {len(missing)} tensors, e.g. {missing[:5]}")
    check_all_consumed(sd, keys, "R2Plus1D")
    return {k: torch.tensor(np.ascontiguousarray(sd[k], np.float32)) for k in keys}


def params_from_jax(params) -> StateDict:
    """The JAX package's R(2+1)D param tree -> the port's state dict."""
    out: Dict[str, np.ndarray] = {}

    def unit(name, p):
        if "kernel" in p:  # a conv
            out[f"{name}.weight"] = np.transpose(np.asarray(p["kernel"]), (4, 3, 0, 1, 2))
        else:
            for jax_name, torch_name in _BN.items():
                out[f"{name}.{torch_name}"] = np.asarray(p[jax_name])

    for name, p in params.items():
        if name == "fc":
            out["fc.weight"] = np.asarray(p["kernel"]).T
            out["fc.bias"] = np.asarray(p["bias"])
        elif name in _STEM:
            unit(_STEM[name], p)
        else:
            prefix = name.replace("_", ".")
            for sub, q in p.items():
                if sub in _BLOCK:
                    unit(f"{prefix}.{_BLOCK[sub]}", q)
                else:  # conv1 / conv2: a Conv2Plus1D
                    for part, idx in _CONV2PLUS1D.items():
                        unit(f"{prefix}.{sub}.0.{idx}", q[part])
    return convert_state_dict(out)


def params_to_jax(sd: StateDict) -> Dict:
    """The port's R(2+1)D state dict -> the JAX package's param tree."""
    def conv(name):
        return {"kernel": conv_kernel(to_numpy(sd[f"{name}.weight"]))}

    def conv2plus1d(prefix):
        return {"spatial": conv(f"{prefix}.0"), "bn_mid": bn_to_jax(sd, f"{prefix}.1"),
                "temporal": conv(f"{prefix}.3")}

    params = {
        "stem_conv1": conv("stem.0"),
        "stem_bn1": bn_to_jax(sd, "stem.1"),
        "stem_conv2": conv("stem.3"),
        "stem_bn2": bn_to_jax(sd, "stem.4"),
        "fc": {"kernel": linear_kernel(to_numpy(sd["fc.weight"])),
               "bias": to_numpy(sd["fc.bias"])},
    }
    stage = 1
    while f"layer{stage}.0.conv1.0.0.weight" in sd:
        b = 0
        while f"layer{stage}.{b}.conv1.0.0.weight" in sd:
            ref = f"layer{stage}.{b}"
            blk = {"conv1": conv2plus1d(f"{ref}.conv1.0"), "bn1": bn_to_jax(sd, f"{ref}.conv1.1"),
                   "conv2": conv2plus1d(f"{ref}.conv2.0"), "bn2": bn_to_jax(sd, f"{ref}.conv2.1")}
            if f"{ref}.downsample.0.weight" in sd:
                blk["downsample_conv"] = conv(f"{ref}.downsample.0")
                blk["downsample_bn"] = bn_to_jax(sd, f"{ref}.downsample.1")
            params[f"layer{stage}_{b}"] = blk
            b += 1
        stage += 1
    return params
