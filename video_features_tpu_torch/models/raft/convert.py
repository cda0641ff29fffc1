"""Checkpoints into the port's RAFT.

Counterpart of ``video_features_tpu/models/raft/convert.py``. The port's
module names are princeton-vl's, so:

- ``convert_state_dict``: ``raft-sintel.pth`` loads as it is once the
  DataParallel ``module.`` prefix is stripped. The source module
  registers each BatchNorm downsample norm twice, as ``downsample.1`` and
  as ``norm3``, so a state dict taken from the live model carries
  ``norm3`` alias keys: they are consumed. Every other tensor must be
  too. The fnet's InstanceNorms carry no parameters.
- ``params_from_jax``: the JAX package's Flax param tree (numpy leaves),
  the inverse of its ``convert_state_dict``: HWIO kernels -> OIHW,
  ``layer1_0`` -> ``layer1.0``, ``norm3`` -> ``downsample.1``,
  ``mask_0``/``mask_2`` -> ``mask.0``/``mask.2``. The scan's
  ``update_block`` holds the one set of parameters all 20 iterations
  share;
- ``params_to_jax``: the port's state dict -> that Flax tree, what the
  JAX package's ``convert_state_dict`` gives for the same princeton-vl
  checkpoint (layout only; the fnet has no norm parameters).
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from video_features_tpu_torch.models.common.weights import (
    bn_to_jax,
    check_all_consumed,
    conv_kernel,
    to_numpy,
)
from video_features_tpu_torch.models.raft.model import RAFT

StateDict = Dict[str, torch.Tensor]

_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_NORM3 = re.compile(r"\.layer\d\.\d\.norm3\.")


def expected_keys():
    return [k for k in RAFT().state_dict() if not k.endswith("num_batches_tracked")]


def convert_state_dict(sd: Dict[str, np.ndarray]) -> StateDict:
    """A princeton-vl RAFT state dict -> the port's."""
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    keys = expected_keys()
    missing = [k for k in keys if k not in sd]
    if missing:
        raise ValueError(f"RAFT checkpoint lacks {len(missing)} tensors, e.g. {missing[:5]}")
    aliases = [k for k in sd if _NORM3.search(k)]
    check_all_consumed(sd, keys + aliases, "RAFT")
    return {k: torch.tensor(np.ascontiguousarray(sd[k], np.float32)) for k in keys}


def params_from_jax(params) -> StateDict:
    """The JAX package's RAFT param tree -> the port's state dict."""
    out: Dict[str, np.ndarray] = {}

    def conv(name, p):
        out[f"{name}.weight"] = np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))
        out[f"{name}.bias"] = np.asarray(p["bias"])

    def bn(name, p):
        for jax_name, torch_name in _BN.items():
            out[f"{name}.{torch_name}"] = np.asarray(p[jax_name])

    for enc in ("fnet", "cnet"):
        tree = params[enc]
        conv(f"{enc}.conv1", tree["conv1"])
        conv(f"{enc}.conv2", tree["conv2"])
        if "norm1" in tree:
            bn(f"{enc}.norm1", tree["norm1"])
        for layer in (1, 2, 3):
            for b in (0, 1):
                blk, ref = tree[f"layer{layer}_{b}"], f"{enc}.layer{layer}.{b}"
                conv(f"{ref}.conv1", blk["conv1"])
                conv(f"{ref}.conv2", blk["conv2"])
                for norm in ("norm1", "norm2"):
                    if norm in blk:
                        bn(f"{ref}.{norm}", blk[norm])
                if "downsample" in blk:
                    conv(f"{ref}.downsample.0", blk["downsample"])
                if "norm3" in blk:
                    bn(f"{ref}.downsample.1", blk["norm3"])
    upd = params["update_block"]
    for group in ("encoder", "gru", "flow_head"):
        for name, p in upd[group].items():
            conv(f"update_block.{group}.{name}", p)
    conv("update_block.mask.0", upd["mask_0"])
    conv("update_block.mask.2", upd["mask_2"])
    return convert_state_dict(out)


def params_to_jax(sd: StateDict) -> Dict:
    """The port's RAFT state dict -> the JAX package's param tree."""
    def conv(name):
        return {"kernel": conv_kernel(to_numpy(sd[f"{name}.weight"])),
                "bias": to_numpy(sd[f"{name}.bias"])}

    def encoder(enc, batch_norm):
        params = {"conv1": conv(f"{enc}.conv1"), "conv2": conv(f"{enc}.conv2")}
        if batch_norm:
            params["norm1"] = bn_to_jax(sd, f"{enc}.norm1")
        for layer in (1, 2, 3):
            for b in (0, 1):
                ref = f"{enc}.layer{layer}.{b}"
                blk = {"conv1": conv(f"{ref}.conv1"), "conv2": conv(f"{ref}.conv2")}
                if batch_norm:
                    blk["norm1"] = bn_to_jax(sd, f"{ref}.norm1")
                    blk["norm2"] = bn_to_jax(sd, f"{ref}.norm2")
                if f"{ref}.downsample.0.weight" in sd:
                    blk["downsample"] = conv(f"{ref}.downsample.0")
                    if batch_norm:
                        blk["norm3"] = bn_to_jax(sd, f"{ref}.downsample.1")
                params[f"layer{layer}_{b}"] = blk
        return params

    update = {
        "encoder": {name: conv(f"update_block.encoder.{name}")
                    for name in ("convc1", "convc2", "convf1", "convf2", "conv")},
        "gru": {name: conv(f"update_block.gru.{name}")
                for name in ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2")},
        "flow_head": {name: conv(f"update_block.flow_head.{name}") for name in ("conv1", "conv2")},
        "mask_0": conv("update_block.mask.0"),
        "mask_2": conv("update_block.mask.2"),
    }
    return {"fnet": encoder("fnet", False), "cnet": encoder("cnet", True), "update_block": update}
