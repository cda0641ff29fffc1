"""Checkpoints into the port's PWC-Net.

Counterpart of ``video_features_tpu/models/pwc/convert.py``. The port's
module names are the sniklaus checkpoint's, so:

- ``convert_state_dict``: a ``pwc_net_sintel.pt`` state dict loads as it
  is, once a DataParallel ``module.`` prefix is stripped; every tensor
  must be consumed.
- ``params_from_jax``: the JAX package's Flax param tree (numpy leaves),
  the inverse of its ``convert_state_dict``. The transpose convolutions
  are stored there pre-flipped as HWIO kernels and are turned back into
  ConvTranspose2d's (I, O, kH, kW);
- ``params_to_jax``: the port's state dict -> that Flax tree, what the
  JAX package's ``convert_state_dict`` gives for the same sniklaus
  checkpoint. Layout only: the transpose convolutions' kernels are
  flipped in both spatial axes, which moves values and changes none.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from video_features_tpu_torch.models.common.weights import (
    check_all_consumed,
    conv_kernel,
    to_numpy,
)
from video_features_tpu_torch.models.pwc.model import PWCNet, _ORDINAL

StateDict = Dict[str, torch.Tensor]


def expected_keys():
    return list(PWCNet().state_dict())


def convert_state_dict(sd: Dict[str, np.ndarray]) -> StateDict:
    """A sniklaus PWC-Net state dict -> the port's."""
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    keys = expected_keys()
    missing = [k for k in keys if k not in sd]
    if missing:
        raise ValueError(f"PWCNet checkpoint lacks {len(missing)} tensors, e.g. {missing[:5]}")
    check_all_consumed(sd, keys, "PWCNet")
    return {k: torch.tensor(np.ascontiguousarray(sd[k], np.float32)) for k in keys}


def params_from_jax(params) -> StateDict:
    """The JAX package's PWC param tree -> the port's state dict."""
    out: Dict[str, np.ndarray] = {}

    def conv(name, p):
        out[f"{name}.weight"] = np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))
        out[f"{name}.bias"] = np.asarray(p["bias"])

    def conv_transpose(name, p):
        out[f"{name}.weight"] = np.asarray(p["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1)
        out[f"{name}.bias"] = np.asarray(p["bias"])

    for lvl in range(1, 7):
        for i, idx in enumerate((0, 2, 4)):
            conv(f"moduleExtractor.module{_ORDINAL[lvl - 1]}.{idx}",
                 params["extractor"][f"lvl{lvl}_conv{i}"])
    for lvl in range(2, 7):
        dec, blk = f"module{_ORDINAL[lvl - 1]}", params[f"decoder{lvl}"]
        if lvl < 6:
            conv_transpose(f"{dec}.moduleUpflow", blk["upflow"])
            conv_transpose(f"{dec}.moduleUpfeat", blk["upfeat"])
        for i in range(5):
            conv(f"{dec}.module{_ORDINAL[i]}.0", blk[f"conv{i}"])
        conv(f"{dec}.moduleSix.0", blk["flow"])
    for i, idx in enumerate((0, 2, 4, 6, 8, 10, 12)):
        conv(f"moduleRefiner.moduleMain.{idx}", params["refiner"][f"conv{i}"])
    return convert_state_dict(out)


def params_to_jax(sd: StateDict) -> Dict:
    """The port's PWC state dict -> the JAX package's param tree."""
    def conv(name):
        return {"kernel": conv_kernel(to_numpy(sd[f"{name}.weight"])),
                "bias": to_numpy(sd[f"{name}.bias"])}

    def conv_transpose(name):  # (I, O, kH, kW) -> the flipped HWIO kernel
        w = np.transpose(to_numpy(sd[f"{name}.weight"]), (2, 3, 0, 1))[::-1, ::-1]
        return {"kernel": np.ascontiguousarray(w), "bias": to_numpy(sd[f"{name}.bias"])}

    extractor = {}
    for lvl in range(1, 7):
        for i, idx in enumerate((0, 2, 4)):
            extractor[f"lvl{lvl}_conv{i}"] = conv(
                f"moduleExtractor.module{_ORDINAL[lvl - 1]}.{idx}")
    params = {"extractor": extractor}
    for lvl in range(2, 7):
        dec, blk = f"module{_ORDINAL[lvl - 1]}", {}
        if lvl < 6:
            blk["upflow"] = conv_transpose(f"{dec}.moduleUpflow")
            blk["upfeat"] = conv_transpose(f"{dec}.moduleUpfeat")
        for i in range(5):
            blk[f"conv{i}"] = conv(f"{dec}.module{_ORDINAL[i]}.0")
        blk["flow"] = conv(f"{dec}.moduleSix.0")
        params[f"decoder{lvl}"] = blk
    params["refiner"] = {f"conv{i}": conv(f"moduleRefiner.moduleMain.{idx}")
                         for i, idx in enumerate((0, 2, 4, 6, 8, 10, 12))}
    return params
