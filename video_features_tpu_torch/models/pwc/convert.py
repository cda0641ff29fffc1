"""Checkpoints into the port's PWC-Net.

Counterpart of ``video_features_tpu/models/pwc/convert.py``. The port's
module names are the sniklaus checkpoint's, so:

- ``convert_state_dict``: a ``pwc_net_sintel.pt`` state dict loads as it
  is, once a DataParallel ``module.`` prefix is stripped; every tensor
  must be consumed.
- ``params_from_jax``: the JAX package's Flax param tree (numpy leaves),
  the inverse of its ``convert_state_dict``. The transpose convolutions
  are stored there pre-flipped as HWIO kernels and are turned back into
  ConvTranspose2d's (I, O, kH, kW).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from video_features_tpu_torch.models.common.weights import check_all_consumed
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
