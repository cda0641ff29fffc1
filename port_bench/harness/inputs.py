"""A run's inputs, made from its seed before set-up starts: the clips and
video names (``traffic/generator.py``) and every model's weights.

Weights are drawn on the device with one ``torch.Generator`` a model and
one ``randn`` call for all of its tensors, in the reference's layout (the
plain models of ``reference/``, built on the ``meta`` device and
materialised on the card), and written as the files ``--weights_path``
names. Convolution weights are LeCun-normal (std ``fan_in ** -0.5``), conv
biases N(0, 0.01^2), BatchNorm's scale ``1 + 0.1 z``, shift ``0.1 z``,
running mean ``0.1 z`` and running variance ``exp(0.2 z)``: a network
whose activations neither vanish nor blow up over its depth, with every
term of its norms in play. The configuration's ``output_scale`` then
scales the named modules' weights and biases: the flow nets' output
convolutions, so that their flow on the traffic's motion is a few pixels,
as a trained net's is (at LeCun scale RAFT moves tens of pixels and PWC a
tenth of one, and the flow stream's clamp and uint8 levels would see
nothing of the flow net).
"""

from __future__ import annotations

import os
from typing import Dict

import torch
import torch.nn as nn

from port_bench.reference.i3d import I3D
from port_bench.reference.pwc import PWCNet
from port_bench.reference.raft import RAFT
from port_bench.traffic.generator import WEIGHTS, sub_seeds

# a prefix some published checkpoints carry (RAFT's DataParallel one), kept
# so the program's loader meets the file as users have it
_PREFIX = {"raft": "module."}


def reference_models(config: dict, width_div: int = 1) -> Dict[str, nn.Module]:
    """The reference's modules of ``config``, on the ``meta`` device."""
    sizes, flow = config["sizes"], config["flow_type"]
    with torch.device("meta"):
        return {"rgb": I3D(3, sizes["i3d"], width_div), "flow": I3D(2, sizes["i3d"], width_div),
                flow: RAFT(sizes["raft"]) if flow == "raft" else PWCNet(sizes["pwc"])}


@torch.no_grad()
def fill(model: nn.Module, seed: int, device) -> nn.Module:
    """Materialise ``model`` on ``device`` with the module docstring's
    draws, from one generator and one ``randn``."""
    model = model.to_empty(device=device)
    tensors = []  # (tensor, rule), each distinct storage once
    seen = set()
    for m in model.modules():
        for name, t in list(m.named_parameters(recurse=False)) + list(m.named_buffers(recurse=False)):
            if not t.is_floating_point() or t.data_ptr() in seen:
                continue
            seen.add(t.data_ptr())
            tensors.append((t, m, name))
    total = sum(t.numel() for t, _, _ in tensors)
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    off = 0
    for t, m, name in tensors:
        piece = z[off:off + t.numel()].view_as(t)
        off += t.numel()
        if isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
            value = {"weight": 1 + 0.1 * piece, "bias": 0.1 * piece,
                     "running_mean": 0.1 * piece, "running_var": torch.exp(0.2 * piece)}[name]
        elif name == "bias":
            value = 0.01 * piece
        else:
            fan_in = (t.shape[0] if isinstance(m, nn.ConvTranspose2d) else t.shape[1]) * t[0, 0].numel()
            value = piece * fan_in ** -0.5
        t.copy_(value)
    for m in model.modules():
        if isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
            m.num_batches_tracked.zero_()
    return model.eval()


@torch.no_grad()
def scale_outputs(model: nn.Module, scale: Dict[str, float]) -> None:
    modules = dict(model.named_modules())
    for name, factor in scale.items():
        for p in modules[name].parameters():
            p.mul_(factor)


def make_weights(config: dict, seed: int, out_dir: str, device, width_div: int = 1) -> None:
    """Every model of ``config`` drawn on ``device`` and saved under
    ``out_dir`` as the file ``--weights_path`` names."""
    os.makedirs(out_dir, exist_ok=True)
    models = reference_models(config, width_div)
    for (kind, model), s in zip(sorted(models.items()), sub_seeds(seed, len(models), WEIGHTS)):
        model = fill(model, s, device)
        scale_outputs(model, config.get("output_scale", {}).get(kind, {}))
        sd = model.state_dict()
        prefix = _PREFIX.get(kind, "")
        sd = {prefix + k: v.cpu() for k, v in sd.items() if not k.endswith("num_batches_tracked")}
        torch.save(sd, os.path.join(out_dir, config["weight_files"][kind]))
