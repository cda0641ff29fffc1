"""Layers shared across model families: norms whose statistics stay fp32
whatever the activations' dtype, and the 3D convolution of ``--conv3d_impl``.

Counterpart of ``video_features_tpu/models/common/layers.py``.

The norms (``EvalBatchNorm``, RAFT's ``InstanceNorm``): under ``--dtype
bfloat16`` a bf16 activation is normalised in fp32 (BatchNorm's eval fold
``x * inv + (bias - mean * inv)``, InstanceNorm's per-sample mean and
variance) and returned in its incoming dtype, so the bf16 stream is not
widened. Each is a subclass of the torch layer with its ``state_dict``
keys, so no converter changes, and an fp32 input takes the torch layer's
own path: fp32 results are bit for bit those of ``nn.BatchNorm*d`` /
``nn.InstanceNorm2d``.

:class:`Conv3dCompat` (``Conv3DCompat``) is ``nn.Conv3d`` with the JAX
package's choice of lowering: ``direct`` is cuDNN's conv3d, ``decomposed``
the sum of 2D convolutions over strided time slices. The JAX package keeps
``decomposed`` as a way round a TPU compiler's 3D convolution; the port
does what it does, so I3D and R(2+1)D take the flag. The rest of that JAX
module (XLA lowering workarounds) has no counterpart here.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class _Fp32Stats:
    """Mixin: the norm in fp32 on ``x.float()``, the result in ``x``'s
    dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(x.dtype)


class BatchNorm2d(_Fp32Stats, nn.BatchNorm2d):
    pass


class BatchNorm3d(_Fp32Stats, nn.BatchNorm3d):
    pass


class InstanceNorm2d(_Fp32Stats, nn.InstanceNorm2d):
    pass


def device_vector(values, like: torch.Tensor) -> torch.Tensor:
    """A (len(values),) tensor of Python floats in ``like``'s dtype on its
    device, filled there. ``torch.tensor(values, device=...)`` copies from
    pageable memory, and PyTorch waits for the device's queue to drain
    before it returns (GC104): inside a forward that is a stall per call.
    Each value is rounded to the dtype as ``torch.tensor`` rounds it."""
    return torch.stack([like.new_full((), float(v)) for v in values])


def conv3d_impl() -> str:
    """The process-wide default lowering of :class:`Conv3dCompat`:
    ``VFT_CONV3D_IMPL`` (``direct`` or ``decomposed``), else ``direct``."""
    impl = os.environ.get("VFT_CONV3D_IMPL", "direct")
    if impl not in ("direct", "decomposed"):
        raise ValueError(f"VFT_CONV3D_IMPL must be direct|decomposed, got {impl!r}")
    return impl


def explicit_conv3d_impl(config) -> Optional[str]:
    """An extractor's ``--conv3d_impl``: an explicit ``direct`` or
    ``decomposed`` for THAT extractor's convolutions, or None for
    ``auto`` (:func:`conv3d_impl` at each call)."""
    impl = getattr(config, "conv3d_impl", "auto")
    return None if impl in (None, "auto") else impl


class Conv3dCompat(nn.Conv3d):
    """``nn.Conv3d`` (the same parameters, ``state_dict`` keys and
    initialisation) with a choice of lowering, ``impl``: None reads
    :func:`conv3d_impl` at each call; ``direct`` is ``nn.Conv3d``'s own
    forward; ``decomposed`` computes ``conv3d(x, w) == sum_i
    conv2d(x[:, :, i::st_t], w[:, :, i])`` after explicit time padding,
    kt 2D convolutions of the (B * T_out) time slices. Zero padding, no
    dilation, one group."""

    impl: Optional[str] = None

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        if (self.groups != 1 or any(d != 1 for d in self.dilation)
                or self.padding_mode != "zeros" or isinstance(self.padding, str)):
            raise ValueError("Conv3dCompat takes zero padding, no dilation and one group")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (self.impl or conv3d_impl()) == "direct":
            return super().forward(x)
        kt, st, pt = self.kernel_size[0], self.stride[0], self.padding[0]
        if pt:
            x = F.pad(x, (0, 0, 0, 0, pt, pt))
        b, c, t = x.shape[:3]
        t_out = (t - kt) // st + 1
        out = None
        for i in range(kt):
            xi = x[:, :, i : i + (t_out - 1) * st + 1 : st].transpose(1, 2)
            oi = F.conv2d(xi.reshape(b * t_out, c, *xi.shape[3:]), self.weight[:, :, i],
                          None, self.stride[1:], self.padding[1:])
            out = oi if out is None else out + oi
        out = out.reshape(b, t_out, *out.shape[1:]).transpose(1, 2)
        if self.bias is not None:
            out = out + self.bias.view(1, -1, 1, 1, 1)
        return out


def set_conv3d_impl(model: nn.Module, impl: Optional[str]) -> nn.Module:
    """Thread one extractor's ``explicit_conv3d_impl`` into every
    :class:`Conv3dCompat` of its model, so it never leaks into another
    extractor's."""
    for m in model.modules():
        if isinstance(m, Conv3dCompat):
            m.impl = impl
    return model
