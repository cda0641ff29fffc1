"""Norm layers whose statistics stay fp32 whatever the activations' dtype.

Counterpart of the norm layers of ``video_features_tpu/models/common/
layers.py`` (``EvalBatchNorm``, RAFT's ``InstanceNorm``): under ``--dtype
bfloat16`` a bf16 activation is normalised in fp32 (BatchNorm's eval fold
``x * inv + (bias - mean * inv)``, InstanceNorm's per-sample mean and
variance) and returned in its incoming dtype, so the bf16 stream is not
widened. Each is a subclass of the torch layer with its ``state_dict``
keys, so no converter changes, and an fp32 input takes the torch layer's
own path: fp32 results are bit for bit those of ``nn.BatchNorm*d`` /
``nn.InstanceNorm2d``. The rest of that JAX module (XLA lowering
workarounds) has no counterpart here.
"""

from __future__ import annotations

import torch
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
