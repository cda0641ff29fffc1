"""I3D (Inception-3D), the Kinetics-400 two-stream network (inference
graph).

Counterpart of ``video_features_tpu/models/i3d/model.py``. Every conv and
max pool pads TF-style SAME: ``pad_along = max(kernel - stride, 0)`` per
axis, the low side getting ``pad_along // 2`` (``tf_same_pads``), applied
with ``F.pad`` before a padding-0 ``conv3d``. Max pools zero-pad and run
in ceil mode, as the reference's ``MaxPool3dTFPadding`` does. BatchNorm
runs in eval mode with eps 1e-5. Module names are the reference's
(``conv3d_1a_7x7.conv3d.weight``, ``...batch3d.running_mean``,
``mixed_4b.branch_1.0...``), so ``i3d_rgb.pt`` and ``i3d_flow.pt`` load
as they are.

The public forward keeps the JAX contract: (B, T, H, W, C) in [-1, 1]
(C = 3 for rgb, 2 for flow) -> (features (B, 1024), logits (B, 400)).
NCDHW inside.

``--dtype bfloat16`` (``cast_for_compute`` with ``exclude=FP32_PARAMS``):
the convolutions, max pools and branch concatenations in bf16, each
BatchNorm's fold in fp32 (``models/common/layers.py``); the average pool,
the time mean and the logits head in fp32 (torch has no bf16
``avg_pool3d`` on the CPU, and the features are the contract).

Every convolution is a ``Conv3dCompat`` (``models/common/layers.py``):
``nn.Conv3d``'s parameters, with the extractor's ``--conv3d_impl``
lowering (``set_conv3d_impl``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from video_features_tpu_torch.models.common.layers import BatchNorm3d, Conv3dCompat

I3D_FEATURE_DIM = 1024
I3D_NUM_CLASSES = 400
IN_CHANNELS = {"rgb": 3, "flow": 2}
# the parameters a bf16 network keeps fp32: the logits head
FP32_PARAMS = ("conv3d_0c_1x1",)


def tf_same_pads(kernel: Sequence[int], stride: Sequence[int]) -> List[Tuple[int, int]]:
    """(lo, hi) per axis: ``pad_along = max(k - s, 0)``, the smaller half
    first."""
    pads = []
    for k, s in zip(kernel, stride):
        along = max(k - s, 0)
        pads.append((along // 2, along - along // 2))
    return pads


def _f_pad(kernel, stride) -> Tuple[int, ...]:
    """``tf_same_pads`` in ``F.pad``'s order: the last axis first."""
    return tuple(p for lo_hi in reversed(tf_same_pads(kernel, stride)) for p in lo_hi)


def max_pool_tf(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    """TF-SAME zero-padded, ceil-mode 3D max pool of an NCDHW tensor."""
    return F.max_pool3d(F.pad(x, _f_pad(kernel, stride)), kernel, stride, ceil_mode=True)


class MaxPoolTF(nn.Module):
    def __init__(self, kernel, stride) -> None:
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_tf(x, self.kernel, self.stride)


class Unit3D(nn.Module):
    """Conv3d (TF SAME padding, ``Conv3dCompat``) + eval BatchNorm + ReLU."""

    def __init__(self, cin: int, cout: int, kernel=(1, 1, 1), stride=(1, 1, 1),
                 use_bn: bool = True, use_bias: bool = False, activation: bool = True) -> None:
        super().__init__()
        self.pads = _f_pad(kernel, stride)
        self.conv3d = Conv3dCompat(cin, cout, kernel, stride, bias=use_bias)
        self.batch3d = BatchNorm3d(cout, eps=1e-5) if use_bn else None
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv3d(F.pad(x, self.pads) if any(self.pads) else x)
        if self.batch3d is not None:
            x = self.batch3d(x)
        return F.relu(x) if self.activation else x


class Mixed(nn.Module):
    """Inception block: 1x1 / 1x1 -> 3x3 / 1x1 -> 3x3 / pool -> 1x1."""

    def __init__(self, cin: int, out: Sequence[int]) -> None:
        super().__init__()
        self.branch_0 = Unit3D(cin, out[0])
        self.branch_1 = nn.Sequential(Unit3D(cin, out[1]), Unit3D(out[1], out[2], (3, 3, 3)))
        self.branch_2 = nn.Sequential(Unit3D(cin, out[3]), Unit3D(out[3], out[4], (3, 3, 3)))
        self.branch_3 = nn.Sequential(MaxPoolTF((3, 3, 3), (1, 1, 1)), Unit3D(cin, out[5]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat(
            [self.branch_0(x), self.branch_1(x), self.branch_2(x), self.branch_3(x)], dim=1
        )


class I3D(nn.Module):
    """(B, T, H, W, C) in [-1, 1] -> (features (B, 1024), logits (B, 400))."""

    def __init__(self, in_channels: int = 3, num_classes: int = I3D_NUM_CLASSES) -> None:
        super().__init__()
        self.conv3d_1a_7x7 = Unit3D(in_channels, 64, (7, 7, 7), (2, 2, 2))
        self.maxPool3d_2a_3x3 = MaxPoolTF((1, 3, 3), (1, 2, 2))
        self.conv3d_2b_1x1 = Unit3D(64, 64)
        self.conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        self.maxPool3d_3a_3x3 = MaxPoolTF((1, 3, 3), (1, 2, 2))
        self.mixed_3b = Mixed(192, [64, 96, 128, 16, 32, 32])
        self.mixed_3c = Mixed(256, [128, 128, 192, 32, 96, 64])
        self.maxPool3d_4a_3x3 = MaxPoolTF((3, 3, 3), (2, 2, 2))
        self.mixed_4b = Mixed(480, [192, 96, 208, 16, 48, 64])
        self.mixed_4c = Mixed(512, [160, 112, 224, 24, 64, 64])
        self.mixed_4d = Mixed(512, [128, 128, 256, 24, 64, 64])
        self.mixed_4e = Mixed(512, [112, 144, 288, 32, 64, 64])
        self.mixed_4f = Mixed(528, [256, 160, 320, 32, 128, 128])
        self.maxPool3d_5a_2x2 = MaxPoolTF((2, 2, 2), (2, 2, 2))
        self.mixed_5b = Mixed(832, [256, 160, 320, 32, 128, 128])
        self.mixed_5c = Mixed(832, [384, 192, 384, 48, 128, 128])
        self.conv3d_0c_1x1 = Unit3D(
            I3D_FEATURE_DIM, num_classes, use_bn=False, use_bias=True, activation=False
        )

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.permute(0, 4, 1, 2, 3).contiguous().to(self.conv3d_1a_7x7.conv3d.weight.dtype)
        for name, layer in self.named_children():  # in the order defined above
            if name == "conv3d_0c_1x1":
                break
            x = layer(x)
        # AvgPool3d((2, 7, 7), stride 1), then the time (and space) mean
        x = F.avg_pool3d(x.float(), (2, 7, 7), stride=1)
        feats = x.mean(dim=(2, 3, 4))
        logits = self.conv3d_0c_1x1(x).mean(dim=(2, 3, 4))
        return feats, logits


def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded LeCun-normal conv weights, zero biases and identity
    BatchNorm (the JAX package's initialisers), from a generator of the
    model's own."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv3d):
                w = m.weight
                w.copy_(torch.randn(w.shape, generator=gen) * w[0].numel() ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm3d):
                m.reset_parameters()
    return model
