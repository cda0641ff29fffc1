"""R(2+1)D-18 (inference graph).

Counterpart of ``video_features_tpu/models/r21d/model.py``: torchvision's
``r2plus1d_18`` (VideoResNet). The stem is a 1x7x7/1,2,2 spatial conv to
45 channels + BN + ReLU and a 3x1x1 temporal conv to 64 + BN + ReLU;
four stages of 2 BasicBlocks follow, whose 3D convs are factorised into
a spatial 1x3x3 conv + BN + ReLU + temporal 3x1x1 conv (``Conv2Plus1D``)
with ``midplanes`` channels between, chosen to match the parameters of
the full 3x3x3 conv; then a global average pool and a 400-way fc.

NCTHW inside. Module names are torchvision's (``stem.{0,1,3,4}``,
``layer{s}.{b}.conv{k}.0.{0,1,3}``, ``layer{s}.{b}.conv{k}.1``,
``downsample.{0,1}``, ``fc``), so its state dicts load as they are. The
forward returns ``(features (N, 512), logits (N, 400))``; pool and head
run in fp32.

``--dtype bfloat16`` (``cast_for_compute`` with ``exclude=FP32_PARAMS``):
the convolutions and the residual stream in bf16 from the first conv on,
each BatchNorm's fold in fp32 (``models/common/layers.py``), the pool and
``fc`` in fp32.

Every convolution is a ``Conv3dCompat`` (``models/common/layers.py``):
``nn.Conv3d``'s parameters, with the extractor's ``--conv3d_impl``
lowering (``set_conv3d_impl``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from video_features_tpu_torch.models.common.layers import BatchNorm3d, Conv3dCompat

R21D_FEATURE_DIM = 512
# the parameters a bf16 network keeps fp32: the classifier head
FP32_PARAMS = ("fc",)


def midplanes(cin: int, cout: int) -> int:
    """The factorised conv's intermediate width: ``(in*out*3^3) //
    (in*3^2 + 3*out)``."""
    return (cin * cout * 3 * 3 * 3) // (cin * 3 * 3 + 3 * cout)


class Conv2Plus1D(nn.Sequential):
    """Spatial 1x3x3 -> BN -> ReLU -> temporal 3x1x1."""

    def __init__(self, cin: int, cout: int, mid: int, stride: int = 1) -> None:
        super().__init__(
            Conv3dCompat(cin, mid, (1, 3, 3), stride=(1, stride, stride), padding=(0, 1, 1),
                      bias=False),
            BatchNorm3d(mid),
            nn.ReLU(),
            Conv3dCompat(mid, cout, (3, 1, 1), stride=(stride, 1, 1), padding=(1, 0, 0),
                      bias=False),
        )


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1) -> None:
        super().__init__()
        # one midplane width from (cin, planes), for both factorised convs
        mid = midplanes(cin, planes)
        self.conv1 = nn.Sequential(Conv2Plus1D(cin, planes, mid, stride),
                                   BatchNorm3d(planes), nn.ReLU())
        self.conv2 = nn.Sequential(Conv2Plus1D(planes, planes, mid), BatchNorm3d(planes))
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(Conv3dCompat(cin, planes, 1, stride=stride, bias=False),
                                            BatchNorm3d(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class R2Plus1D(nn.Module):
    """(N, 3, T, H, W) normalized fp32 -> (features (N, 512), logits (N, classes))."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2), num_classes: int = 400) -> None:
        super().__init__()
        self.stem = nn.Sequential(
            Conv3dCompat(3, 45, (1, 7, 7), stride=(1, 2, 2), padding=(0, 3, 3), bias=False),
            BatchNorm3d(45),
            nn.ReLU(),
            Conv3dCompat(45, 64, (3, 1, 1), padding=(1, 0, 0), bias=False),
            BatchNorm3d(64),
            nn.ReLU(),
        )
        cin = 64
        for stage, n_blocks in enumerate(layers):
            planes = 64 * 2 ** stage
            blocks = []
            for b in range(n_blocks):
                blocks.append(BasicBlock(cin, planes, 2 if stage > 0 and b == 0 else 1))
                cin = planes
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.stem(x.to(self.stem[0].weight.dtype))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        feats = x.float().mean(dim=(2, 3, 4))
        return feats, self.fc(feats)


def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded LeCun-normal conv and fc weights, zero fc bias and identity
    BatchNorm (the JAX package's initialisers), from a generator of the
    model's own."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv3d, nn.Linear)):
                w = m.weight
                w.copy_(torch.randn(w.shape, generator=gen) * w[0].numel() ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm3d):
                m.reset_parameters()
    return model
