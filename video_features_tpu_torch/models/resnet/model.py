"""ResNet-18/34/50/101/152 (inference graph).

Counterpart of ``video_features_tpu/models/resnet/model.py``: torchvision's
ResNet v1 — 7x7/2 stem conv + BN + ReLU + 3x3/2 max pool, four stages of
BasicBlock (18/34) or Bottleneck (50+, expansion 4, stride on conv2),
global average pool, 1000-way fc. Module names are torchvision's
(``conv1``, ``bn1``, ``layer{1..4}.{b}.{conv,bn}{1,2[,3]}``,
``downsample.{0,1}``, ``fc``), so its state dicts load as they are. The
forward returns ``(features, logits)`` in one pass; pool and head run in
fp32.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=(kernel - 1) // 2, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: nn.Module = None) -> None:
        super().__init__()
        self.conv1 = _conv(cin, planes, 3, stride)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: nn.Module = None) -> None:
        super().__init__()
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


# feature_type -> (block, per-stage block counts), as torchvision's
ARCHS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
    "resnet101": (Bottleneck, (3, 4, 23, 3)),
    "resnet152": (Bottleneck, (3, 8, 36, 3)),
}


class ResNet(nn.Module):
    """(N, 3, H, W) normalized fp32 -> (features (N, 512*exp), logits (N, classes))."""

    def __init__(self, arch: str, num_classes: int = 1000) -> None:
        super().__init__()
        block, layers = ARCHS[arch]
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for stage, n_blocks in enumerate(layers):
            planes = 64 * 2 ** stage
            blocks = []
            for b in range(n_blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                downsample = None
                if stride != 1 or cin != planes * block.expansion:
                    downsample = nn.Sequential(_conv(cin, planes * block.expansion, 1, stride),
                                               nn.BatchNorm2d(planes * block.expansion))
                blocks.append(block(cin, planes, stride, downsample))
                cin = planes * block.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        feats = x.float().mean(dim=(2, 3))
        return feats, self.fc(feats)


def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded LeCun-normal conv and fc weights, zero fc bias and identity
    BatchNorm (the JAX package's initialisers), from a generator of the
    model's own."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                w = m.weight
                w.copy_(torch.randn(w.shape, generator=gen) * w[0].numel() ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model

