"""VGGish (AudioSet VGG) in PyTorch, and the PCA/quantise postprocessor.

Counterpart of ``video_features_tpu/models/vggish/model.py``, with
torchvggish's module names, so ``vggish-10086976.pth`` loads as it is:
``features.{0,3,6,8,11,13}`` are 3x3 convolutions (padding 1, ReLU) with
a 2x2 max pool after 0, 3, 8 and 13, on (N, 1, 96, 64) log-mel examples;
``embeddings.{0,2,4}`` are 12288 -> 4096 -> 4096 -> 128 with a ReLU after
each, the last one too.

The flatten before ``embeddings.0`` reads the (N, 512, 6, 4) map in
(H, W, C) order, as torchvggish's transpose before its ``view`` does (and
as the JAX package's NHWC flatten does): a plain NCHW ``flatten(1)``
would permute all 12,288 inputs of the first Linear.

Both reference extractors emit the raw 128-d floats; :func:`postprocess`
gives the AudioSet-compatible 8-bit embeddings to library users.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

VGGISH_EMBEDDING_DIM = 128
QUANTIZE_MIN_VAL = -2.0
QUANTIZE_MAX_VAL = 2.0

# torchvggish's make_layers config: conv output channels, "M" a 2x2 max pool
LAYER_CONFIG = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M")
# the convs' indices in ``features``
CONV_INDICES = (0, 3, 6, 8, 11, 13)
EMBEDDING_INDICES = (0, 2, 4)


def _features() -> nn.Sequential:
    layers, in_ch = [], 1
    for v in LAYER_CONFIG:
        if v == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [nn.Conv2d(in_ch, v, 3, padding=1), nn.ReLU(inplace=True)]
            in_ch = v
    return nn.Sequential(*layers)


class VGGish(nn.Module):
    """(N, 1, 96, 64) log-mel examples -> (N, 128) embeddings."""

    def __init__(self) -> None:
        super().__init__()
        self.features = _features()
        self.embeddings = nn.Sequential(
            nn.Linear(512 * 6 * 4, 4096), nn.ReLU(inplace=True),
            nn.Linear(4096, 4096), nn.ReLU(inplace=True),
            nn.Linear(4096, VGGISH_EMBEDDING_DIM), nn.ReLU(inplace=True),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x)  # (N, 512, 6, 4)
        x = x.permute(0, 2, 3, 1).flatten(1)  # (H, W, C) order, as torchvggish
        return self.embeddings(x)


def postprocess(embeddings: torch.Tensor, pca: Dict[str, torch.Tensor]) -> torch.Tensor:
    """AudioSet PCA whitening and 8-bit quantisation: clip((x - means) @
    E^T, +-2) mapped to [0, 255], rounded half to even, as uint8."""
    centered = embeddings - pca["pca_means"].reshape(1, -1)
    applied = centered @ pca["pca_eigen_vectors"].T
    clipped = torch.clamp(applied, QUANTIZE_MIN_VAL, QUANTIZE_MAX_VAL)
    quantized = torch.round(
        (clipped - QUANTIZE_MIN_VAL) * (255.0 / (QUANTIZE_MAX_VAL - QUANTIZE_MIN_VAL))
    )
    return quantized.to(torch.uint8)


def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded LeCun-normal conv and Linear weights and zero biases, from a
    generator of the model's own."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                w = m.weight
                w.copy_(torch.randn(w.shape, generator=gen) * w[0].numel() ** -0.5)
                m.bias.zero_()
    return model
