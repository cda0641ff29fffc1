"""PWC-Net optical flow (inference graph).

Counterpart of ``video_features_tpu/models/pwc/model.py``: a 6-level conv
pyramid, a coarse-to-fine cascade of decoders (levels 6 -> 2) built from
the 81-channel cost volume, a backward warp and dense conv stacks, and a
dilated-conv refiner. NCHW inside. Module names are those of the sniklaus
pytorch-pwc checkpoint (``moduleExtractor.moduleOne.0``,
``moduleTwo.moduleUpflow``, ``moduleRefiner.moduleMain.0``, ...), so a
``pwc_net_sintel.pt`` state dict loads as it is.

The public forward keeps the JAX contract: (T, H, W, 3) RGB floats in
[0, 255] -> (T-1, H, W, 2) flow of each consecutive pair, at input
resolution; a leading batch axis, (B, T, H, W, 3) -> (B, T-1, H, W, 2),
runs B independent sequences in one pass. The pyramid runs once over the
frames and the pairs are its views ``feat[:-1]`` / ``feat[1:]``. Each
cost volume goes through ``ops/correlation.py::local_correlation`` with
``corr_method`` ('auto': the CUDA kernel on the card; 'plain': the plain
version anywhere).

``--dtype bfloat16`` (``cast_for_compute`` with ``exclude=FP32_PARAMS``):
the extractor pyramid, the dense decoder convs, ``moduleUpfeat`` and the
refiner compute in bf16, while everything the coarse-to-fine cascade
steers by stays fp32: ``moduleUpflow`` and every flow estimate, the
backward warp and its mask, both cost volumes (the kernel gets fp32
inputs, as the JAX package's ``local_correlation`` does), and the final
resize and rescale. A decoder's input is assembled in fp32 and rounded
once into its dense stack. The flow is fp32 either way.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from video_features_tpu_torch.models.common.layers import device_vector
from video_features_tpu_torch.ops.correlation import local_correlation
from video_features_tpu_torch.ops.resize import resize_bilinear

_ORDINAL = ("One", "Two", "Thr", "Fou", "Fiv", "Six")
# per-level feature channels of the extractor pyramid (levels 1..6)
LEVEL_DIMS = (16, 32, 64, 96, 128, 196)
# flow magnitude scale of the upsampled flow fed into the warp, per level
BACKWARD_SCALE = {5: 0.625, 4: 1.25, 3: 2.5, 2: 5.0}
# correlation(81) + first-image features + upsampled flow(2) + feat(2)
DECODER_IN = {6: 81, 5: 81 + 128 + 4, 4: 81 + 96 + 4, 3: 81 + 64 + 4, 2: 81 + 32 + 4}
DENSE = (128, 128, 96, 64, 32)
REFINER = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1))
# the parameters a bf16 network keeps fp32: the flow upsampling deconvs
FP32_PARAMS = ("moduleUpflow",)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


def _conv(cin: int, cout: int, stride: int = 1, dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=dilation, dilation=dilation)


def backward_warp(feat: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp ``feat`` (N, C, H, W) by ``flow`` (N, 2, H, W as x, y pixels),
    zeroing samples whose bilinear support leaves the image: a ones
    channel is warped beside the features and kept where it is > 0.999."""
    N, _, H, W = feat.shape
    gx = torch.linspace(-1.0, 1.0, W, dtype=flow.dtype, device=flow.device)
    gy = torch.linspace(-1.0, 1.0, H, dtype=flow.dtype, device=flow.device)
    base = torch.stack(torch.meshgrid(gx, gy, indexing="xy"), dim=-1)  # (H, W, 2)
    norm = device_vector([(W - 1.0) / 2.0, (H - 1.0) / 2.0], flow)
    grid = base + flow.permute(0, 2, 3, 1) / norm
    inp = torch.cat([feat, feat.new_ones((N, 1, H, W))], dim=1)
    out = F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    mask = (out[:, -1:] > 0.999).to(feat.dtype)
    return out[:, :-1] * mask


class Extractor(nn.Module):
    """6-level strided conv pyramid; each level a Sequential of three
    (conv, leaky ReLU) pairs, the first with stride 2."""

    def __init__(self) -> None:
        super().__init__()
        cin = 3
        for name, dim in zip(_ORDINAL, LEVEL_DIMS):
            self.add_module(f"module{name}", nn.Sequential(
                _conv(cin, dim, 2), nn.LeakyReLU(0.1),
                _conv(dim, dim), nn.LeakyReLU(0.1),
                _conv(dim, dim), nn.LeakyReLU(0.1),
            ))
            cin = dim

    def forward(self, x: torch.Tensor):
        x = x.to(self.moduleOne[0].weight.dtype)
        feats = []
        for name in _ORDINAL:
            x = getattr(self, f"module{name}")(x)
            feats.append(x)
        return feats


class Decoder(nn.Module):
    """One pyramid level: correlation (after the warp below level 6) ->
    dense conv stack, each conv's output placed before its input ->
    2-channel flow. Returns the fp32 flow and the dense features in the
    convs' dtype."""

    def __init__(self, level: int) -> None:
        super().__init__()
        self.level = level
        cin = DECODER_IN[level]
        if level < 6:
            prev = DECODER_IN[level + 1] + sum(DENSE)
            self.moduleUpflow = nn.ConvTranspose2d(2, 2, 4, 2, 1)
            self.moduleUpfeat = nn.ConvTranspose2d(prev, 2, 4, 2, 1)
        for i, ch in enumerate(DENSE):
            self.add_module(f"module{_ORDINAL[i]}", nn.Sequential(_conv(cin, ch), nn.LeakyReLU(0.1)))
            cin += ch
        self.moduleSix = nn.Sequential(_conv(cin, 2))

    def forward(self, feat1, feat2, prev: Optional[Tuple[torch.Tensor, torch.Tensor]],
                corr_method: str):
        if prev is None:
            feat = _lrelu(local_correlation(feat1.float(), feat2.float(), method=corr_method))
        else:
            flow_up = self.moduleUpflow(prev[0])
            feat_up = self.moduleUpfeat(prev[1])
            warped = backward_warp(feat2.float(), flow_up * BACKWARD_SCALE[self.level])
            volume = _lrelu(local_correlation(feat1.float(), warped, method=corr_method))
            feat = torch.cat([volume, feat1.float(), flow_up, feat_up.float()], dim=1)
        feat = feat.to(self.moduleOne[0].weight.dtype)  # one cast into the dense stack
        for name in _ORDINAL[:5]:
            feat = torch.cat([getattr(self, f"module{name}")(feat), feat], dim=1)
        return self.moduleSix(feat).float(), feat


class Refiner(nn.Module):
    """Dilated-conv context network whose output is added to the level-2
    flow."""

    def __init__(self) -> None:
        super().__init__()
        layers, cin = [], DECODER_IN[2] + sum(DENSE)
        for ch, dil in REFINER:
            layers += [_conv(cin, ch, dilation=dil), nn.LeakyReLU(0.1)]
            cin = ch
        layers.append(_conv(cin, 2))
        self.moduleMain = nn.Sequential(*layers)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        return self.moduleMain(feat).float()


def internal_grid(h: int, w: int, div: int = 64) -> Tuple[int, int]:
    """The (Hp, Wp) multiple of ``div`` PWC stretches its input to: an
    aspect-breaking bilinear stretch, not a pad."""
    return int(math.ceil(h / div) * div), int(math.ceil(w / div) * div)


class PWCNet(nn.Module):
    """(T, H, W, 3) or (B, T, H, W, 3) RGB floats in [0, 255] ->
    (T-1, H, W, 2) or (B, T-1, H, W, 2) flow, fp32."""

    def __init__(self, corr_method: str = "auto") -> None:
        super().__init__()
        self.corr_method = corr_method
        self.moduleExtractor = Extractor()
        for level in (2, 3, 4, 5, 6):
            self.add_module(f"module{_ORDINAL[level - 1]}", Decoder(level))
        self.moduleRefiner = Refiner()

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        batched = frames.dim() == 5
        if not batched:
            frames = frames[None]
        B, T, H, W, _ = frames.shape
        Hp, Wp = internal_grid(H, W)
        # RGB -> BGR, [0, 1], NCHW, stretched to the /64 grid
        x = (frames.flip(-1) / 255.0).permute(0, 1, 4, 2, 3).reshape(B * T, 3, H, W)
        pyramid = self.moduleExtractor(resize_bilinear(x, (Hp, Wp)))

        prev = None
        for level in (6, 5, 4, 3, 2):
            f = pyramid[level - 1]
            f = f.reshape(B, T, *f.shape[1:])
            prev = getattr(self, f"module{_ORDINAL[level - 1]}")(
                f[:, :-1].reshape(B * (T - 1), *f.shape[2:]),
                f[:, 1:].reshape(B * (T - 1), *f.shape[2:]),
                prev, self.corr_method,
            )
        flow, feat = prev
        flow = resize_bilinear(flow + self.moduleRefiner(feat), (H, W))
        scale = device_vector([W / Wp, H / Hp], flow)
        flow = 20.0 * flow.permute(0, 2, 3, 1) * scale
        flow = flow.reshape(B, T - 1, H, W, 2)
        return flow if batched else flow[0]


def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded LeCun-normal weights and zero biases (the JAX package's
    initialisers), from a generator of the model's own."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                fan_in = w.shape[1 if isinstance(m, nn.Conv2d) else 0] * w[0, 0].numel()
                w.copy_(torch.randn(w.shape, generator=gen) * fan_in ** -0.5)
                m.bias.zero_()
    return model
