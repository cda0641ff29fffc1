"""Plain PWC-Net (Sun et al., arXiv:1709.02371) in sniklaus/pytorch-pwc's
layout and names (``moduleExtractor.moduleOne.0``, ``moduleTwo.moduleUpflow``,
``moduleRefiner.moduleMain.0``, ...), the version v-iashin/video_features
runs: a 6-level feature pyramid, decoders from level 6 to level 2 built on
the 81-channel local cost volume of the first image's features against the
second's, warped backward by the upsampled flow, and a dilated-conv refiner.

The cost volume is sniklaus's CUDA kernel written as its equation: plane
``(dy + d) * (2d + 1) + (dx + d)`` is the mean over channels of
``f1[c, y, x] * f2[c, y + dy, x + dx]``, f2 zero outside its plane. The
backward warp is the one v-iashin ships run under a current torch: a
``linspace(-1, 1)`` base grid sampled with ``align_corners=False``, and
samples whose support leaves the image zeroed through a warped ones channel
kept where it exceeds 0.999.

``estimate`` takes (T, 3, H, W) RGB in [0, 255] and returns the (T-1, 2, H,
W) flow of each consecutive pair: BGR in [0, 1], a bilinear stretch to the
next multiple of 64, the network, a bilinear resize back, scaled by 20 and
by the stretch. Each frame is encoded once and the pairs are views of the
pyramid (sniklaus encodes both images of a pair): the same equations.
Plain torch.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

_ORDINAL = ("One", "Two", "Thr", "Fou", "Fiv", "Six")


def correlation(f1, f2, d):
    n, c, h, w = f1.shape
    f2p = F.pad(f2, (d, d, d, d))
    planes = []
    for dy in range(-d, d + 1):
        for dx in range(-d, d + 1):
            planes.append((f1 * f2p[:, :, d + dy:d + dy + h, d + dx:d + dx + w]).mean(1))
    return torch.stack(planes, 1)


def backward_warp(inp, flow):
    n, _, h, w = flow.shape
    hor = torch.linspace(-1.0, 1.0, w, device=flow.device).view(1, 1, 1, w).expand(n, -1, h, -1)
    ver = torch.linspace(-1.0, 1.0, h, device=flow.device).view(1, 1, h, 1).expand(n, -1, -1, w)
    grid = torch.cat([hor, ver], 1)
    flow = torch.cat([flow[:, 0:1] / ((inp.shape[3] - 1.0) / 2.0),
                      flow[:, 1:2] / ((inp.shape[2] - 1.0) / 2.0)], 1)
    inp = torch.cat([inp, inp.new_ones(n, 1, h, w)], 1)
    out = F.grid_sample(inp, (grid + flow).permute(0, 2, 3, 1), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    mask = out[:, -1:]
    mask = torch.where(mask > 0.999, torch.ones_like(mask), torch.zeros_like(mask))
    return out[:, :-1] * mask


def _conv(cin, cout, stride=1, dilation=1):
    return nn.Conv2d(cin, cout, 3, stride, dilation, dilation)


class Extractor(nn.Module):
    def __init__(self, dims):
        super().__init__()
        cin = 3
        for name, dim in zip(_ORDINAL, dims):
            self.add_module(f"module{name}", nn.Sequential(
                _conv(cin, dim, 2), nn.LeakyReLU(0.1), _conv(dim, dim), nn.LeakyReLU(0.1),
                _conv(dim, dim), nn.LeakyReLU(0.1)))
            cin = dim

    def forward(self, x):
        out = []
        for name in _ORDINAL:
            x = getattr(self, f"module{name}")(x)
            out.append(x)
        return out


class Decoder(nn.Module):
    def __init__(self, level, dims, dense, planes, backward_scale):
        super().__init__()
        current = planes if level == 6 else planes + dims[level - 1] + 4
        self.backward = backward_scale
        if level < 6:
            previous = (planes if level + 1 == 6 else planes + dims[level] + 4) + sum(dense)
            self.moduleUpflow = nn.ConvTranspose2d(2, 2, 4, 2, 1)
            self.moduleUpfeat = nn.ConvTranspose2d(previous, 2, 4, 2, 1)
        cin = current
        for name, ch in zip(_ORDINAL, dense):
            self.add_module(f"module{name}", nn.Sequential(_conv(cin, ch), nn.LeakyReLU(0.1)))
            cin += ch
        self.moduleSix = nn.Sequential(_conv(cin, 2))

    def forward(self, first, second, previous, d):
        if previous is None:
            feat = F.leaky_relu(correlation(first, second, d), 0.1)
        else:
            flow = self.moduleUpflow(previous[0])
            up = self.moduleUpfeat(previous[1])
            volume = F.leaky_relu(correlation(first, backward_warp(second, flow * self.backward),
                                              d), 0.1)
            feat = torch.cat([volume, first, flow, up], 1)
        for name in _ORDINAL[:5]:
            feat = torch.cat([getattr(self, f"module{name}")(feat), feat], 1)
        return self.moduleSix(feat), feat


class Refiner(nn.Module):
    def __init__(self, cin, layers):
        super().__init__()
        mods = []
        for ch, dil in layers:
            mods += [_conv(cin, ch, dilation=dil), nn.LeakyReLU(0.1)]
            cin = ch
        mods.append(_conv(cin, 2))
        self.moduleMain = nn.Sequential(*mods)

    def forward(self, x):
        return self.moduleMain(x)


class PWCNet(nn.Module):
    """``sizes`` is the configuration's ``pwc`` group."""

    def __init__(self, sizes: dict):
        super().__init__()
        dims, dense = tuple(sizes["level_dims"]), tuple(sizes["dense_dims"])
        self.d = sizes["max_displacement"]
        planes = (2 * self.d + 1) ** 2
        scales = {int(k): v for k, v in sizes["backward_scale"].items()}
        self.moduleExtractor = Extractor(dims)
        for level in (2, 3, 4, 5, 6):
            self.add_module(f"module{_ORDINAL[level - 1]}",
                            Decoder(level, dims, dense, planes, scales.get(level)))
        self.moduleRefiner = Refiner(planes + dims[1] + 4 + sum(dense),
                                     [tuple(x) for x in sizes["refiner"]])

    def forward(self, x):
        """(T, 3, Hp, Wp) -> (T-1, 2, Hp/4, Wp/4): each consecutive pair."""
        pyramid = self.moduleExtractor(x)
        est = None
        for level in (6, 5, 4, 3, 2):
            feat = pyramid[level - 1]
            est = getattr(self, f"module{_ORDINAL[level - 1]}")(feat[:-1], feat[1:], est, self.d)
        return est[0] + self.moduleRefiner(est[1])

    def estimate(self, frames):
        _, _, h, w = frames.shape
        hp, wp = int(math.ceil(h / 64.0) * 64.0), int(math.ceil(w / 64.0) * 64.0)
        x = frames[:, [2, 1, 0]] / 255.0
        x = F.interpolate(x, size=(hp, wp), mode="bilinear", align_corners=False)
        flow = self.forward(x)
        flow = 20.0 * F.interpolate(flow, size=(h, w), mode="bilinear", align_corners=False)
        return torch.cat([flow[:, 0:1] * (float(w) / float(wp)),
                          flow[:, 1:2] * (float(h) / float(hp))], 1)
