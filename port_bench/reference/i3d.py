"""Plain I3D (Inception-v1 inflated to 3D; Carreira and Zisserman,
arXiv:1705.07750), the inference graph that v-iashin/video_features runs:
hassony2/kinetics_i3d_pytorch's layout and names (``conv3d_1a_7x7.conv3d``,
``mixed_4b.branch_1.0``, ...), so a checkpoint of that repository loads as
it is.

Every convolution and max pool pads TensorFlow-style SAME: along each axis
``max(kernel - stride, 0)`` zeros, the smaller half first. Max pools run in
ceil mode. BatchNorm in eval mode, eps 1e-5. Input (B, C, T, H, W) in
[-1, 1]; output (B, 1024) features: the (2, 7, 7) average pool, then the
mean over the remaining time and space.

Plain torch: no import of the program under test.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def same_pads(kernel: Sequence[int], stride: Sequence[int]):
    """``F.pad`` order (W lo, W hi, H lo, H hi, T lo, T hi)."""
    pads = []
    for k, s in zip(reversed(kernel), reversed(stride)):
        along = max(k - s, 0)
        pads += [along // 2, along - along // 2]
    return tuple(pads)


class Unit3D(nn.Module):
    def __init__(self, cin, cout, kernel=(1, 1, 1), stride=(1, 1, 1), use_bn=True,
                 use_bias=False, activation=True):
        super().__init__()
        self.pads = same_pads(kernel, stride)
        self.conv3d = nn.Conv3d(cin, cout, kernel, stride, bias=use_bias)
        self.batch3d = nn.BatchNorm3d(cout, eps=1e-5) if use_bn else None
        self.activation = activation

    def forward(self, x):
        x = self.conv3d(F.pad(x, self.pads))
        if self.batch3d is not None:
            x = self.batch3d(x)
        return F.relu(x) if self.activation else x


class MaxPoolSame(nn.Module):
    def __init__(self, kernel, stride):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.pads = same_pads(kernel, stride)

    def forward(self, x):
        return F.max_pool3d(F.pad(x, self.pads), self.kernel, self.stride, ceil_mode=True)


class Mixed(nn.Module):
    """Inception block; ``out`` = (b0, b1 reduce, b1, b2 reduce, b2, b3)."""

    def __init__(self, cin, out):
        super().__init__()
        self.branch_0 = Unit3D(cin, out[0])
        self.branch_1 = nn.Sequential(Unit3D(cin, out[1]), Unit3D(out[1], out[2], (3, 3, 3)))
        self.branch_2 = nn.Sequential(Unit3D(cin, out[3]), Unit3D(out[3], out[4], (3, 3, 3)))
        self.branch_3 = nn.Sequential(MaxPoolSame((3, 3, 3), (1, 1, 1)), Unit3D(cin, out[5]))

    def forward(self, x):
        return torch.cat([self.branch_0(x), self.branch_1(x), self.branch_2(x),
                          self.branch_3(x)], dim=1)


class I3D(nn.Module):
    """``sizes`` is the configuration's ``i3d`` group: ``stem`` (conv1,
    conv2b, conv2c widths), ``mixed`` {name: the six widths},
    ``num_classes``. ``width_div`` divides every width (small test
    networks only)."""

    def __init__(self, in_channels: int, sizes: dict, width_div: int = 1):
        super().__init__()

        def c(*n):
            return [k // width_div for k in n]

        c1, c2b, c2c = c(*sizes["stem"])
        mixed = {k: c(*v) for k, v in sizes["mixed"].items()}
        self.conv3d_1a_7x7 = Unit3D(in_channels, c1, (7, 7, 7), (2, 2, 2))
        self.maxPool3d_2a_3x3 = MaxPoolSame((1, 3, 3), (1, 2, 2))
        self.conv3d_2b_1x1 = Unit3D(c1, c2b)
        self.conv3d_2c_3x3 = Unit3D(c2b, c2c, (3, 3, 3))
        self.maxPool3d_3a_3x3 = MaxPoolSame((1, 3, 3), (1, 2, 2))
        cin = c2c
        order = (("mixed_3b", None), ("mixed_3c", "maxPool3d_4a_3x3"), ("mixed_4b", None),
                 ("mixed_4c", None), ("mixed_4d", None), ("mixed_4e", None),
                 ("mixed_4f", "maxPool3d_5a_2x2"), ("mixed_5b", None), ("mixed_5c", None))
        pools = {"maxPool3d_4a_3x3": ((3, 3, 3), (2, 2, 2)),
                 "maxPool3d_5a_2x2": ((2, 2, 2), (2, 2, 2))}
        for name, pool_after in order:
            widths = mixed[name]
            self.add_module(name, Mixed(cin, widths))
            cin = widths[0] + widths[2] + widths[4] + widths[5]
            if pool_after:
                self.add_module(pool_after, MaxPoolSame(*pools[pool_after]))
        self.feature_dim = cin
        self.conv3d_0c_1x1 = Unit3D(cin, sizes["num_classes"], use_bn=False, use_bias=True,
                                    activation=False)

    def forward(self, x):
        for name, layer in self.named_children():
            if name == "conv3d_0c_1x1":
                break
            x = layer(x)
        x = F.avg_pool3d(x, (2, 7, 7), stride=1)
        return x.mean(dim=(2, 3, 4))
