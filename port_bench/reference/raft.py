"""Plain RAFT (Teed and Deng, arXiv:2003.12039), the "basic" model of
princeton-vl/RAFT as v-iashin/video_features runs it for I3D: instance-norm
feature encoder, batch-norm context encoder, all-pairs correlation with an
average-pool pyramid, a (2r+1)^2 bilinear window lookup per level, the
separable ConvGRU update block iterated ``iters`` times, and convex 8x
upsampling. Module names and the ``norm3`` aliases are princeton-vl's, so
``raft-sintel.pth`` (without its ``module.`` prefix) loads as it is.

Departures that change no result: each frame of a sequence is encoded once
and the pairs are views of the encoded frames (princeton-vl encodes both
images of every pair), and the upsampling mask is computed after the last
iteration only (princeton-vl computes it every iteration and reads the
last one).

Input (T, 3, H, W) RGB in [0, 255], H and W multiples of 8; output (T-1,
2, H, W) flow of each consecutive pair. Plain torch.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def _norm(kind, planes):
    return nn.BatchNorm2d(planes) if kind == "batch" else nn.InstanceNorm2d(planes)


class ResidualBlock(nn.Module):
    def __init__(self, cin, planes, norm, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm1 = _norm(norm, planes)
        self.norm2 = _norm(norm, planes)
        self.downsample = None
        if stride != 1:
            self.norm3 = _norm(norm, planes)
            self.downsample = nn.Sequential(nn.Conv2d(cin, planes, 1, stride=stride), self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, output_dim, norm, dims=(64, 96, 128)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = _norm(norm, 64)
        cin = 64
        for i, (dim, stride) in enumerate(zip(dims, (1, 2, 2)), start=1):
            self.add_module(f"layer{i}", nn.Sequential(ResidualBlock(cin, dim, norm, stride),
                                                       ResidualBlock(dim, dim, norm)))
            cin = dim
        self.conv2 = nn.Conv2d(cin, output_dim, 1)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_planes):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden, input_dim):
        super().__init__()
        for sfx, kernel, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in "zrq":
                self.add_module(f"conv{gate}{sfx}",
                                nn.Conv2d(hidden + input_dim, hidden, kernel, padding=pad))

    def forward(self, h, x):
        for sfx in "12":
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{sfx}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{sfx}")(hx))
            q = torch.tanh(getattr(self, f"convq{sfx}")(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, cin, hidden=256):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, hidden, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    def __init__(self, corr_planes, hidden):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes)
        self.gru = SepConvGRU(hidden, 128 + hidden)
        self.flow_head = FlowHead(hidden)
        self.mask = nn.Sequential(nn.Conv2d(hidden, 256, 3, padding=1), nn.ReLU(),
                                  nn.Conv2d(256, 64 * 9, 1))


def corr_pyramid(fmap1, fmap2, levels):
    """All-pairs volume / sqrt(C), (N*H*W, 1, H, W), and its 2x2 pools."""
    n, c, h, w = fmap1.shape
    corr = torch.matmul(fmap1.view(n, c, h * w).transpose(1, 2), fmap2.view(n, c, h * w))
    corr = (corr / torch.sqrt(torch.tensor(c).float())).reshape(n * h * w, 1, h, w)
    out = [corr]
    for _ in range(levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        out.append(corr)
    return out


def bilinear_sampler(img, coords):
    """princeton-vl's ``bilinear_sampler``: pixel (x, y) coordinates,
    ``grid_sample`` with aligned corners, zeros outside."""
    h, w = img.shape[-2:]
    xgrid, ygrid = coords.split([1, 1], dim=-1)
    xgrid = 2 * xgrid / (w - 1) - 1
    ygrid = 2 * ygrid / (h - 1) - 1
    return F.grid_sample(img, torch.cat([xgrid, ygrid], dim=-1), align_corners=True)


def lookup(pyramid, coords, radius):
    coords = coords.permute(0, 2, 3, 1)
    n, h1, w1, _ = coords.shape
    d = torch.linspace(-radius, radius, 2 * radius + 1, device=coords.device)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1)
    delta = delta.view(1, 2 * radius + 1, 2 * radius + 1, 2)
    out = []
    for i, corr in enumerate(pyramid):
        centroid = coords.reshape(n * h1 * w1, 1, 1, 2) / 2 ** i
        out.append(bilinear_sampler(corr, centroid + delta).view(n, h1, w1, -1))
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2).contiguous().float()


def coords_grid(n, h, w, device):
    y, x = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                          indexing="ij")
    return torch.stack([x, y], dim=0).float()[None].repeat(n, 1, 1, 1)


def upsample_flow(flow, mask):
    n, _, h, w = flow.shape
    mask = torch.softmax(mask.view(n, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).view(n, 2, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(n, 2, 8 * h, 8 * w)


class RAFT(nn.Module):
    """``sizes`` is the configuration's ``raft`` group."""

    def __init__(self, sizes: dict):
        super().__init__()
        self.hidden, self.context = sizes["hidden_dim"], sizes["context_dim"]
        self.levels, self.radius, self.iters = (sizes["corr_levels"], sizes["corr_radius"],
                                                sizes["iters"])
        dims = tuple(sizes["encoder_dims"])
        self.fnet = BasicEncoder(sizes["feature_dim"], "instance", dims)
        self.cnet = BasicEncoder(self.hidden + self.context, "batch", dims)
        self.update_block = BasicUpdateBlock(self.levels * (2 * self.radius + 1) ** 2,
                                             self.hidden)

    def forward(self, frames):
        x = 2 * (frames / 255.0) - 1.0
        fmap = self.fnet(x).float()
        pyramid = corr_pyramid(fmap[:-1], fmap[1:], self.levels)
        net, inp = torch.split(self.cnet(x[:-1]), [self.hidden, self.context], dim=1)
        net, inp = torch.tanh(net), torch.relu(inp)
        n, _, h, w = fmap[:-1].shape
        coords0 = coords_grid(n, h, w, frames.device)
        coords1 = coords0.clone()
        block = self.update_block
        for _ in range(self.iters):
            corr = lookup(pyramid, coords1, self.radius)
            motion = block.encoder(coords1 - coords0, corr)
            net = block.gru(net, torch.cat([inp, motion], dim=1))
            coords1 = coords1 + block.flow_head(net)
        return upsample_flow(coords1 - coords0, 0.25 * block.mask(net))
