"""RAFT optical flow (inference graph), the "basic" configuration:
``corr_levels=4``, ``radius=4``, ``hidden=context=128``, ``iters=20``.

Counterpart of ``video_features_tpu/models/raft/model.py``. NCHW inside.
Module names are those of the princeton-vl checkpoint (``fnet.layer1.0
.conv1``, ``cnet.norm1``, ``update_block.gru.convz1``,
``update_block.mask.0``, ...), so ``raft-sintel.pth`` loads once its
DataParallel ``module.`` prefix is stripped (``convert.py``).

The public forward keeps the JAX contract: (T, H, W, 3) RGB floats in
[0, 255], H and W multiples of 8 -> (T-1, H, W, 2) flow of each
consecutive pair; a leading batch axis, (B, T, H, W, 3) -> (B, T-1, H,
W, 2), runs B independent sequences in one pass. ``fnet`` encodes the
frames once and the pairs are its views ``fmap[:-1]`` / ``fmap[1:]``.

Nothing here reaches a hand-written kernel: the JAX package computes the
all-pairs volume and its window lookup with XLA (fp32 ``HIGHEST``
einsums), so here they are a batched fp32 matmul and ``grid_sample``
(``devices.pin_fp32`` keeps TF32 off). The upsampling mask is computed
in the last iteration only: the earlier iterations' masks are never
read.

``--dtype bfloat16`` (``cast_for_compute``; RAFT keeps no parameter
fp32): every convolution computes in bf16 (both encoders, the motion
encoder, the six GRU gate convs, the flow and mask heads) and so do the
encoders' residual streams, while what the 20-step recurrence
accumulates through stays fp32: the correlation volume and its lookup,
the gate nonlinearities and the hidden-state carry, ``coords1``, and the
upsampling softmax. The norms keep fp32 statistics
(``models/common/layers.py``). The JAX package keeps RAFT's parameters
fp32 and casts them at each conv; casting them once after loading is the
same rounding. The flow is fp32 either way.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from video_features_tpu_torch.models.common.layers import (
    BatchNorm2d,
    InstanceNorm2d,
    device_vector,
)

CORR_LEVELS = 4
CORR_RADIUS = 4
HIDDEN_DIM = 128
CONTEXT_DIM = 128
WINDOW = (2 * CORR_RADIUS + 1) ** 2
# the parameters a bf16 network keeps fp32: none
FP32_PARAMS = ()


def _norm(kind: str, planes: int) -> nn.Module:
    # torch InstanceNorm2d defaults: no affine parameters, eps 1e-5, the
    # sample's own statistics; eval BatchNorm reads its running stats; both
    # with fp32 statistics for a bf16 input
    return BatchNorm2d(planes) if kind == "batch" else InstanceNorm2d(planes)


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, planes: int, norm: str, stride: int = 1) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride=stride, padding=1)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm1 = _norm(norm, planes)
        self.norm2 = _norm(norm, planes)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(nn.Conv2d(cin, planes, 1, stride=stride),
                                            _norm(norm, planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """Conv encoder to 1/8 resolution."""

    def __init__(self, output_dim: int, norm: str) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = _norm(norm, 64)
        cin = 64
        for i, (dim, stride) in enumerate(((64, 1), (96, 2), (128, 2)), start=1):
            self.add_module(f"layer{i}", nn.Sequential(ResidualBlock(cin, dim, norm, stride),
                                                       ResidualBlock(dim, dim, norm)))
            cin = dim
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm1(self.conv1(x.to(self.conv1.weight.dtype))))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


class BasicMotionEncoder(nn.Module):
    def __init__(self) -> None:
        super().__init__()
        self.convc1 = nn.Conv2d(CORR_LEVELS * WINDOW, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        """fp32 ``flow`` and ``corr`` -> features in the convs' dtype; the
        raw flow channels appended are a rounded copy, the fp32 flow
        accumulator lives in ``RAFT.forward``."""
        dt = self.convc1.weight.dtype
        cor = F.relu(self.convc2(F.relu(self.convc1(corr.to(dt)))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow.to(dt)))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow.to(dt)], dim=1)


class SepConvGRU(nn.Module):
    """Separable 1x5 + 5x1 ConvGRU. The gate convs take ``x``'s dtype; the
    gate nonlinearities and the update of the hidden state ``h`` run in
    fp32 on an fp32 ``h``, which the 20 steps carry."""

    def __init__(self, hidden: int = HIDDEN_DIM, input_dim: int = 128 + CONTEXT_DIM) -> None:
        super().__init__()
        for sfx, kernel, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in "zrq":
                self.add_module(f"conv{gate}{sfx}",
                                nn.Conv2d(hidden + input_dim, hidden, kernel, padding=pad))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        for sfx in "12":
            hx = torch.cat([h.to(dt), x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{sfx}")(hx).float())
            r = torch.sigmoid(getattr(self, f"convr{sfx}")(hx).float())
            q = torch.tanh(getattr(self, f"convq{sfx}")(
                torch.cat([(r * h).to(dt), x], dim=1)).float())
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(HIDDEN_DIM, 256, 3, padding=1)
        self.conv2 = nn.Conv2d(256, 2, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x.to(self.conv1.weight.dtype))))


class BasicUpdateBlock(nn.Module):
    """One refinement iteration's convolutions: motion encoder -> GRU ->
    flow delta. ``mask`` (the upsampling weights) is run by ``RAFT`` once,
    after the last iteration."""

    def __init__(self) -> None:
        super().__init__()
        self.encoder = BasicMotionEncoder()
        self.gru = SepConvGRU()
        self.flow_head = FlowHead()
        self.mask = nn.Sequential(nn.Conv2d(HIDDEN_DIM, 256, 3, padding=1), nn.ReLU(),
                                  nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        """fp32 ``net`` (the carry), ``inp``, ``corr`` and ``flow`` -> the
        next fp32 carry and the fp32 flow delta."""
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp.to(motion.dtype), motion], dim=1))
        return net, self.flow_head(net).float()


def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int = CORR_LEVELS) -> Tuple[torch.Tensor, ...]:
    """All-pairs correlation / sqrt(C) and its 2x2 average-pool pyramid.

    fmaps are (N, C, H, W); returns ``num_levels`` tensors (N*H*W, 1,
    h_l, w_l), row ``n*H*W + y*W + x`` holding the volume of pixel (y, x)
    of ``fmap1[n]`` over ``fmap2[n]``. Pooling floors odd sizes, as the
    JAX package's VALID pooling does."""
    N, C, H, W = fmap1.shape
    corr = torch.bmm(fmap1.reshape(N, C, H * W).transpose(1, 2), fmap2.reshape(N, C, H * W))
    corr = (corr / torch.sqrt(torch.tensor(float(C), dtype=corr.dtype))).reshape(
        N * H * W, 1, H, W)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        pyramid.append(corr)
    return tuple(pyramid)


def lookup_corr(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                radius: int = CORR_RADIUS) -> torch.Tensor:
    """Bilinear samples of each pyramid level in a (2r+1)^2 window around
    ``coords`` (N, 2, H, W as x, y pixels) -> (N, levels*(2r+1)^2, H, W).

    Window channel ``i*(2r+1) + j`` samples (x + i - r, y + j - r): the
    offset applied to x comes from the first window axis, as in the
    reference (its delta is ``stack(meshgrid(dy, dx))`` added to (x, y)),
    and the pretrained weights bake this in. Samples outside a level are
    zero (``padding_mode="zeros"``), which is what the JAX package's
    one-hot weights give."""
    N, _, H, W = coords.shape
    d = torch.arange(-radius, radius + 1, dtype=coords.dtype, device=coords.device)
    di, dj = torch.meshgrid(d, d, indexing="ij")
    delta = torch.stack([di, dj], dim=-1).reshape(1, 2 * radius + 1, 2 * radius + 1, 2)
    centre = coords.permute(0, 2, 3, 1).reshape(N * H * W, 1, 1, 2)
    out = []
    for lvl, corr in enumerate(pyramid):
        h, w = corr.shape[-2:]
        pts = centre / 2 ** lvl + delta  # (B, 2r+1, 2r+1, (x, y)) in pixels
        # align_corners=True maps -1 and 1 to the first and last pixel centres
        scale = device_vector([2.0 / (w - 1), 2.0 / (h - 1)], pts)
        grid = pts * scale - 1.0
        # grid[b, i, j] = (x_i, y_j) -> out[b, 0, i, j]
        win = F.grid_sample(corr, grid, mode="bilinear", padding_mode="zeros",
                            align_corners=True)
        out.append(win.reshape(N, H, W, -1))
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2)


def coords_grid(n: int, h: int, w: int, device=None) -> torch.Tensor:
    """(N, 2, H, W) pixel coordinate grid, channels (x, y)."""
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([x, y])[None].expand(n, 2, h, w)


def upsample_flow(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Convex-combination 8x upsampling: (N, 2, H, W) flow and (N, 576,
    H, W) mask -> (N, 2, 8H, 8W). The weights are a softmax over the 9
    neighbours of each coarse cell, in fp32, per output subpixel."""
    N, _, H, W = flow.shape
    mask = torch.softmax(mask.float().reshape(N, 1, 9, 8, 8, H, W), dim=2)
    patches = F.unfold(8.0 * flow, 3, padding=1).reshape(N, 2, 9, 1, 1, H, W)
    up = (mask * patches).sum(dim=2)  # (N, 2, 8, 8, H, W)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(N, 2, 8 * H, 8 * W)


def input_grid(h: int, w: int, div: int = 8, min_size: int = 128) -> Tuple[int, int]:
    """The padded (H, W) RAFT runs at for an (h, w) input: multiples of
    ``div`` (the encoder works at 1/8) with a ``min_size`` floor per side
    (the deepest pyramid level is at 1/64, and the sampler needs every
    level at least 2 wide)."""
    return max(-(-h // div) * div, min_size), max(-(-w // div) * div, min_size)


class RAFT(nn.Module):
    """(T, H, W, 3) or (B, T, H, W, 3) RGB floats in [0, 255] ->
    (T-1, H, W, 2) or (B, T-1, H, W, 2) flow, fp32."""

    def __init__(self, iters: int = 20) -> None:
        super().__init__()
        self.iters = iters
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(HIDDEN_DIM + CONTEXT_DIM, "batch")
        self.update_block = BasicUpdateBlock()

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        batched = frames.dim() == 5
        if not batched:
            frames = frames[None]
        B, T, H, W, _ = frames.shape
        if H % 8 or W % 8:
            raise ValueError(f"RAFT needs sides that are multiples of 8, got {H}x{W} "
                             "(extract_raft.InputPadder pads them)")
        x = (2.0 * (frames / 255.0) - 1.0).permute(0, 1, 4, 2, 3)  # (B, T, 3, H, W)

        # the volume feeds 20 lookups: built and sampled in fp32, whatever
        # the encoders computed in
        fmap = self.fnet(x.reshape(B * T, 3, H, W)).float()
        fmap = fmap.reshape(B, T, *fmap.shape[1:])
        pairs = B * (T - 1)
        pyramid = build_corr_pyramid(fmap[:, :-1].reshape(pairs, *fmap.shape[2:]),
                                     fmap[:, 1:].reshape(pairs, *fmap.shape[2:]))
        del fmap

        cnet = self.cnet(x[:, :-1].reshape(pairs, 3, H, W)).float()
        net, inp = torch.split(cnet, [HIDDEN_DIM, CONTEXT_DIM], dim=1)
        net, inp = torch.tanh(net), F.relu(inp)

        coords0 = coords_grid(pairs, H // 8, W // 8, device=frames.device)
        coords1 = coords0
        for _ in range(self.iters):
            corr = lookup_corr(pyramid, coords1)
            net, delta = self.update_block(net, inp, corr, coords1 - coords0)
            coords1 = coords1 + delta
        del pyramid
        mask_in = net.to(self.update_block.mask[0].weight.dtype)
        flow = upsample_flow(coords1 - coords0, 0.25 * self.update_block.mask(mask_in).float())
        flow = flow.permute(0, 2, 3, 1).reshape(B, T - 1, H, W, 2)
        return flow if batched else flow[0]


def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded LeCun-normal conv weights, zero biases and identity
    BatchNorm (the JAX package's initialisers), from a generator of the
    model's own."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                w = m.weight
                w.copy_(torch.randn(w.shape, generator=gen) * w[0].numel() ** -0.5)
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model
