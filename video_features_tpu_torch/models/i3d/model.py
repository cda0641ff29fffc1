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

``forward_sharded`` (``--sharding mesh``, sequence parallelism) runs the
same modules over a list of time blocks, one a data row of the mesh:
every op whose temporal kernel is wider than 1 takes its time padding
from its neighbours' frames (``parallel/sharding.py::temporal_halo``,
zeros at the global ends) instead of ``F.pad``; the time mean is a sum
over the blocks divided by the global count. Counterpart of the JAX
package's I3D under a time axis sharded over 'data', where GSPMD inserts
the halos. On a mesh across launched processes the list is global, each
other process's block standing in as a ``meta`` tensor run through a
``meta`` copy of the network (shapes only): the halos and the blocks'
sums come from the processes that hold them.

``channel_div`` divides every channel count (1024 / ``channel_div``
features); it exists for small test networks and is 1 everywhere else.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

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
        self.time_pads = tf_same_pads(kernel, stride)[0]

    def forward(self, x: torch.Tensor, halo: bool = False) -> torch.Tensor:
        """``halo``: the time axis arrives padded (``forward_sharded``),
        so only the spatial pads are applied here."""
        if not halo:
            return max_pool_tf(x, self.kernel, self.stride)
        pads = _f_pad(self.kernel, self.stride)[:4] + (0, 0)
        return F.max_pool3d(F.pad(x, pads), self.kernel, self.stride, ceil_mode=True)

    def time_out(self, t: int) -> int:
        """Outputs along a time-padded axis of ``t`` (ceil mode: a last
        window must start inside the input)."""
        k, s = self.kernel[0], self.stride[0]
        n = -(-(t - k) // s) + 1
        return n - 1 if (n - 1) * s >= t else n


class Unit3D(nn.Module):
    """Conv3d (TF SAME padding, ``Conv3dCompat``) + eval BatchNorm + ReLU."""

    def __init__(self, cin: int, cout: int, kernel=(1, 1, 1), stride=(1, 1, 1),
                 use_bn: bool = True, use_bias: bool = False, activation: bool = True) -> None:
        super().__init__()
        self.pads = _f_pad(kernel, stride)
        self.time_pads = tf_same_pads(kernel, stride)[0]
        self.conv3d = Conv3dCompat(cin, cout, kernel, stride, bias=use_bias)
        self.batch3d = BatchNorm3d(cout, eps=1e-5) if use_bn else None
        self.activation = activation

    def forward(self, x: torch.Tensor, halo: bool = False) -> torch.Tensor:
        """``halo``: the time axis arrives padded (``forward_sharded``),
        so only the spatial pads are applied here."""
        pads = self.pads[:4] + (0, 0) if halo else self.pads
        x = self.conv3d(F.pad(x, pads) if any(pads) else x)
        if self.batch3d is not None:
            x = self.batch3d(x)
        return F.relu(x) if self.activation else x

    def time_out(self, t: int) -> int:
        """Outputs along a time-padded axis of ``t``."""
        k, s = self.conv3d.kernel_size[0], self.conv3d.stride[0]
        return (t - k) // s + 1 if t >= k else 0


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

    def __init__(self, in_channels: int = 3, num_classes: int = I3D_NUM_CLASSES,
                 channel_div: int = 1) -> None:
        super().__init__()

        def c(*n):  # channel counts over channel_div
            return [k // channel_div for k in n]

        self.conv3d_1a_7x7 = Unit3D(in_channels, *c(64), (7, 7, 7), (2, 2, 2))
        self.maxPool3d_2a_3x3 = MaxPoolTF((1, 3, 3), (1, 2, 2))
        self.conv3d_2b_1x1 = Unit3D(*c(64, 64))
        self.conv3d_2c_3x3 = Unit3D(*c(64, 192), (3, 3, 3))
        self.maxPool3d_3a_3x3 = MaxPoolTF((1, 3, 3), (1, 2, 2))
        self.mixed_3b = Mixed(*c(192), c(64, 96, 128, 16, 32, 32))
        self.mixed_3c = Mixed(*c(256), c(128, 128, 192, 32, 96, 64))
        self.maxPool3d_4a_3x3 = MaxPoolTF((3, 3, 3), (2, 2, 2))
        self.mixed_4b = Mixed(*c(480), c(192, 96, 208, 16, 48, 64))
        self.mixed_4c = Mixed(*c(512), c(160, 112, 224, 24, 64, 64))
        self.mixed_4d = Mixed(*c(512), c(128, 128, 256, 24, 64, 64))
        self.mixed_4e = Mixed(*c(512), c(112, 144, 288, 32, 64, 64))
        self.mixed_4f = Mixed(*c(528), c(256, 160, 320, 32, 128, 128))
        self.maxPool3d_5a_2x2 = MaxPoolTF((2, 2, 2), (2, 2, 2))
        self.mixed_5b = Mixed(*c(832), c(256, 160, 320, 32, 128, 128))
        self.mixed_5c = Mixed(*c(832), c(384, 192, 384, 48, 128, 128))
        self.conv3d_0c_1x1 = Unit3D(
            *c(I3D_FEATURE_DIM), num_classes, use_bn=False, use_bias=True, activation=False
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

    def forward_sharded(self, parts: Sequence[torch.Tensor],
                        replicas: Optional[Sequence["I3D"]] = None,
                        mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``forward`` over one clip's time blocks: ``parts[r]`` is (B,
        T_r, H, W, C) on ``replicas[r]``'s device (default: this module
        for every part), contiguous in time, every block but the last a
        multiple of 8 frames (the cumulative temporal stride of the stem
        and the two strided pools), so each block's outputs of a strided
        op are exactly its share of the global ones. Each op runs on each
        block with the block's replica, no block moves, and every op with
        a temporal kernel wider than 1 first takes its TF-SAME time pads
        from the neighbours (``temporal_halo``; zeros at the clip's ends).
        A last block that an op leaves without outputs drops out. The
        valid ``avg_pool3d`` takes one frame of right halo, none at the
        end. A clip too short for ``forward`` fails here as there.
        Returns (features (B, 1024), logits (B, 400)) on the first block's
        device: each block's sums over time and space, added in block
        order, over the global count.

        On a ``mesh`` of several processes ``parts`` and ``replicas`` are
        global (``sharding.stand_ins``): another process's block is a
        ``meta`` tensor and its replica a ``meta`` copy, so every process
        walks the same list of blocks, joins every halo exchange with its
        own blocks' edges (none when its blocks sit out or drop out), and
        counts every block; the blocks' sums are gathered from their
        processes and added in block order, the result on this process's
        first device."""
        from video_features_tpu_torch.parallel.sharding import gather_blocks, temporal_halo

        mods = list(replicas or [self] * len(parts))[:len(parts)]
        xs = [x.permute(0, 4, 1, 2, 3).contiguous().to(m.conv3d_1a_7x7.conv3d.weight.dtype)
              for x, m in zip(parts, mods)]
        for name, _ in self.named_children():
            if name == "conv3d_0c_1x1":
                break
            xs = _run_sharded([getattr(m, name) for m in mods], xs, mesh)
            mods = mods[:len(xs)]
        xs = temporal_halo([x.float() for x in xs], 0, 1, ends=False, mesh=mesh)
        xs = [F.avg_pool3d(x, (2, 7, 7), stride=1) for i, x in enumerate(xs)
              if x.shape[2] > 1 or i == 0]
        mods = mods[:len(xs)]
        count = sum(x.shape[2] * x.shape[3] * x.shape[4] for x in xs)
        sums = [(x.sum(dim=(2, 3, 4))[None], m.conv3d_0c_1x1(x).sum(dim=(2, 3, 4))[None])
                for m, x in zip(mods, xs)]
        feats, logits = gather_blocks(sums, xs[0].device if mesh is None else mesh.first, mesh)
        return feats.sum(0) / count, logits.sum(0) / count


def _run_sharded(layers: Sequence[nn.Module], xs: List[torch.Tensor],
                 mesh=None) -> List[torch.Tensor]:
    """One layer of ``I3D.forward_sharded``: ``layers[r]`` is the layer on
    block ``r``'s replica. A ``Mixed`` block runs each branch so, then
    concatenates per block; an op with time pads takes them as halos and
    runs with only its spatial pads."""
    layer = layers[0]
    if isinstance(layer, Mixed):
        branches = [_run_sharded([getattr(m, b) for m in layers], xs, mesh)
                    for b in ("branch_0", "branch_1", "branch_2", "branch_3")]
        return [torch.cat(per_block, dim=1) for per_block in zip(*branches)]
    if isinstance(layer, nn.Sequential):
        for i in range(len(layer)):
            xs = _run_sharded([m[i] for m in layers], xs, mesh)
        return xs
    from video_features_tpu_torch.parallel.sharding import temporal_halo

    lo, hi = layer.time_pads
    if lo or hi:
        xs = temporal_halo(xs, lo, hi, mesh=mesh)
    # only the last block can be left without outputs, and then it drops
    # (a first block keeps its op, which then fails as ``forward`` does)
    xs = [x for i, x in enumerate(xs) if layer.time_out(x.shape[2]) > 0 or i == 0]
    return [m(x, halo=True) for m, x in zip(layers, xs)]


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
