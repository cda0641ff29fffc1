"""RAFT optical-flow extractor.

Counterpart of ``video_features_tpu/models/raft/extract_raft.py``: the
shared pair-window runtime (``models/common/flow_extract.py``) with RAFT,
whose frames are replicate-padded to multiples of 8 (with a 128-px floor)
before the model and whose flow is unpadded after it. Flow comes back at
the frames' resolution as ``<stem>_raft.npy`` (T-1, 2, H, W). Under
``--preprocess device`` the taps place the resized image on that padded
grid, the replicate pad inside the resize (``_device_grid``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from video_features_tpu_torch.models.common.flow_extract import PairwiseFlowExtractor
from video_features_tpu_torch.models.raft.convert import convert_state_dict
from video_features_tpu_torch.models.raft.model import FP32_PARAMS, RAFT, init_weights, input_grid


class InputPadder:
    """Replicate-pad (H, W) to multiples of 8, 'sintel' mode (``pad//2``
    on the left and top, the rest on the right and bottom), on the host.

    Also a 128-px floor per side: the deepest of RAFT's 4 pyramid levels
    is at 1/64 resolution, and the sampler needs every level at least 2
    wide. ``unpad`` restores the original size."""

    def __init__(self, shape: Tuple[int, int], div: int = 8, min_size: int = 128):
        self.ht, self.wd = shape
        tgt_ht, tgt_wd = input_grid(self.ht, self.wd, div, min_size)
        pad_ht, pad_wd = tgt_ht - self.ht, tgt_wd - self.wd
        self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, pad_ht // 2, pad_ht - pad_ht // 2]

    def pad(self, x: np.ndarray) -> np.ndarray:
        """(..., H, W, C) -> replicate-padded."""
        l, r, t, b = self._pad
        width = [(0, 0)] * (x.ndim - 3) + [(t, b), (l, r), (0, 0)]
        return np.pad(x, width, mode="edge")

    def pad_tensor(self, x: torch.Tensor) -> torch.Tensor:
        """``pad`` on a tensor, on its device: clamped row and column
        indices."""
        l, r, t, b = self._pad
        H, W = x.shape[-3], x.shape[-2]
        rows = torch.arange(-t, H + b, device=x.device).clamp_(0, H - 1)
        cols = torch.arange(-l, W + r, device=x.device).clamp_(0, W - 1)
        return x.index_select(-3, rows).index_select(-2, cols)

    def unpad(self, x):
        """(..., H, W, C) -> original size (an array or a tensor)."""
        l, r, t, b = self._pad
        H, W = x.shape[-3], x.shape[-2]
        return x[..., t : H - b, l : W - r, :]


class ExtractRAFT(PairwiseFlowExtractor):
    checkpoint = "the princeton-vl RAFT state dict (raft-sintel.pth)"
    _convert_state_dict = staticmethod(convert_state_dict)
    _init_weights = staticmethod(init_weights)
    _fp32_params = FP32_PARAMS

    def _model(self) -> RAFT:
        return RAFT()

    def _make_padder(self, shape):
        return InputPadder(shape)

    def _device_grid(self, oh: int, ow: int):
        # InputPadder's target grid, the image where its 'sintel' pad puts
        # it (pad // 2 on the top and left), so the padder's unpad slices
        # the same region
        tgt_h, tgt_w = input_grid(oh, ow)
        return tgt_h, tgt_w, (tgt_h - oh) // 2, (tgt_w - ow) // 2
