"""R(2+1)D clip-feature extractor.

Counterpart of the serial path of
``video_features_tpu/models/r21d/extract_r21d.py``. Per video: every
frame is decoded (on the ``--extraction_fps`` grid when it is given) and
kept as uint8, windowed by ``form_slices`` into ``--stack_size``-frame
stacks every ``--step_size`` frames (16/16 by default, the ragged tail
dropped), and ``--batch_size`` stacks go through the device at a time,
the last group zero-padded to that size and its surplus rows cut. The
stacks cross to the device as uint8 and ``kinetics_preprocess`` runs
there: /255, bilinear resize to 128x171 (``align_corners=False``, no
antialias), Kinetics normalisation, center crop 112 at rounded offsets.
``--show_pred`` prints each stack's top-5 Kinetics-400 classes.

Output: ``{r21d_rgb: (S, 512), fps, timestamps_ms}``, one timestamp per
decoded frame.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from video_features_tpu_torch.extract.base import BaseExtractor
from video_features_tpu_torch.io.paths import form_slices, video_path_of
from video_features_tpu_torch.io.video import DEFAULT_FPS, CorruptVideoError, probe, stream_frames
from video_features_tpu_torch.models.common.weights import (
    load_checked,
    load_state_dict,
    random_init_fallback,
)
from video_features_tpu_torch.models.r21d.convert import convert_state_dict
from video_features_tpu_torch.models.r21d.model import R21D_FEATURE_DIM, R2Plus1D, init_weights
from video_features_tpu_torch.ops.preprocess import KINETICS_MEAN, KINETICS_STD
from video_features_tpu_torch.ops.resize import resize_bilinear
from video_features_tpu_torch.ops.window import pad_batch
from video_features_tpu_torch.utils.labels import show_predictions_on_dataset

PRE_CENTRAL_CROP_SIZE = (128, 171)
CENTRAL_CROP_SIZE = 112
DEFAULT_STACK_SIZE = 16
DEFAULT_STEP_SIZE = 16


def kinetics_preprocess(frames: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8 -> (..., 112, 112, 3) fp32: ToFloatTensorInZeroOne
    -> Resize(128, 171) -> Normalize -> CenterCrop(112)."""
    x = frames.float().div(255.0).movedim(-1, -3)  # (..., 3, H, W)
    x = resize_bilinear(x, PRE_CENTRAL_CROP_SIZE, align_corners=False)
    mean = torch.tensor(KINETICS_MEAN, dtype=x.dtype, device=x.device).reshape(3, 1, 1)
    std = torch.tensor(KINETICS_STD, dtype=x.dtype, device=x.device).reshape(3, 1, 1)
    x = (x - mean) / std
    h, w = PRE_CENTRAL_CROP_SIZE
    top = int(round((h - CENTRAL_CROP_SIZE) / 2.0))
    left = int(round((w - CENTRAL_CROP_SIZE) / 2.0))
    x = x[..., top : top + CENTRAL_CROP_SIZE, left : left + CENTRAL_CROP_SIZE]
    return x.movedim(-3, -1)


class ExtractR21D(BaseExtractor):
    def __init__(self, config, external_call: bool = False) -> None:
        super().__init__(config, external_call)
        self.stack_size = int(self.config.stack_size or DEFAULT_STACK_SIZE)
        self.step_size = int(self.config.step_size or DEFAULT_STEP_SIZE)
        self.batch_size = max(int(self.config.batch_size or 1), 1)

    def _build(self, device: torch.device) -> R2Plus1D:
        model = R2Plus1D()
        if self.config.weights_path:
            load_checked(model, convert_state_dict(load_state_dict(self.config.weights_path)),
                         self.feature_type)
        else:
            random_init_fallback(self.config, self.feature_type,
                                 "a torchvision r2plus1d_18 (Kinetics-400) state dict (.pt/.pth)")
            init_weights(model)
        return model.to(device).eval()

    def prepare(self, entry):
        """Host half: ((T, H, W, 3) uint8 clip, stack slices, fps,
        timestamps_ms, path)."""
        path = video_path_of(entry)
        frames: List[np.ndarray] = []
        timestamps_ms: List[float] = []
        for frame, ts in stream_frames(path, self.config.extraction_fps):
            frames.append(frame)
            timestamps_ms.append(ts)
        if not frames:
            raise CorruptVideoError(f"no frames decoded from {path}")
        clip = np.stack(frames)
        slices = form_slices(clip.shape[0], self.stack_size, self.step_size)
        fps = self.config.extraction_fps or probe(path)[0] or DEFAULT_FPS
        return clip, slices, fps, timestamps_ms, path

    def forward(self, model: R2Plus1D, payload) -> Dict[str, np.ndarray]:
        clip, slices, fps, timestamps_ms, path = payload
        device = next(model.parameters()).device
        feats: List[np.ndarray] = []
        with torch.inference_mode():
            for g0 in range(0, len(slices), self.batch_size):
                chunk = slices[g0 : g0 + self.batch_size]
                stacks = pad_batch(np.stack([clip[s:e] for s, e in chunk]), self.batch_size)
                x = kinetics_preprocess(torch.from_numpy(stacks).to(device))  # (B, T, h, w, 3)
                f, logits = model(x.permute(0, 4, 1, 2, 3))
                feats.append(f[: len(chunk)].cpu().numpy())
                if self.config.show_pred:
                    for (start, end), row in zip(chunk, logits[: len(chunk)].cpu().numpy()):
                        print(f"{path} @ frames ({start}, {end})")
                        show_predictions_on_dataset(row, "kinetics")
        return {
            self.feature_type: (np.concatenate(feats) if feats
                                else np.zeros((0, R21D_FEATURE_DIM), np.float32)),
            "fps": np.array(fps),
            "timestamps_ms": np.array(timestamps_ms),
        }
