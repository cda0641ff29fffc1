"""ResNet frame-feature extractor.

Counterpart of the serial host path of
``video_features_tpu/models/resnet/extract_resnet.py``. Per video: frames
stream from the decoder (``--extraction_fps`` picks them on the target
grid), each goes through torchvision's Resize(256) / CenterCrop(224) /
Normalize chain on the host (``imagenet_preprocess``, byte-identical to
the JAX package), and ``--batch_size`` frames go through the device at a
time, the tail batch zero-padded to that size and its surplus rows cut.
``--show_pred`` prints each frame's top-5 ImageNet classes.

Output: ``{resnetXX: (T, 512 * expansion), fps, timestamps_ms}``, 2048-d
for resnet50 and deeper.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from video_features_tpu_torch.extract.base import BaseExtractor
from video_features_tpu_torch.io.paths import video_path_of
from video_features_tpu_torch.io.video import DEFAULT_FPS, CorruptVideoError, probe, stream_frames
from video_features_tpu_torch.models.common.weights import (
    load_checked,
    load_state_dict,
    random_init_fallback,
)
from video_features_tpu_torch.models.resnet.convert import convert_state_dict
from video_features_tpu_torch.models.resnet.model import ResNet, init_weights
from video_features_tpu_torch.ops.preprocess import imagenet_preprocess
from video_features_tpu_torch.ops.window import pad_batch
from video_features_tpu_torch.utils.labels import show_predictions_on_dataset


class ExtractResNet(BaseExtractor):
    def __init__(self, config, external_call: bool = False) -> None:
        super().__init__(config, external_call)
        self.batch_size = max(int(self.config.batch_size or 1), 1)

    def _build(self, device: torch.device) -> ResNet:
        model = ResNet(self.feature_type)
        if self.config.weights_path:
            sd = convert_state_dict(load_state_dict(self.config.weights_path), self.feature_type)
            load_checked(model, sd, self.feature_type)
        else:
            random_init_fallback(self.config, self.feature_type,
                                 f"a torchvision {self.feature_type} state dict (.pt/.pth)")
            init_weights(model)
        return model.to(device).eval()

    def prepare(self, entry):
        """Host half: (list of (batch_size, 3, 224, 224) batches, their
        valid row counts, fps, timestamps_ms)."""
        path = video_path_of(entry)
        frames: List[np.ndarray] = []
        timestamps_ms: List[float] = []
        for frame, ts in stream_frames(path, self.config.extraction_fps):
            frames.append(imagenet_preprocess(frame))
            timestamps_ms.append(ts)
        if not frames:
            raise CorruptVideoError(f"no frames decoded from {path}")
        batches, counts = [], []
        for i in range(0, len(frames), self.batch_size):
            chunk = frames[i : i + self.batch_size]
            batches.append(pad_batch(np.stack(chunk), self.batch_size))
            counts.append(len(chunk))
        fps = self.config.extraction_fps or probe(path)[0] or DEFAULT_FPS
        return batches, counts, fps, timestamps_ms

    def forward(self, model: ResNet, payload) -> Dict[str, np.ndarray]:
        batches, counts, fps, timestamps_ms = payload
        device = next(model.parameters()).device
        feats: List[np.ndarray] = []
        with torch.inference_mode():
            for x, n in zip(batches, counts):
                f, logits = model(torch.from_numpy(x).to(device))
                feats.append(f[:n].cpu().numpy())
                if self.config.show_pred:
                    show_predictions_on_dataset(logits[:n].cpu().numpy(), "imagenet")
        return {
            self.feature_type: np.concatenate(feats),
            "fps": np.array(fps),
            "timestamps_ms": np.array(timestamps_ms),
        }
