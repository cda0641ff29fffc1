"""ResNet frame-feature extractor.

Counterpart of the serial host path of
``video_features_tpu/models/resnet/extract_resnet.py``. Per video: frames
stream from the decoder (``--extraction_fps`` picks them on the target
grid), each goes through torchvision's Resize(256) / CenterCrop(224) /
Normalize chain on the host (``imagenet_preprocess``, byte-identical to
the JAX package), and ``--batch_size`` frames go through the device at a
time, the tail batch zero-padded to that size and its surplus rows cut.
``--show_pred`` prints each frame's top-5 ImageNet classes. With
``--video_batch N`` the frames of N videos re-chunk into
``N * batch_size``-row forwards. Not ported yet: the JAX package's
streaming fallback for a video too long to prefetch, and the
``--preprocess device`` payloads of its hooks (ROADMAP queue 1, item 7).

Output: ``{resnetXX: (T, 512 * expansion), fps, timestamps_ms}``, 2048-d
for resnet50 and deeper.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from video_features_tpu_torch.extract.base import BaseExtractor, device_of
from video_features_tpu_torch.extract.ingest import HostCopy, place_batch
from video_features_tpu_torch.io.paths import video_path_of
from video_features_tpu_torch.io.video import (
    CorruptVideoError,
    fps_or_default,
    probe,
    stream_frames,
)
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
        fps = self.config.extraction_fps or fps_or_default(probe(path)[0], path)
        return batches, counts, fps, timestamps_ms

    # --- the device half, split (extract/base.py): every batch's H2D,
    # forward and D2H enqueued at dispatch, waited for at fetch
    def dispatch_prepared(self, model: ResNet, payload):
        batches, counts, fps, timestamps_ms = payload
        device = device_of(model)
        outs = []
        with torch.inference_mode():
            for x, n in zip(batches, counts):
                f, logits = model(place_batch(x, device))
                # the 1000-class logits cross only for --show_pred
                outs.append((HostCopy(f[:n]),
                             HostCopy(logits[:n]) if self.config.show_pred else None))
        return outs, fps, timestamps_ms

    def fetch_dispatched(self, handle) -> Dict[str, np.ndarray]:
        outs, fps, timestamps_ms = handle
        feats: List[np.ndarray] = []
        for f, logits in outs:
            feats.append(f.numpy())
            if logits is not None:
                show_predictions_on_dataset(logits.numpy(), "imagenet")
        return {
            self.feature_type: np.concatenate(feats),
            "fps": np.array(fps),
            "timestamps_ms": np.array(timestamps_ms),
        }

    # --- cross-video aggregation (--video_batch): the valid frames of N
    # videos re-chunk into (N * batch_size)-row forwards, so short videos,
    # whose lone tail batch is mostly padding, share a dispatch. Large
    # videos (over AGG_MAX_FRAMES valid rows resident while a group fills)
    # and --show_pred (per-video print order) take the solo path.
    AGG_MAX_FRAMES = 512

    def agg_key(self, payload):
        batches, counts, _, _ = payload
        if self.config.show_pred or sum(counts) > self.AGG_MAX_FRAMES:
            return None
        return batches[0].shape  # (batch_size, 3, 224, 224)

    def dispatch_group(self, model: ResNet, payloads):
        group = max(int(self.config.video_batch or 1), 1)
        rows, totals = [], []
        for batches, counts, _, _ in payloads:
            rows.extend(x[:n] for x, n in zip(batches, counts))
            totals.append(sum(counts))
        outs = self._dispatch_rows_grouped(rows, self.batch_size * group, device_of(model),
                                           lambda x: model(x)[0])
        return outs, totals, [(p[2], p[3]) for p in payloads]

    def fetch_group(self, handle):
        outs, totals, metas = handle
        return [
            {self.feature_type: feats, "fps": np.array(fps), "timestamps_ms": np.array(ts)}
            for feats, (fps, ts) in zip(self._split_grouped_rows(outs, totals), metas)
        ]
