"""CLIP frame-feature extractor.

Counterpart of ``video_features_tpu/models/clip/extract_clip.py``. Per
video: ``fix_N`` / ``uni_N`` frame sampling -> PIL bicubic resize, center
crop and CLIP normalisation on the host (byte-identical to the JAX
package) -> zero-pad to the bucketed batch -> ``encode_image`` on the
device under ``torch.inference_mode()`` -> the first T rows, with
``{feature_type, fps, timestamps_ms}``. ``--attn`` picks the attention
core: fused matmuls, the CUDA flash kernel, or its blockwise version.
With ``--video_batch N`` the batches of N videos of one bucket run as one
forward. Not ported yet: the ``--preprocess device`` payloads of the JAX
hooks and the ``--frame_delta_threshold`` kept rows (ROADMAP queue 1,
item 7).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from PIL import Image

from video_features_tpu_torch.config import ExtractionConfig
from video_features_tpu_torch.extract.base import BaseExtractor, device_of
from video_features_tpu_torch.extract.ingest import HostCopy, StagedGroup, place_batch
from video_features_tpu_torch.io.paths import video_path_of
from video_features_tpu_torch.io.video import extract_frames
from video_features_tpu_torch.models.clip.convert import convert_state_dict
from video_features_tpu_torch.models.clip.model import CONFIGS, VisionTransformer, init_weights
from video_features_tpu_torch.models.common.weights import (
    load_state_dict,
    random_init_fallback,
)
from video_features_tpu_torch.ops.attention import attention, blockwise_attention
from video_features_tpu_torch.ops.flash_attention import flash_attention
from video_features_tpu_torch.ops.preprocess import (
    CLIP_MEAN,
    CLIP_STD,
    normalize_chw,
    pil_center_crop,
    pil_resize,
    to_float_chw,
)
from video_features_tpu_torch.ops.window import bucket_size, pad_batch

CORES = {"fused": attention, "flash": flash_attention, "blockwise": blockwise_attention}


class ExtractCLIP(BaseExtractor):
    def __init__(self, config: ExtractionConfig, external_call: bool = False) -> None:
        super().__init__(config, external_call)
        if self.config.extract_method is None:
            raise ValueError("CLIP extraction needs --extract_method (e.g. uni_12 or fix_2)")
        self.model_cfg = CONFIGS[self.feature_type]

    def _build(self, device: torch.device) -> VisionTransformer:
        model = VisionTransformer(self.model_cfg, core=CORES[self.config.attn])
        if self.config.weights_path:
            sd = convert_state_dict(
                load_state_dict(self.config.weights_path), self.model_cfg.layers
            )
            model.load_state_dict(sd)
        else:
            random_init_fallback(
                self.config, self.feature_type,
                "an OpenAI CLIP / HF CLIP-vision state dict (.pt/.npz)",
            )
            init_weights(model, seed=0)
        return model.to(device).eval()

    def _preprocess(self, frame: np.ndarray) -> np.ndarray:
        size = self.model_cfg.image_size
        img = pil_center_crop(pil_resize(frame, size, interpolation=Image.BICUBIC), size)
        return normalize_chw(to_float_chw(img), CLIP_MEAN, CLIP_STD)

    def prepare(self, entry):
        """Host half: (padded (T_pad, 3, S, S) batch, T, fps, timestamps)."""
        frames, fps, timestamps_ms = extract_frames(
            video_path_of(entry), self.config.extract_method
        )
        batch = np.stack([self._preprocess(f) for f in frames])
        T = batch.shape[0]
        padded = pad_batch(batch, bucket_size(T, buckets=self.config.shape_buckets))
        return padded, T, fps, timestamps_ms

    # --- the device half, split (extract/base.py): H2D, forward and D2H
    # enqueued at dispatch, waited for at fetch
    def dispatch_prepared(self, model: VisionTransformer, payload):
        padded, T, fps, timestamps_ms = payload
        with torch.inference_mode():
            out = model(place_batch(padded, device_of(model)))
            return HostCopy(out[:T]), fps, timestamps_ms

    def fetch_dispatched(self, handle) -> Dict[str, np.ndarray]:
        out, fps, timestamps_ms = handle
        return {
            self.feature_type: out.numpy(),
            "fps": np.array(fps),
            "timestamps_ms": np.array(timestamps_ms),
        }

    # --- cross-video aggregation (--video_batch): N videos' bucketed
    # batches concatenate into one (N * bucket)-image forward, and the
    # features slice apart per video at fetch. A lone uni_12 batch is 16
    # images; the fused batch is what fills the card. Above AGG_MAX_FRAMES
    # sampled frames (fix_N over a long video) a video dispatches alone:
    # N - 1 such payloads waiting on the host plus an N-fold transfer is
    # the shape the cap exists to avoid.
    AGG_MAX_FRAMES = 256

    def agg_key(self, payload):
        head = payload[0]
        if head.shape[0] > self.AGG_MAX_FRAMES:
            return None
        return head.shape  # the bucketed (T_pad, 3, S, S)

    def transfer_group(self, model: VisionTransformer, payloads):
        """The group's H2D: the videos' batches concatenated and placed
        now, so the next group's copy overlaps this group's forward. A
        partial group is not padded to the full group's size: eager
        PyTorch compiles no shape, and each video's rows are its own."""
        bucket = payloads[0][0].shape[0]
        x = np.concatenate([p[0] for p in payloads], axis=0)
        metas = [(i * bucket, T, fps, ts) for i, (_, T, fps, ts) in enumerate(payloads)]
        return StagedGroup((place_batch(x, device_of(model)),), metas)

    def dispatch_group(self, model: VisionTransformer, payloads):
        if not isinstance(payloads, StagedGroup):
            payloads = self.transfer_group(model, payloads)
        with torch.inference_mode():
            out = model(payloads.arrays[0])
            return HostCopy(out), payloads.metas

    def fetch_group(self, handle):
        out, metas = handle
        arr = out.numpy()
        return [
            {
                self.feature_type: arr[off : off + T],
                "fps": np.array(fps),
                "timestamps_ms": np.array(ts),
            }
            for off, T, fps, ts in metas
        ]
