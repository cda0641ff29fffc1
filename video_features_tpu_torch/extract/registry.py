"""Feature type -> extractor (counterpart of
``video_features_tpu/extract/registry.py``). Imports are lazy per type."""

from __future__ import annotations

from video_features_tpu_torch.config import CLIP_FEATURE_TYPES, ExtractionConfig


def build_extractor(cfg: ExtractionConfig, external_call: bool = False):
    if cfg.feature_type in CLIP_FEATURE_TYPES:
        from video_features_tpu_torch.models.clip.extract_clip import ExtractCLIP

        return ExtractCLIP(cfg, external_call)
    raise ValueError(f"unknown feature_type: {cfg.feature_type}")
