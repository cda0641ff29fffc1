"""Feature type -> extractor (counterpart of
``video_features_tpu/extract/registry.py``). Imports are lazy per type."""

from __future__ import annotations

from video_features_tpu_torch.config import (
    CLIP_FEATURE_TYPES,
    RESNET_FEATURE_TYPES,
    VGGISH_FEATURE_TYPES,
    ExtractionConfig,
)


def media_need_for(feature_type: str) -> str:
    """What the preflight probe must find in this feature type's input
    ('video' or 'audio'), without building the extractor: each extractor
    class's ``media_need``."""
    return "audio" if feature_type in VGGISH_FEATURE_TYPES else "video"


def build_extractor(cfg: ExtractionConfig, external_call: bool = False):
    if cfg.feature_type in CLIP_FEATURE_TYPES:
        from video_features_tpu_torch.models.clip.extract_clip import ExtractCLIP

        return ExtractCLIP(cfg, external_call)
    if cfg.feature_type in RESNET_FEATURE_TYPES:
        from video_features_tpu_torch.models.resnet.extract_resnet import ExtractResNet

        return ExtractResNet(cfg, external_call)
    if cfg.feature_type == "r21d_rgb":
        from video_features_tpu_torch.models.r21d.extract_r21d import ExtractR21D

        return ExtractR21D(cfg, external_call)
    if cfg.feature_type == "raft":
        from video_features_tpu_torch.models.raft.extract_raft import ExtractRAFT

        return ExtractRAFT(cfg, external_call)
    if cfg.feature_type == "pwc":
        from video_features_tpu_torch.models.pwc.extract_pwc import ExtractPWC

        return ExtractPWC(cfg, external_call)
    if cfg.feature_type == "i3d":
        from video_features_tpu_torch.models.i3d.extract_i3d import ExtractI3D

        return ExtractI3D(cfg, external_call)
    if cfg.feature_type in VGGISH_FEATURE_TYPES:
        from video_features_tpu_torch.models.vggish.extract_vggish import ExtractVGGish

        return ExtractVGGish(cfg, external_call)
    raise ValueError(f"unknown feature_type: {cfg.feature_type}")
