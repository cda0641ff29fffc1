"""Typed configuration and the CLI's argument parser.

Counterpart of ``video_features_tpu/config.py`` (``ExtractionConfig``,
``sanity_check``, ``parse_batch_args``), cut to the fields the CLIP path
reads. Flag names and meanings are the JAX package's.
"""

from __future__ import annotations

import argparse
import os
import re
from dataclasses import dataclass
from typing import List, Optional, Sequence

# the feature types this package extracts so far
CLIP_FEATURE_TYPES = ["CLIP-ViT-B/32", "CLIP-ViT-B/16", "CLIP4CLIP-ViT-B-32"]
ATTN_CORES = ("fused", "flash", "blockwise")
ON_EXTRACTION = ("print", "save_numpy", "save_pickle")


@dataclass
class ExtractionConfig:
    """All knobs for one extraction job."""

    feature_type: str = "CLIP-ViT-B/32"
    # --- input selection ---
    video_paths: Optional[List[str]] = None
    file_with_video_paths: Optional[str] = None
    # --- devices: cuda:<device_ids[0]>, or the CPU with --cpu ---
    device_ids: Optional[List[int]] = None
    cpu: bool = False
    # --- output ---
    tmp_path: str = "./tmp"
    on_extraction: str = "print"  # print | save_numpy | save_pickle
    output_path: str = "./output"
    output_direct: bool = False
    # --- sampling: 'fix_<fps>' or 'uni_<N>' ---
    extract_method: Optional[str] = None
    # --- weights: an OpenAI / HF CLIP state dict (.pt/.npz); without one
    # the run fails unless allow_random_init asks for seeded random weights
    weights_path: Optional[str] = None
    allow_random_init: bool = False
    # --- attention core of the CLIP tower: 'fused' (plain matmuls),
    # 'flash' (the CUDA kernel, csrc/flash_attention.cu) or 'blockwise'
    # (the kernel's plain online-softmax version) ---
    attn: str = "fused"
    # skip videos whose output files already exist
    resume: bool = False
    # padded frame-batch sizes (ops/window.py::bucket_size)
    shape_buckets: Optional[List[int]] = None


def sanity_check(cfg: ExtractionConfig) -> ExtractionConfig:
    """Cross-field validation, as the JAX package's ``sanity_check``."""
    if os.path.relpath(cfg.output_path) == os.path.relpath(cfg.tmp_path):
        raise AssertionError("The same path for out & tmp")
    if cfg.feature_type not in CLIP_FEATURE_TYPES:
        raise ValueError(
            f"unknown feature_type: {cfg.feature_type!r} (this package "
            f"extracts {', '.join(CLIP_FEATURE_TYPES)})"
        )
    if cfg.on_extraction not in ON_EXTRACTION:
        raise ValueError(f"unknown on_extraction: {cfg.on_extraction}")
    if cfg.attn not in ATTN_CORES:
        raise ValueError(f"unknown attn core: {cfg.attn}")
    for flag, val in (
        ("file_with_video_paths", cfg.file_with_video_paths),
        ("weights_path", cfg.weights_path),
    ):
        if val is not None and not str(val).strip():
            raise ValueError(f"--{flag} must be a non-empty path")
    if cfg.video_paths and any(not str(p).strip() for p in cfg.video_paths):
        raise ValueError("--video_paths contains an empty path")
    if cfg.extract_method is not None and not re.fullmatch(
        r"(uni|fix)_[0-9]+", cfg.extract_method
    ):
        raise ValueError(
            "extract_method must look like uni_<N> or fix_<fps>, got "
            f"{cfg.extract_method!r}"
        )
    if cfg.shape_buckets is not None and (
        not cfg.shape_buckets or any(b < 1 for b in cfg.shape_buckets)
    ):
        raise ValueError(f"shape_buckets must be positive ints, got {cfg.shape_buckets}")
    return cfg


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Extract video features (PyTorch/CUDA)")
    p.add_argument("--feature_type", required=True, choices=CLIP_FEATURE_TYPES)
    p.add_argument("--video_paths", nargs="+", help="space-separated paths to videos")
    p.add_argument("--file_with_video_paths", help=".txt file where each line is a path")
    p.add_argument("--device_ids", type=int, nargs="+",
                   help="CUDA device ids; the run uses the first")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--tmp_path", default="./tmp")
    p.add_argument("--on_extraction", default="print", choices=list(ON_EXTRACTION))
    p.add_argument("--output_path", default="./output")
    p.add_argument("--output_direct", action="store_true",
                   help="save as <stem>.npy instead of <stem>_<key>.npy")
    p.add_argument("--extract_method", type=str, help="e.g. fix_2 or uni_12")
    p.add_argument("--weights_path", type=str, default=None)
    p.add_argument("--allow_random_init", action="store_true", default=False,
                   help="run with seeded random weights when --weights_path is "
                        "absent (features are meaningless; for tests and "
                        "benchmarks)")
    p.add_argument("--attn", default="fused", choices=list(ATTN_CORES),
                   help="attention core of the CLIP tower: fused matmuls "
                        "(default), the CUDA flash kernel, or its plain "
                        "blockwise version")
    p.add_argument("--resume", action="store_true", default=False,
                   help="skip videos whose outputs already exist")
    p.add_argument("--shape_buckets", type=int, nargs="+", default=None,
                   help="padded frame-batch sizes (default: multiples of 8)")
    return p


def parse_args(argv: Optional[Sequence[str]] = None) -> ExtractionConfig:
    # every flag's dest is a field of the config
    return sanity_check(ExtractionConfig(**vars(build_arg_parser().parse_args(argv))))
