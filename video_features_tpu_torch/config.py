"""Typed configuration and the CLI's argument parser.

Counterpart of ``video_features_tpu/config.py`` (``ExtractionConfig``,
``sanity_check``, ``parse_batch_args``), cut to the fields the CLIP,
PWC and I3D paths read. Flag names, meanings and defaults are the JAX
package's.
"""

from __future__ import annotations

import argparse
import os
import re
from dataclasses import dataclass
from typing import List, Optional, Sequence

# the feature types this package extracts so far
CLIP_FEATURE_TYPES = ["CLIP-ViT-B/32", "CLIP-ViT-B/16", "CLIP4CLIP-ViT-B-32"]
FEATURE_TYPES = CLIP_FEATURE_TYPES + ["pwc", "i3d"]
STREAMS = ("rgb", "flow")
FLOW_TYPES = ("raft", "pwc", "flow")
# I3D flow sources the JAX package has and this package does not yet
FLOW_TYPES_TO_PORT = {
    "raft": "RAFT (ROADMAP.md queue 1, item 3)",
    "flow": "flow read from disk (ROADMAP.md queue 1, item 2)",
}
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
    # --- sampling: 'fix_<fps>' or 'uni_<N>' (CLIP); a target fps (pwc, i3d) ---
    extract_method: Optional[str] = None
    extraction_fps: Optional[float] = None
    # --- flow frames: optional PIL resize of each frame (pwc) ---
    side_size: Optional[int] = None
    resize_to_smaller_edge: bool = True
    # --- windows: B+1-frame flow windows (pwc) or B-stack groups (i3d) ---
    batch_size: int = 1
    # --- i3d: streams, flow model and stack_size+1-frame stacks every step_size ---
    streams: Optional[List[str]] = None
    flow_type: str = "pwc"
    stack_size: Optional[int] = None
    step_size: Optional[int] = None
    # --- weights: a CLIP or PWC state dict (.pt/.npz), or for i3d a
    # directory of i3d_rgb.pt / i3d_flow.pt / pwc_net_sintel.pt; without
    # them the run fails unless allow_random_init asks for seeded random
    # weights
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
    if cfg.feature_type not in FEATURE_TYPES:
        raise ValueError(
            f"unknown feature_type: {cfg.feature_type!r} (this package "
            f"extracts {', '.join(FEATURE_TYPES)})"
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
    if cfg.batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {cfg.batch_size}")
    if cfg.side_size is not None and cfg.side_size < 1:
        raise ValueError(f"side_size must be >= 1, got {cfg.side_size}")
    if cfg.extraction_fps is not None and not cfg.extraction_fps > 0:
        raise ValueError(f"extraction_fps must be > 0, got {cfg.extraction_fps}")
    if cfg.streams is not None and (not cfg.streams or set(cfg.streams) - set(STREAMS)):
        raise ValueError(f"streams must be a subset of {STREAMS}, got {cfg.streams}")
    if cfg.flow_type not in FLOW_TYPES:
        raise ValueError(f"unknown flow_type: {cfg.flow_type}")
    if cfg.feature_type == "i3d":
        if cfg.stack_size is not None and cfg.stack_size < 10:
            raise AssertionError(
                f"I3D does not support inputs shorter than 10 timestamps, got {cfg.stack_size}"
            )
        if cfg.step_size is not None and cfg.step_size < 1:
            raise ValueError(f"step_size must be >= 1, got {cfg.step_size}")
        if cfg.flow_type in FLOW_TYPES_TO_PORT and "flow" in (cfg.streams or STREAMS):
            raise ValueError(
                f"--flow_type {cfg.flow_type} is not ported yet: "
                f"{FLOW_TYPES_TO_PORT[cfg.flow_type]}; use --flow_type pwc"
            )
    if cfg.shape_buckets is not None and (
        not cfg.shape_buckets or any(b < 1 for b in cfg.shape_buckets)
    ):
        raise ValueError(f"shape_buckets must be positive ints, got {cfg.shape_buckets}")
    return cfg


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Extract video features (PyTorch/CUDA)")
    p.add_argument("--feature_type", required=True, choices=FEATURE_TYPES)
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
    p.add_argument("--extraction_fps", type=float,
                   help="frames per second to sample (pwc, i3d)")
    p.add_argument("--side_size", type=int,
                   help="PIL-resize each frame's smaller (or larger) edge to this (pwc)")
    p.add_argument("--resize_to_larger_edge", dest="resize_to_smaller_edge",
                   action="store_false", default=True)
    p.add_argument("--batch_size", type=int, default=1,
                   help="flow pairs per window (pwc) or stacks per group (i3d)")
    p.add_argument("--streams", nargs="+", choices=list(STREAMS))
    p.add_argument("--flow_type", choices=list(FLOW_TYPES), default="pwc")
    p.add_argument("--stack_size", type=int)
    p.add_argument("--step_size", type=int)
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
