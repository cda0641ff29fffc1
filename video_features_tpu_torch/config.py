"""Typed configuration and the CLI's argument parser.

Counterpart of ``video_features_tpu/config.py`` (``ExtractionConfig``,
``sanity_check``, ``parse_batch_args``), cut to the fields the CLIP,
ResNet, R(2+1)D, RAFT, PWC, I3D and VGGish paths read, with the run
contract (manifest, retries, ``--strict``, ``--decode_workers``), the
async ingest loop (``--video_batch``, ``--inflight_groups``), the device
preprocess (``--preprocess``, ``--spatial_bucket``,
``--frame_delta_threshold``), the run telemetry (``--telemetry``,
``--heartbeat_s``, ``--profile_dir``) and the preflight probe with the
input caps (``--preflight``, ``--decode_timeout``, ``--max_pixels``,
``--max_duration_s``, ``--max_decode_bytes``), the host backends
``--decoder`` and ``--host_preprocess`` (``native/``), the numerics flag
``--dtype`` with its admission table, the input and output flags (flow
read from disk: ``--flow_type flow`` with ``--flow_paths`` or
``--video_dir``/``--flow_dir``; ``--on_extraction save_jpg``;
``--show_pred``; ``--fps_retarget``; ``--uint8_transfer``;
``--conv3d_impl``), the content-addressed feature
cache (``--cache_dir``, ``--cache_hash``), the shared-decode fan-out
(``--feature_types``, ``--ingest_cache_mb``), more than one device
(``--device_ids``, ``--sharding queue|mesh``, ``--mesh_model``,
``--mesh_context``; ``parallel/``) and the serve daemon's
``ServeConfig`` (``parse_serve_args``, ``sanity_check_serve``). Flag
names, meanings and defaults are the JAX package's. Serve's
``--hbm_budget_bytes`` (the warmup gate on the device cost ledger's
projection) and ``--preempt`` with its tuning flags
(``--preempt_cooldown_s``, ``--preempt_min_residency_s``) parse and
validate as the JAX package's do.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from video_features_tpu_torch.runtime.faults import parse_fault_specs

# the feature types this package extracts so far
CLIP_FEATURE_TYPES = ["CLIP-ViT-B/32", "CLIP-ViT-B/16", "CLIP4CLIP-ViT-B-32"]
RESNET_FEATURE_TYPES = [f"resnet{d}" for d in (18, 34, 50, 101, 152)]
VGGISH_FEATURE_TYPES = ["vggish", "vggish_torch"]
FEATURE_TYPES = (CLIP_FEATURE_TYPES + RESNET_FEATURE_TYPES + VGGISH_FEATURE_TYPES
                 + ["r21d_rgb", "raft", "pwc", "i3d"])
STREAMS = ("rgb", "flow")
FLOW_TYPES = ("raft", "pwc", "flow")
# the extractors whose dispatch honours --preprocess device: the image
# models (a fixed 224 crop), the flow models (InputPadder's or the exact
# grid) and I3D (min-edge-256 onto an output bucket); sanity_check names
# this set in its refusal
DEVICE_PREPROCESS_FEATURE_TYPES = CLIP_FEATURE_TYPES + RESNET_FEATURE_TYPES + ["raft", "pwc",
                                                                             "i3d"]
# the extractors whose --preprocess device path may run under --sharding
# mesh (the JAX package's list, so its refusal reads the same here): CLIP
# splits the raw frame batch over 'data', raft and pwc each window's frame
# axis and i3d each stack's, with the taps replicated on every row. The
# ResNet family runs mesh only on its host chain, as in the JAX package
MESH_DEVICE_PREPROCESS_FEATURE_TYPES = CLIP_FEATURE_TYPES + ["raft", "pwc", "i3d"]
PREPROCESS_MODES = ("host", "device")
DECODERS = ("auto", "cv2", "native")
HOST_PREPROCESS = ("pil", "native")
ATTN_CORES = ("fused", "flash", "blockwise")
ON_EXTRACTION = ("print", "save_numpy", "save_pickle", "save_jpg")
FPS_RETARGETS = ("nearest", "reencode")
CONV3D_IMPLS = ("auto", "direct", "decomposed")
DTYPES = ("float32", "bfloat16")

# --dtype admission: the model families whose low-precision graph has a
# committed relative-drift ceiling (PARITY_CEILINGS), each held end to end
# by a test; sanity_check refuses a low-precision dtype for any other
# family. VGGish stays fp32 only, as in the JAX package.
LOW_PRECISION_MODEL_FAMILIES = {
    "bfloat16": ("clip", "resnet", "r21d", "i3d", "raft", "pwc"),
}
# the ceilings: the largest relative L2 drift, ||low - fp32|| / ||fp32||
# in float64, that a (family, dtype, kind) may show against its fp32
# graph; kind "model" is one full-width forward on random weights, "e2e"
# an extraction end to end, "e2e_flow" I3D's flow stream with its flow
# net. The JAX package's committed max_rel values
# (analysis/parity_budget.json), copied so the port reads none of it.
PARITY_CEILINGS = {
    ("clip", "bfloat16", "e2e"): 0.03,
    ("clip", "bfloat16", "model"): 0.03,
    ("i3d", "bfloat16", "e2e_flow"): 0.05,
    ("i3d", "bfloat16", "model"): 0.03,
    ("pwc", "bfloat16", "e2e"): 0.05,
    ("pwc", "bfloat16", "model"): 0.02,
    ("r21d", "bfloat16", "model"): 0.03,
    ("raft", "bfloat16", "e2e"): 0.05,
    ("raft", "bfloat16", "model"): 0.02,
    ("resnet", "bfloat16", "model"): 0.03,
}


def model_family(feature_type: str) -> str:
    """The admission family of a feature type ('resnet50' -> 'resnet',
    'CLIP-ViT-B/16' -> 'clip', 'r21d_rgb' -> 'r21d')."""
    if feature_type in CLIP_FEATURE_TYPES:
        return "clip"
    if feature_type in RESNET_FEATURE_TYPES:
        return "resnet"
    if feature_type == "r21d_rgb":
        return "r21d"
    return feature_type


@dataclass
class ExtractionConfig:
    """All knobs for one extraction job."""

    feature_type: str = "CLIP-ViT-B/32"
    # --- input selection: videos, or (video, flow dir) pairs matched by
    # stem for I3D's --flow_type flow ---
    video_paths: Optional[List[str]] = None
    flow_paths: Optional[List[str]] = None
    file_with_video_paths: Optional[str] = None
    video_dir: Optional[str] = None
    flow_dir: Optional[str] = None
    # --- devices: the CUDA ids to run on (every visible device when None;
    # an id may repeat), or the CPU with --cpu (one device) ---
    device_ids: Optional[List[int]] = None
    cpu: bool = False
    # 'queue': one worker thread and model per device over a shared queue
    # of videos; 'mesh': one sharded forward over a (data, model) grid of
    # every selected device (parallel/)
    sharding: str = "queue"
    # the mesh's 'model' (tensor-parallel) axis size; 'data' gets the rest
    mesh_model: int = 1
    # --sharding mesh only: shard the transformer's tokens over 'data' and
    # run ring attention, the batch replicated (CLIP, --attn fused)
    mesh_context: bool = False
    # --- output ---
    tmp_path: str = "./tmp"
    # keep the wav/aac an audio rip leaves in tmp_path (vggish on a video)
    keep_tmp_files: bool = False
    on_extraction: str = "print"  # print | save_numpy | save_pickle | save_jpg
    output_path: str = "./output"
    output_direct: bool = False
    # --- sampling: 'fix_<fps>' or 'uni_<N>' (CLIP); a target fps (the rest) ---
    extract_method: Optional[str] = None
    extraction_fps: Optional[float] = None
    # how --extraction_fps retargets the frame grid (resnet*, raft, pwc):
    # 'nearest' picks frames of the source grid in-process; 'reencode' is
    # the reference's ffmpeg re-encode into tmp_path (needs ffmpeg)
    fps_retarget: str = "nearest"
    # --- flow frames: optional PIL resize of each frame (raft, pwc) ---
    side_size: Optional[int] = None
    resize_to_smaller_edge: bool = True
    # --- batches: B+1-frame flow windows (raft, pwc), B-frame batches
    # (resnet) or B-stack groups (i3d, r21d) ---
    batch_size: int = 1
    # --- i3d: streams, flow model (or 'flow': flow_x/flow_y JPEGs read
    # from disk) and stack_size+1-frame stacks every step_size; r21d:
    # stack_size-frame stacks every step_size ---
    streams: Optional[List[str]] = None
    flow_type: str = "pwc"
    stack_size: Optional[int] = None
    step_size: Optional[int] = None
    # --- weights: a CLIP, ResNet, R(2+1)D, RAFT, PWC or VGGish state dict
    # (.pt/.pth/.npz), or for i3d a directory of i3d_rgb.pt / i3d_flow.pt /
    # raft-sintel.pth / pwc_net_sintel.pt; without
    # them the run fails unless allow_random_init asks for seeded random
    # weights
    weights_path: Optional[str] = None
    allow_random_init: bool = False
    # --- attention core of the CLIP tower: 'fused' (plain matmuls),
    # 'flash' (the CUDA kernel, csrc/flash_attention.cu) or 'blockwise'
    # (the kernel's plain online-softmax version) ---
    attn: str = "fused"
    # numerics: 'float32', or 'bfloat16' for the mixed-precision graph of
    # an admitted family (LOW_PRECISION_MODEL_FAMILIES); features are
    # written fp32 either way
    dtype: str = "float32"
    # print the top-5 classes of each frame (resnet, ImageNet) or stack
    # (r21d, i3d: Kinetics-400), or show each flow pair over its frame
    # (raft, pwc)
    show_pred: bool = False
    # R(2+1)D's stacks cross to the device as uint8 ('on') or, cast on
    # the host, as float32 ('off'); the features are the same
    uint8_transfer: str = "on"
    # the 3D convolutions of i3d and r21d: 'direct' (cuDNN's conv3d),
    # 'decomposed' (a sum of 2D convolutions over strided time slices),
    # or 'auto' (VFT_CONV3D_IMPL, else direct)
    conv3d_impl: str = "auto"
    # skip videos whose output files already exist, or that an earlier
    # run's manifest records as permanently failed
    resume: bool = False
    # padded frame-batch sizes (ops/window.py::bucket_size)
    shape_buckets: Optional[List[int]] = None
    # --- the run contract (runtime/faults.py, extract/base.py) ---
    # host threads that decode and preprocess upcoming videos while the
    # device computes the current one; 0 runs decode and compute in turn
    decode_workers: int = 2
    # the decode backend (io/video.py): 'auto' opens the native libav
    # decoder (native/decoder.cpp) when its library builds and the file
    # opens in it, else cv2, per file; 'cv2' and 'native' force one
    decoder: str = "auto"
    # the host chain of CLIP (bicubic) and the ResNet family (bilinear)
    # under --preprocess host: 'pil' is the reference's; 'native' the
    # threaded C++ chains (native/preprocess.cpp, within ~1/255 per pixel
    # of PIL). An unavailable 'native' raises at setup. Other extractors
    # ignore it
    host_preprocess: str = "pil"
    # extra attempts for a transient (I/O) or oom failure, with backoff
    # retry_backoff * 2^(k-1) * jitter seconds before attempt k+1
    retries: int = 2
    retry_backoff: float = 0.5
    # exit nonzero when the run manifest records a failed video, an
    # empty-feature warning or a worker death
    strict: bool = False
    # with --resume: attempt again the videos recorded as permanently failed
    retry_failed: bool = False
    # test-only STAGE:KIND:EVERY_N fault injection (runtime/faults.py)
    fault_inject: Optional[List[str]] = None
    # wall-clock seconds a decode may take: a reader past it raises
    # DecodeTimeout (transient, so retried with a fresh deadline); None is off
    decode_timeout: Optional[float] = None
    # probe each input before its first attempt (io/probe.py): 'on' fails
    # a corrupt or hostile file permanent at stage 'preflight' with zero
    # retries and records the probe's warnings; 'off' leaves it to decode
    preflight: str = "on"
    # input caps, checked at preflight against the declared metadata and
    # again by the reader over the actual decode; over a cap is a
    # permanent ResourceCapExceeded; None is off
    max_pixels: Optional[int] = None  # one frame's width * height
    max_duration_s: Optional[float] = None  # declared / decoded clip length
    max_decode_bytes: Optional[int] = None  # RGB bytes one reader may yield
    # --- run telemetry (runtime/telemetry.py) ---
    # 'on': per-stage spans to <output>/_telemetry/spans-*.jsonl, metrics
    # snapshots, and a telemetry block in summary.json; 'off': the bare
    # per-stage timer
    telemetry: str = "on"
    # seconds between heartbeat progress lines on stderr during save runs;
    # 0 disables
    heartbeat_s: float = 30.0
    # write a torch.profiler trace (host and CUDA) of the run and print the
    # per-stage wall time (utils/profiling.py)
    profile_dir: Optional[str] = None
    # --- the async ingest loop (extract/base.py, extract/ingest.py) ---
    # fuse up to N prepared videos of one shape key into one device
    # dispatch (needs decode_workers >= 1); 1 is off
    video_batch: int = 1
    # dispatched videos or groups in flight before the loop blocks on the
    # oldest's fetch (2 double-buffers; 1 is dispatch-then-fetch lockstep)
    inflight_groups: int = 2
    # --- where the resize, crop and normalize run (ops/preprocess.py):
    # 'host' is the PIL chain on the decode threads; 'device' ships raw
    # uint8 frames, padded to a spatial bucket, and runs the PIL-semantics
    # banded resize, crop and normalize on the card ---
    preprocess: str = "host"
    # --preprocess device: each axis of a source resolution rounds up to a
    # multiple of this (ops/window.py::spatial_bucket), so videos of nearby
    # resolutions share one shape and fuse under --video_batch
    spatial_bucket: int = 64
    # CLIP only: a sampled frame whose mean |uint8 delta| against the last
    # kept frame is below this is not encoded; its row is copied from that
    # frame's (ops/sampler.py). None is off; 0 keeps every frame
    frame_delta_threshold: Optional[float] = None
    # --- the content-addressed feature cache (extract/cache.py): completed
    # features keyed by (content hash, config digest), reused as a file
    # copy on a repeat; None is off ---
    cache_dir: Optional[str] = None
    # 'fast' hashes size + head + sampled chunks + tail; 'full' every byte
    cache_hash: str = "fast"
    # byte budget (MiB) of the shared-decode frame cache of a multi-model
    # run (extract/plan.py); 0 is off
    ingest_cache_mb: int = 512

    @classmethod
    def from_namespace(cls, args: argparse.Namespace) -> "ExtractionConfig":
        """The config of a parsed command line: keys that are not fields
        (``--feature_types``, serve's flags) are dropped."""
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in vars(args).items() if k in known})

    def replace(self, **kw) -> "ExtractionConfig":
        return dataclasses.replace(self, **kw)


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
    if cfg.on_extraction == "save_jpg" and cfg.feature_type not in ("raft", "pwc"):
        raise ValueError(
            "save_jpg writes quantized flow JPEGs and only applies to "
            f"flow features (raft/pwc), not {cfg.feature_type!r}"
        )
    if cfg.show_pred:
        # predictions print per video (CLIP prints none, as in the JAX
        # package) and would interleave across workers: pin to one device
        cfg = cfg.replace(device_ids=[cfg.device_ids[0]] if cfg.device_ids else [0])
    if cfg.sharding not in ("queue", "mesh"):
        raise ValueError(f"unknown sharding strategy: {cfg.sharding}")
    if cfg.mesh_model < 1:
        raise ValueError(f"mesh_model must be >= 1, got {cfg.mesh_model}")
    if cfg.mesh_context and cfg.sharding != "mesh":
        raise ValueError("--mesh_context requires --sharding mesh")
    if cfg.dtype != "float32":
        fams = LOW_PRECISION_MODEL_FAMILIES.get(cfg.dtype)
        if fams is None:
            raise ValueError(f"unknown dtype: {cfg.dtype!r}")
        if model_family(cfg.feature_type) not in fams:
            raise ValueError(
                f"--dtype {cfg.dtype} is not admitted for {cfg.feature_type!r}: "
                "admission needs a committed drift ceiling (config.PARITY_CEILINGS) "
                "and an end-to-end parity test; the admitted families are "
                f"{', '.join(fams)}"
            )
    if cfg.attn not in ATTN_CORES:
        raise ValueError(f"unknown attn core: {cfg.attn}")
    if cfg.conv3d_impl not in CONV3D_IMPLS:
        raise ValueError(f"unknown conv3d_impl: {cfg.conv3d_impl}")
    if cfg.fps_retarget not in FPS_RETARGETS:
        raise ValueError(f"unknown fps_retarget: {cfg.fps_retarget}")
    if cfg.fps_retarget == "reencode" and not (
        cfg.feature_type in ("raft", "pwc") or cfg.feature_type in RESNET_FEATURE_TYPES
    ):
        raise ValueError(
            "--fps_retarget reencode mirrors the reference's ffmpeg fps "
            "path, which only exists for resnet*/raft/pwc; other extractors "
            f"sample their own grids (got {cfg.feature_type!r})"
        )
    if cfg.uint8_transfer not in ("on", "off"):
        raise ValueError(f"uint8_transfer must be 'on' or 'off', got {cfg.uint8_transfer!r}")
    for flag, val in (
        ("file_with_video_paths", cfg.file_with_video_paths),
        ("video_dir", cfg.video_dir),
        ("flow_dir", cfg.flow_dir),
        ("weights_path", cfg.weights_path),
        ("profile_dir", cfg.profile_dir),
    ):
        if val is not None and not str(val).strip():
            raise ValueError(f"--{flag} must be a non-empty path")
    for flag, paths in (("video_paths", cfg.video_paths), ("flow_paths", cfg.flow_paths)):
        if paths and any(not str(p).strip() for p in paths):
            raise ValueError(f"--{flag} contains an empty path")
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
    if cfg.feature_type in ("i3d", "r21d_rgb"):
        if cfg.step_size is not None and cfg.step_size < 1:
            raise ValueError(f"step_size must be >= 1, got {cfg.step_size}")
    if cfg.feature_type == "r21d_rgb" and cfg.stack_size is not None and cfg.stack_size < 1:
        raise ValueError(f"stack_size must be >= 1, got {cfg.stack_size}")
    if cfg.feature_type == "i3d":
        if cfg.stack_size is not None and cfg.stack_size < 10:
            raise AssertionError(
                f"I3D does not support inputs shorter than 10 timestamps, got {cfg.stack_size}"
            )
    if cfg.shape_buckets is not None and (
        not cfg.shape_buckets or any(b < 1 for b in cfg.shape_buckets)
    ):
        raise ValueError(f"shape_buckets must be positive ints, got {cfg.shape_buckets}")
    if cfg.retries < 0:
        raise ValueError(f"retries must be >= 0, got {cfg.retries}")
    if cfg.retry_backoff < 0:
        raise ValueError(f"retry_backoff must be >= 0, got {cfg.retry_backoff}")
    if cfg.decode_timeout is not None and cfg.decode_timeout <= 0:
        raise ValueError(f"decode_timeout must be > 0, got {cfg.decode_timeout}")
    if cfg.preflight not in ("on", "off"):
        raise ValueError(f"preflight must be 'on' or 'off', got {cfg.preflight!r}")
    if cfg.max_pixels is not None and cfg.max_pixels < 1:
        raise ValueError(f"max_pixels must be >= 1, got {cfg.max_pixels}")
    if cfg.max_duration_s is not None and cfg.max_duration_s <= 0:
        raise ValueError(f"max_duration_s must be > 0, got {cfg.max_duration_s}")
    if cfg.max_decode_bytes is not None and cfg.max_decode_bytes < 1:
        raise ValueError(
            f"max_decode_bytes must be >= 1, got {cfg.max_decode_bytes}"
        )
    if cfg.retry_failed and not cfg.resume:
        raise ValueError(
            "--retry_failed only modifies --resume (it re-attempts videos "
            "the manifest recorded as permanently failed); add --resume"
        )
    if cfg.video_batch < 1:
        raise ValueError(f"video_batch must be >= 1, got {cfg.video_batch}")
    if cfg.video_batch > 1 and int(cfg.decode_workers or 0) < 1:
        raise ValueError(
            "--video_batch needs the async pipeline: set --decode_workers "
            ">= 1 (aggregation groups prepared videos, and only "
            "_run_pipelined prepares ahead)"
        )
    if cfg.inflight_groups < 1:
        raise ValueError(
            f"inflight_groups must be >= 1, got {cfg.inflight_groups}"
        )
    if cfg.frame_delta_threshold is not None:
        if cfg.frame_delta_threshold < 0:
            raise ValueError(
                "frame_delta_threshold must be >= 0, got "
                f"{cfg.frame_delta_threshold}"
            )
        if cfg.feature_type not in CLIP_FEATURE_TYPES:
            supported = ", ".join(CLIP_FEATURE_TYPES)
            raise ValueError(
                "--frame_delta_threshold gates per-frame features with "
                "copy-forward fill, which is only sound for the "
                f"frame-level extractors: {supported} "
                f"(got {cfg.feature_type!r}; windowed/flow models mix "
                "frames across time)"
            )
    if cfg.preprocess not in PREPROCESS_MODES:
        raise ValueError(f"unknown preprocess mode: {cfg.preprocess}")
    if cfg.decoder not in DECODERS:
        raise ValueError(f"unknown decoder backend: {cfg.decoder!r}")
    if cfg.host_preprocess not in HOST_PREPROCESS:
        raise ValueError(f"unknown host_preprocess: {cfg.host_preprocess!r}")
    if cfg.preprocess == "device":
        if cfg.feature_type not in DEVICE_PREPROCESS_FEATURE_TYPES:
            supported = ", ".join(sorted(DEVICE_PREPROCESS_FEATURE_TYPES))
            raise ValueError(
                "--preprocess device currently covers: "
                f"{supported} (got {cfg.feature_type!r})"
            )
        if cfg.feature_type == "i3d" and cfg.flow_type == "flow":
            raise ValueError(
                "--preprocess device on i3d requires an on-the-fly flow "
                "model (--flow_type raft or pwc); pre-extracted disk flow "
                "keeps the host chain (frames arrive already resized)"
            )
        if cfg.show_pred and cfg.feature_type in ("raft", "pwc"):
            raise ValueError(
                "--show_pred draws flow onto host-resized frames, which "
                "--preprocess device never materializes for raft/pwc — "
                "drop one of the two flags"
            )
        if cfg.sharding == "mesh":
            if cfg.feature_type not in MESH_DEVICE_PREPROCESS_FEATURE_TYPES:
                supported = ", ".join(sorted(MESH_DEVICE_PREPROCESS_FEATURE_TYPES))
                raise ValueError(
                    "--preprocess device under --sharding mesh needs the "
                    "fused entry to declare its sharding contract (GC502); "
                    f"today that covers: {supported} "
                    f"(got {cfg.feature_type!r})"
                )
            if cfg.mesh_context:
                raise ValueError(
                    "--preprocess device shards the raw frame axis over "
                    "'data'; --mesh_context replicates the batch and "
                    "shards tokens in-model — the two layouts conflict, "
                    "drop one"
                )
    if cfg.spatial_bucket < 1:
        raise ValueError(f"spatial_bucket must be >= 1, got {cfg.spatial_bucket}")
    parse_fault_specs(cfg.fault_inject)  # raises naming the bad spec
    if cfg.telemetry not in ("on", "off"):
        raise ValueError(f"telemetry must be 'on' or 'off', got {cfg.telemetry!r}")
    if cfg.heartbeat_s < 0:
        raise ValueError(f"heartbeat_s must be >= 0, got {cfg.heartbeat_s}")
    if cfg.mesh_context and cfg.attn != "fused":
        raise ValueError(
            "--mesh_context injects the ring-attention core; it cannot "
            "combine with --attn flash/blockwise (ring already chunks KV "
            "blockwise per arriving shard)"
        )
    if cfg.cache_hash not in ("fast", "full"):
        raise ValueError(
            f"cache_hash must be 'fast' or 'full', got {cfg.cache_hash!r}"
        )
    if cfg.ingest_cache_mb < 0:
        raise ValueError(
            f"ingest_cache_mb must be >= 0, got {cfg.ingest_cache_mb}"
        )
    if cfg.cache_dir is not None and not str(cfg.cache_dir).strip():
        raise ValueError("--cache_dir must be a non-empty path")
    return cfg


def build_arg_parser(feature_required: bool = True) -> argparse.ArgumentParser:
    """The batch CLI's parser. Serve passes ``feature_required=False``:
    its feature type is per request, and it adds its own
    ``--feature_types`` (the resident models)."""
    p = argparse.ArgumentParser(description="Extract video features (PyTorch/CUDA)")
    p.add_argument("--feature_type", choices=FEATURE_TYPES)
    p.add_argument("--video_paths", nargs="+", help="space-separated paths to videos")
    p.add_argument("--flow_paths", nargs="+",
                   help="space-separated dirs of flow_x/flow_y JPEGs, paired with "
                        "--video_paths by stem (i3d --flow_type flow)")
    p.add_argument("--file_with_video_paths", help=".txt file where each line is a path")
    p.add_argument("--video_dir", type=str, help="dir of videos")
    p.add_argument("--flow_dir", type=str,
                   help="dir of optical flow of videos: "
                        "[flow_dir]/[video stem]/[flow_(x/y)_00000.jpg]")
    p.add_argument("--device_ids", type=int, nargs="+",
                   help="the CUDA device ids to run on (default: every visible "
                        "one; an id may repeat: two workers, or two mesh shards, "
                        "on one card)")
    p.add_argument("--sharding", default="queue", choices=["queue", "mesh"],
                   help="queue: one model and worker thread per device over a "
                        "shared queue of videos; mesh: one sharded forward over a "
                        "(data, model) mesh of all selected devices: data parallel "
                        "for CLIP (tensor parallel too), ResNet, R(2+1)D and VGGish; "
                        "the frame axis with halos for RAFT, PWC and I3D")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="tensor-parallel axis size of the --sharding mesh")
    p.add_argument("--mesh_context", action="store_true",
                   help="context parallelism under --sharding mesh: shard the "
                        "transformer token axis over the mesh and run ring "
                        "attention; composes with --mesh_model head sharding")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--tmp_path", default="./tmp")
    p.add_argument("--keep_tmp_files", action="store_true", default=False)
    p.add_argument("--on_extraction", default="print", choices=list(ON_EXTRACTION))
    p.add_argument("--output_path", default="./output")
    p.add_argument("--output_direct", action="store_true",
                   help="save as <stem>.npy instead of <stem>_<key>.npy")
    p.add_argument("--extract_method", type=str, help="e.g. fix_2 or uni_12")
    p.add_argument("--extraction_fps", type=float,
                   help="frames per second to sample (all but CLIP)")
    p.add_argument("--fps_retarget", default="nearest", choices=list(FPS_RETARGETS),
                   help="how --extraction_fps retargets the frame grid (resnet*, raft, "
                        "pwc): in-process nearest-frame selection (default), or the "
                        "reference's ffmpeg re-encode into --tmp_path")
    p.add_argument("--side_size", type=int,
                   help="PIL-resize each frame's smaller (or larger) edge to this "
                        "(raft, pwc)")
    p.add_argument("--resize_to_larger_edge", dest="resize_to_smaller_edge",
                   action="store_false", default=True)
    p.add_argument("--batch_size", type=int, default=1,
                   help="flow pairs per window (raft, pwc), frames per batch "
                        "(resnet) or stacks per group (i3d, r21d)")
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
    p.add_argument("--show_pred", action="store_true", default=False,
                   help="print the top-5 classes (resnet: ImageNet, r21d and i3d: "
                        "Kinetics-400), or show each flow pair over its frame (raft, pwc)")
    p.add_argument("--uint8_transfer", default="on", choices=["on", "off"],
                   help="'off' casts R(2+1)D's stacks to float32 on the host "
                        "before the H2D copy (the same features)")
    p.add_argument("--conv3d_impl", default="auto", choices=list(CONV3D_IMPLS),
                   help="the 3D convolutions of i3d and r21d: cuDNN's conv3d "
                        "(direct), or a sum of 2D convolutions over strided time "
                        "slices (decomposed); auto honours VFT_CONV3D_IMPL, else direct")
    p.add_argument("--dtype", default="float32", choices=list(DTYPES),
                   help="bfloat16: the mixed-precision graph (convs and matmuls in "
                        "bf16, norms, softmax, flow recurrences and heads in fp32; "
                        "clip, resnet*, r21d_rgb, i3d, raft, pwc); features stay fp32")
    p.add_argument("--resume", action="store_true", default=False,
                   help="skip videos whose outputs already exist or that the "
                        "manifest records as permanently failed")
    p.add_argument("--shape_buckets", type=int, nargs="+", default=None,
                   help="padded frame-batch sizes (default: multiples of 8)")
    p.add_argument("--decode_workers", type=int, default=2,
                   help="host threads decoding upcoming videos while the device "
                        "computes (0: decode and compute in turn)")
    p.add_argument("--decoder", default="auto", choices=list(DECODERS),
                   help="decode backend: the native libav decoder when it builds "
                        "and opens the file, else cv2 (auto); or force one")
    p.add_argument("--host_preprocess", default="pil", choices=list(HOST_PREPROCESS),
                   help="--preprocess host chain of clip and resnet*: PIL (the "
                        "reference's) or the threaded C++ chains (native)")
    p.add_argument("--retries", type=int, default=2,
                   help="retry budget per video for TRANSIENT failures (I/O "
                        "flakes, out of memory); backoff is exponential with "
                        "deterministic jitter")
    p.add_argument("--retry_backoff", type=float, default=0.5,
                   help="base retry backoff seconds (attempt k waits "
                        "base * 2^(k-1) * jitter)")
    p.add_argument("--strict", action="store_true", default=False,
                   help="exit nonzero if the run manifest records any failed "
                        "video, empty-feature warning, or worker death")
    p.add_argument("--retry_failed", action="store_true", default=False,
                   help="with --resume: re-attempt videos the manifest recorded "
                        "as permanently failed (default: skip them)")
    p.add_argument("--fault_inject", action="append", default=None,
                   metavar="STAGE:KIND:EVERY_N",
                   help="TEST-ONLY deterministic fault injection: raise/stall at "
                        "STAGE (decode|prepare|dispatch|sink, or a serve stage: "
                        "admission|serve_dispatch|extractor|tracker_write|"
                        "replica_kill|lease_stall) every N calls; KIND "
                        "in error|corrupt|hang|oom|compile|kill; repeatable")
    p.add_argument("--decode_timeout", type=float, default=None,
                   help="wall-clock seconds per decode before a DecodeTimeout "
                        "(transient -> retried with a fresh deadline)")
    p.add_argument("--preflight", choices=["on", "off"], default="on",
                   help="probe each input before its first attempt "
                        "(io/probe.py): hostile/corrupt media fails "
                        "permanent with the probe's reason and zero "
                        "retries; 'off' restores discover-at-decode")
    p.add_argument("--max_pixels", type=int, default=None,
                   help="reject/abort any input whose frames exceed this "
                        "many pixels (width*height) — checked against "
                        "declared metadata at preflight AND against "
                        "actual decoded frames")
    p.add_argument("--max_duration_s", type=float, default=None,
                   help="reject/abort any input longer than this many "
                        "seconds (declared at preflight; enforced again "
                        "over actual decode)")
    p.add_argument("--max_decode_bytes", type=int, default=None,
                   help="abort any single video whose decoded RGB bytes "
                        "exceed this budget (a lying frame_count/"
                        "resolution header cannot blow host RAM)")
    p.add_argument("--telemetry", choices=["on", "off"], default="on",
                   help="structured telemetry: per-stage spans to "
                        "<output>/_telemetry/spans-*.jsonl, metrics + "
                        "overlap-efficiency block in summary.json, and a "
                        "heartbeat progress line (default on)")
    p.add_argument("--heartbeat_s", type=float, default=30.0,
                   help="seconds between telemetry heartbeat lines "
                        "(videos/sec, decode fps, ETA) on stderr; 0 "
                        "disables")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace (host and CUDA, "
                        "Chrome-trace JSON) + stage timing summary")
    p.add_argument("--video_batch", type=int, default=1,
                   help="aggregate up to N videos' prepared batches into "
                        "one device dispatch (every feature type); 1 = off")
    p.add_argument("--inflight_groups", type=int, default=2,
                   help="async-ingest completion-queue depth: dispatched "
                        "groups that may stay in flight before the loop "
                        "blocks on the oldest fetch (2 = the classic "
                        "double-buffer; 1 = lockstep dispatch-then-fetch)")
    p.add_argument("--preprocess", default="host", choices=list(PREPROCESS_MODES),
                   help="where resize/crop/normalize run: 'host' (PIL on the "
                        "decode threads) or 'device' (raw uint8 frames, "
                        "PIL-semantics resize on the card; clip, resnet*, "
                        "raft, pwc, i3d)")
    p.add_argument("--spatial_bucket", type=int, default=64,
                   help="--preprocess device: pad each frame axis up to a "
                        "multiple of this")
    p.add_argument("--frame_delta_threshold", type=float, default=None,
                   help="CLIP: skip a sampled frame whose mean |uint8 delta| "
                        "vs the last kept frame is below this; its feature row "
                        "is copied forward (0 keeps every frame)")
    p.add_argument("--cache_dir", type=str, default=None,
                   help="content-addressed feature store root: completed "
                        "features keyed by (content hash, config digest) "
                        "are reused as a file copy instead of re-"
                        "extracting; omit to disable")
    p.add_argument("--cache_hash", choices=["fast", "full"], default="fast",
                   help="content hash mode: 'fast' samples head + spread "
                        "chunks + tail (default; never streams a huge "
                        "file), 'full' streams every byte")
    p.add_argument("--ingest_cache_mb", type=int, default=512,
                   help="byte budget (MiB) for the shared-decode frame "
                        "cache used by multi-model fan-out: decode each "
                        "clip once and serve all requested models from "
                        "the cached frames; 0 disables")
    if feature_required:
        # batch fan-out: the serve parser adds its own --feature_types in
        # the serve group, so this one only exists on the batch surface
        p.add_argument(
            "--feature_types", nargs="+", choices=FEATURE_TYPES,
            help="extract SEVERAL feature types in one run, decoding each "
                 "video once (shared-ingest fan-out, extract/plan.py); "
                 "alternative to --feature_type")
    return p


def parse_batch_args(
    argv: Optional[Sequence[str]] = None,
) -> Tuple[ExtractionConfig, List[str]]:
    """Parse the batch CLI into ``(config, feature_types)``. Exactly one
    of ``--feature_type`` / ``--feature_types`` is required; a multi-
    model list routes cli.py through the shared-ingest fan-out
    (extract/plan.py) — one decode per clip, every model served from it.
    The returned config carries the FIRST feature type; callers re-key
    with ``cfg.replace(feature_type=ft)`` per model."""
    p = build_arg_parser()
    args = p.parse_args(argv)
    fts = list(dict.fromkeys(
        args.feature_types or ([args.feature_type] if args.feature_type else [])
    ))
    if not fts:
        p.error("one of --feature_type or --feature_types is required")
    args.feature_type = fts[0]
    return sanity_check(ExtractionConfig.from_namespace(args)), fts


def parse_args(argv: Optional[Sequence[str]] = None) -> ExtractionConfig:
    cfg, _ = parse_batch_args(argv)
    return cfg


# ---------------------------------------------------------------------------
# serve mode (video_features_tpu_torch/serve/): the long-lived daemon's knobs
# ---------------------------------------------------------------------------

# every extraction flag the serve parser inherits still applies (device,
# dtype, weights, --preprocess device, telemetry...);
# ServeConfig only adds what a daemon needs on top: which models stay
# resident, the request sources, and the admission-control bounds.


@dataclass
class ServeConfig:
    """Knobs for ``python -m video_features_tpu_torch serve``."""

    extraction: ExtractionConfig
    # models kept resident; requests naming anything else are rejected
    feature_types: List[str] = field(default_factory=list)
    # HTTP source (port=None disables; port=0 binds ephemeral, for tests)
    host: str = "127.0.0.1"
    port: Optional[int] = None
    # spool source (air-gapped twin of the HTTP door; None disables)
    spool_dir: Optional[str] = None
    spool_poll_s: float = 0.5
    # admission control: coalescing deadline, fused group bound, and the
    # backpressure bound (reject/503 past max_queue admitted-not-terminal)
    max_batch_wait_ms: float = 50.0
    max_group_size: int = 8
    max_queue: int = 256
    # cross-key dispatch scheduling (serve/scheduler.py): EDF with
    # priority tiers and aging by default; "fifo" is the A/B baseline;
    # "edf-cost" additionally consults the online service-time model
    # (serve/costmodel.py) to demote infeasible groups and rank by
    # latest start time. default_slack_ms is the effective deadline
    # assigned to requests that declare none; aging_ms is one priority-
    # tier boost per that much queue wait (0 disables aging)
    scheduler: str = "edf"
    default_slack_ms: float = 30000.0
    aging_ms: float = 10000.0
    # rolling window for the SLO tracker behind /metrics, /v1/stats,
    # and the heartbeat's deadline-miss rate
    slo_window_s: float = 300.0
    # supervision (serve/supervisor.py): bound on one group's extraction
    # wall time (0 = unbounded), and the per-feature-type circuit
    # breaker (open after `threshold` consecutive group-level failures,
    # half-open probe after `cooldown_s`)
    group_timeout_s: float = 0.0
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 30.0
    # retention for <output>/_requests/: terminal records older than the
    # TTL or beyond the count bound are pruned every retention_sweep_s
    # (0 disables the background sweeper; startup still sweeps once)
    request_ttl_s: float = 86400.0
    max_request_records: int = 10000
    retention_sweep_s: float = 60.0
    # warmup preflight specs, each "<feature_type>:<W>x<H>"
    warmup: List[str] = field(default_factory=list)
    warmup_only: bool = False
    # fail warmup fast when the cost ledger's projected resident device
    # memory for the resident models exceeds this many bytes (0 = unlimited)
    hbm_budget_bytes: int = 0
    # HBM-aware preemption (serve/preemptor.py): "on" lets an
    # overcommitting burst evict the lowest-value resident extractor
    # instead of being rejected; hysteresis = one preemption per
    # cooldown + a min-residency guard on every victim
    preempt: str = "off"
    preempt_cooldown_s: float = 30.0
    preempt_min_residency_s: float = 60.0
    # fleet identity + spool work-stealing (serve/sources.py): replicas
    # sharing one spool/output claim via per-replica lease files; a
    # lease whose heartbeat is older than lease_timeout_s is stolen by
    # a survivor (0 disables stealing — single-replica behavior)
    replica_id: Optional[str] = None
    lease_timeout_s: float = 0.0
    # hit-rate-aware shedding: past this fraction of max_queue, likely-
    # cache-miss requests are shed first (0 disables; only acts when
    # the observed cache hit rate says hits are common enough to save
    # room for)
    shed_watermark: float = 0.0

    def warmup_pairs(self) -> List[tuple]:
        return [parse_warmup_spec(s) for s in self.warmup]

    def resolved_replica_id(self) -> str:
        """The configured ``--replica_id`` or a pid-derived default —
        stable for the life of the process, unique enough on one host;
        multi-host fleets should set it explicitly."""
        return self.replica_id or f"r{os.getpid()}"


def parse_warmup_spec(spec: str) -> tuple:
    """``"<feature_type>:<W>x<H>"`` -> ``(feature_type, W, H)``; raises
    ValueError naming the bad spec (feature types may contain ':'-free
    slashes like CLIP-ViT-B/32, so split on the LAST colon)."""
    ft, sep, shape = spec.rpartition(":")
    m = re.fullmatch(r"(\d+)x(\d+)", shape) if sep else None
    if not ft or m is None:
        raise ValueError(
            f"bad warmup spec {spec!r}: expected <feature_type>:<W>x<H>, "
            "e.g. CLIP-ViT-B/32:640x480"
        )
    if ft not in FEATURE_TYPES:
        raise ValueError(f"bad warmup spec {spec!r}: unknown feature_type {ft!r}")
    w, h = int(m.group(1)), int(m.group(2))
    if w < 16 or h < 16:
        raise ValueError(f"bad warmup spec {spec!r}: sides must be >= 16")
    return (ft, w, h)


def build_serve_arg_parser() -> argparse.ArgumentParser:
    """The extraction parser (feature type optional — it is per-request
    in serve mode) plus the daemon flags."""
    p = build_arg_parser(feature_required=False)
    p.description = "Run the long-lived extraction daemon"
    g = p.add_argument_group("serve")
    g.add_argument("--feature_types", nargs="+", choices=FEATURE_TYPES,
                   help="models to keep resident; requests naming "
                        "anything else are rejected (default: just "
                        "--feature_type)")
    g.add_argument("--host", default="127.0.0.1",
                   help="HTTP bind address (default loopback; put a real "
                        "proxy in front before exposing further)")
    g.add_argument("--port", type=int, default=None,
                   help="HTTP port (0 = ephemeral; omit to disable the "
                        "HTTP source)")
    g.add_argument("--spool_dir", type=str, default=None,
                   help="watched spool directory of request JSON files "
                        "(air-gapped source; omit to disable)")
    g.add_argument("--spool_poll_s", type=float, default=0.5,
                   help="spool poll interval in seconds")
    g.add_argument("--max_batch_wait_ms", type=float, default=50.0,
                   help="max milliseconds a request waits for same-"
                        "(feature_type, bucket) company before its group "
                        "dispatches anyway")
    g.add_argument("--max_group_size", type=int, default=8,
                   help="max requests fused into one --video_batch group")
    g.add_argument("--max_queue", type=int, default=256,
                   help="admission bound: requests admitted but not yet "
                        "terminal; past it new requests get 503/rejected")
    g.add_argument("--scheduler", choices=("edf", "fifo", "edf-cost"),
                   default="edf",
                   help="cross-key dispatch order: earliest-effective-"
                        "deadline-first with priority tiers and aging "
                        "(default), plain arrival order, or cost-aware "
                        "EDF that consults the online service-time "
                        "model to skip infeasible groups")
    g.add_argument("--default_slack_ms", type=float, default=30000.0,
                   help="effective deadline assigned to requests that "
                        "declare no deadline_ms (EDF ranking only; "
                        "never expires a request)")
    g.add_argument("--aging_ms", type=float, default=10000.0,
                   help="one priority-tier boost per this much queue "
                        "wait, so low-priority work cannot starve "
                        "(0 disables aging)")
    g.add_argument("--slo_window_s", type=float, default=300.0,
                   help="rolling window (seconds) for the SLO tracker's "
                        "latency quantiles and deadline-miss rate "
                        "(/metrics, /v1/stats, heartbeat)")
    g.add_argument("--group_timeout_s", type=float, default=0.0,
                   help="watchdog bound on one group's extraction wall "
                        "time; on timeout the group fails transient and "
                        "the extractor is rebuilt (0 = unbounded)")
    g.add_argument("--breaker_threshold", type=int, default=3,
                   help="consecutive group-level failures that open a "
                        "feature type's circuit breaker (503 for that "
                        "model only)")
    g.add_argument("--breaker_cooldown_s", type=float, default=30.0,
                   help="seconds an open breaker waits before admitting "
                        "one half-open probe group")
    g.add_argument("--request_ttl_s", type=float, default=86400.0,
                   help="terminal request records older than this are "
                        "pruned from <output>/_requests/")
    g.add_argument("--max_request_records", type=int, default=10000,
                   help="keep at most this many terminal request "
                        "records (oldest pruned first)")
    g.add_argument("--retention_sweep_s", type=float, default=60.0,
                   help="how often the retention sweeper runs "
                        "(0 disables it; startup still sweeps once)")
    g.add_argument("--warmup", action="append", default=None,
                   metavar="FEATURE_TYPE:WxH",
                   help="load this model and run a synthetic clip of this "
                        "resolution through it before accepting traffic "
                        "(weights, cuDNN algorithms, allocator); repeatable")
    g.add_argument("--hbm_budget_bytes", type=int, default=0,
                   help="fail warmup when the cost ledger projects the "
                        "resident models' device-memory footprint past "
                        "this many bytes (0 = unlimited)")
    g.add_argument("--preempt", choices=("on", "off"), default="off",
                   help="HBM-aware preemption: a burst whose ledger-"
                        "projected footprint cannot fit evicts the "
                        "lowest-value resident extractor (breaker "
                        "teardown + re-warm) instead of being rejected")
    g.add_argument("--preempt_cooldown_s", type=float, default=30.0,
                   help="minimum seconds between preemptions (hysteresis "
                        "so two bursts cannot thrash-evict each other)")
    g.add_argument("--preempt_min_residency_s", type=float, default=60.0,
                   help="a resident extractor younger than this is never "
                        "chosen as a preemption victim")
    g.add_argument("--replica_id", type=str, default=None,
                   help="this replica's stable identity in a multi-"
                        "replica fleet sharing one spool + output store "
                        "(default: pid-derived; set explicitly across "
                        "hosts)")
    g.add_argument("--lease_timeout_s", type=float, default=0.0,
                   help="spool claims become per-replica leases; a lease "
                        "whose heartbeat is older than this is stolen by "
                        "a surviving replica (0 disables work-stealing)")
    g.add_argument("--shed_watermark", type=float, default=0.0,
                   help="queue-saturation fraction of --max_queue past "
                        "which likely-cache-miss requests are shed first "
                        "(cache hits are ~ms and are never shed; 0 "
                        "disables)")
    return p


def parse_serve_args(argv: Optional[Sequence[str]] = None) -> ServeConfig:
    """Parse ``serve [warmup] <flags>`` into a validated ServeConfig.
    A leading bare ``warmup`` token selects preflight-only mode (run the
    declared warmup pairs, then exit)."""
    argv = list(argv if argv is not None else [])
    warmup_only = bool(argv) and argv[0] == "warmup"
    if warmup_only:
        argv = argv[1:]
    args = build_serve_arg_parser().parse_args(argv)
    feature_types = args.feature_types or [args.feature_type or ExtractionConfig.feature_type]
    args.feature_type = feature_types[0]
    cfg = ExtractionConfig.from_namespace(args)
    cfg = sanity_check(cfg.replace(feature_type=feature_types[0]))
    scfg = ServeConfig(
        extraction=cfg,
        feature_types=list(dict.fromkeys(feature_types)),
        host=args.host,
        port=args.port,
        spool_dir=args.spool_dir,
        spool_poll_s=args.spool_poll_s,
        max_batch_wait_ms=args.max_batch_wait_ms,
        max_group_size=args.max_group_size,
        max_queue=args.max_queue,
        scheduler=args.scheduler,
        default_slack_ms=args.default_slack_ms,
        aging_ms=args.aging_ms,
        slo_window_s=args.slo_window_s,
        group_timeout_s=args.group_timeout_s,
        breaker_threshold=args.breaker_threshold,
        breaker_cooldown_s=args.breaker_cooldown_s,
        request_ttl_s=args.request_ttl_s,
        max_request_records=args.max_request_records,
        retention_sweep_s=args.retention_sweep_s,
        warmup=list(args.warmup or []),
        warmup_only=warmup_only,
        hbm_budget_bytes=args.hbm_budget_bytes,
        preempt=args.preempt,
        preempt_cooldown_s=args.preempt_cooldown_s,
        preempt_min_residency_s=args.preempt_min_residency_s,
        replica_id=args.replica_id,
        lease_timeout_s=args.lease_timeout_s,
        shed_watermark=args.shed_watermark,
    )
    return sanity_check_serve(scfg)


def sanity_check_serve(scfg: ServeConfig) -> ServeConfig:
    if not scfg.feature_types:
        raise ValueError("serve needs at least one --feature_types entry")
    for ft in scfg.feature_types:
        if ft not in FEATURE_TYPES:
            raise ValueError(f"unknown feature_type in --feature_types: {ft!r}")
        # fail at startup, not on the first request of that type
        sanity_check(scfg.extraction.replace(feature_type=ft))
    if not str(scfg.host).strip():
        raise ValueError("--host must be a non-empty bind address")
    if scfg.spool_dir is not None and not str(scfg.spool_dir).strip():
        raise ValueError("--spool_dir must be a non-empty path")
    if scfg.max_group_size < 1:
        raise ValueError(f"max_group_size must be >= 1, got {scfg.max_group_size}")
    if scfg.max_queue < 1:
        raise ValueError(f"max_queue must be >= 1, got {scfg.max_queue}")
    if scfg.max_batch_wait_ms < 0:
        raise ValueError(f"max_batch_wait_ms must be >= 0, got {scfg.max_batch_wait_ms}")
    if scfg.spool_poll_s <= 0:
        raise ValueError(f"spool_poll_s must be > 0, got {scfg.spool_poll_s}")
    if scfg.scheduler not in ("edf", "fifo", "edf-cost"):
        raise ValueError(
            f"scheduler must be 'edf', 'fifo', or 'edf-cost', got {scfg.scheduler!r}"
        )
    if scfg.default_slack_ms <= 0:
        raise ValueError(f"default_slack_ms must be > 0, got {scfg.default_slack_ms}")
    if scfg.aging_ms < 0:
        raise ValueError(f"aging_ms must be >= 0, got {scfg.aging_ms}")
    if scfg.slo_window_s <= 0:
        raise ValueError(f"slo_window_s must be > 0, got {scfg.slo_window_s}")
    if scfg.group_timeout_s < 0:
        raise ValueError(f"group_timeout_s must be >= 0, got {scfg.group_timeout_s}")
    if scfg.breaker_threshold < 1:
        raise ValueError(f"breaker_threshold must be >= 1, got {scfg.breaker_threshold}")
    if scfg.breaker_cooldown_s < 0:
        raise ValueError(f"breaker_cooldown_s must be >= 0, got {scfg.breaker_cooldown_s}")
    if scfg.request_ttl_s <= 0:
        raise ValueError(f"request_ttl_s must be > 0, got {scfg.request_ttl_s}")
    if scfg.max_request_records < 1:
        raise ValueError(f"max_request_records must be >= 1, got {scfg.max_request_records}")
    if scfg.retention_sweep_s < 0:
        raise ValueError(f"retention_sweep_s must be >= 0, got {scfg.retention_sweep_s}")
    if scfg.hbm_budget_bytes < 0:
        raise ValueError(f"hbm_budget_bytes must be >= 0, got {scfg.hbm_budget_bytes}")
    if scfg.preempt not in ("on", "off"):
        raise ValueError(f"preempt must be 'on' or 'off', got {scfg.preempt!r}")
    if scfg.preempt_cooldown_s < 0:
        raise ValueError(
            f"preempt_cooldown_s must be >= 0, got {scfg.preempt_cooldown_s}")
    if scfg.preempt_min_residency_s < 0:
        raise ValueError(
            "preempt_min_residency_s must be >= 0, got "
            f"{scfg.preempt_min_residency_s}")
    if scfg.replica_id is not None and not re.fullmatch(
            r"[A-Za-z0-9][A-Za-z0-9._-]{0,63}", scfg.replica_id):
        # replica ids become claim-file suffixes and heartbeat filenames
        raise ValueError(
            "replica_id must be 1-64 chars of [A-Za-z0-9._-] starting "
            f"alphanumeric, got {scfg.replica_id!r}")
    if scfg.lease_timeout_s < 0:
        raise ValueError(
            f"lease_timeout_s must be >= 0, got {scfg.lease_timeout_s}")
    if not 0 <= scfg.shed_watermark <= 1:
        raise ValueError(
            f"shed_watermark must be in [0, 1], got {scfg.shed_watermark}")
    scfg.warmup_pairs()  # raises naming any bad spec
    if scfg.warmup_only and not scfg.warmup:
        raise ValueError("serve warmup needs at least one --warmup FEATURE_TYPE:WxH")
    if scfg.extraction.on_extraction not in ("save_numpy", "save_pickle"):
        # the daemon's unit of output is a result file per request;
        # 'print' has nothing durable to point the status record at
        scfg = dataclasses.replace(
            scfg, extraction=scfg.extraction.replace(on_extraction="save_numpy")
        )
    for ft, w, h in scfg.warmup_pairs():
        if ft not in scfg.feature_types:
            raise ValueError(
                f"--warmup {ft}:{w}x{h} names a feature_type not in "
                f"--feature_types ({', '.join(scfg.feature_types)})"
            )
    return scfg
