"""CLIP frame-feature extractor.

Counterpart of ``video_features_tpu/models/clip/extract_clip.py``. Per
video: ``fix_N`` / ``uni_N`` frame sampling -> PIL bicubic resize, center
crop and CLIP normalisation on the host (byte-identical to the JAX
package) -> zero-pad to the bucketed batch -> ``encode_image`` on the
device under ``torch.inference_mode()`` -> the first T rows, with
``{feature_type, fps, timestamps_ms}``. ``--attn`` picks the attention
core: fused matmuls, the CUDA flash kernel, or its blockwise version.
With ``--video_batch N`` the batches of N videos of one bucket run as one
forward.

``--preprocess device``: ``prepare`` ships the raw uint8 frames, padded
to the time bucket and the spatial bucket, with the banded bicubic
resize+crop taps of their source resolution
(``ops/resize.py::fused_resize_crop_banded``); the dispatch resizes,
crops and normalizes on the device (``device_preprocess_frames``) before
the tower. Videos of one (T_pad, bucket) shape fuse under
``--video_batch`` whatever their source resolution, each with its own
taps. ``--frame_delta_threshold``: near-duplicate sampled frames are
dropped in ``prepare`` (``ops/sampler.py``) and their rows copied forward
at fetch.

``--host_preprocess native`` (under ``--preprocess host``): the sampled
frames go through the C++ bicubic chain in one threaded call
(``native.clip_preprocess_batch``, within ~1/255 per pixel of PIL)
instead of PIL frame by frame. ``--decoder`` picks the decode backend.

``--dtype bfloat16``: the tower's bf16 graph (``models/clip/model.py``),
its weights cast after loading with ``proj`` kept fp32. The host batch
is rounded to bf16 on the decode thread (``Tensor.to``: round to nearest
even, as the JAX package's ``ml_dtypes`` cast; the patch conv would
round it there anyway), which halves its transfer; the device
preprocess returns bf16. Features are fp32.

``--sharding mesh`` (``parallel/``): the state is a
``ShardedVisionTransformer`` over the mesh. The padded frame batch
splits over the ``data`` rows (``--preprocess device``: the uint8 frames
split, the taps replicated on each row), each block runs Megatron-sharded
over ``--mesh_model``, and the rows gather onto the first device before
the copy to the host. Under ``--mesh_context`` the batch is replicated
and the patch tokens shard inside attention (ring attention).
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch
from PIL import Image

from video_features_tpu_torch.config import ExtractionConfig
from video_features_tpu_torch.extract.base import BaseExtractor, device_of
from video_features_tpu_torch.extract.ingest import (
    HostCopy,
    StagedGroup,
    place_batch,
    stack_taps,
)
from video_features_tpu_torch.io.paths import video_path_of
from video_features_tpu_torch.io.video import extract_frames
from video_features_tpu_torch.models.clip.convert import convert_state_dict, params_from_jax
from video_features_tpu_torch.models.clip.model import (
    CONFIGS,
    FP32_PARAMS,
    ShardedVisionTransformer,
    VisionTransformer,
    init_weights,
)
from video_features_tpu_torch.models.common.weights import (
    cast_for_compute,
    compute_dtype,
    load_params,
    random_init_fallback,
)
from video_features_tpu_torch.ops.attention import attention, blockwise_attention
from video_features_tpu_torch.ops.flash_attention import flash_attention
from video_features_tpu_torch.ops.preprocess import (
    CLIP_MEAN,
    CLIP_STD,
    device_preprocess_frames,
    normalize_chw,
    pil_center_crop,
    pil_resize,
    to_float_chw,
)
from video_features_tpu_torch.ops.resize import fused_resize_crop_banded
from video_features_tpu_torch.ops.sampler import copy_forward, frame_delta_keep_mask
from video_features_tpu_torch.ops.window import bucket_size, pad_batch, pad_hw, spatial_bucket

CORES = {"fused": attention, "flash": flash_attention, "blockwise": blockwise_attention}


class ExtractCLIP(BaseExtractor):
    # --sharding mesh: data parallel over the frame batch, Megatron tensor
    # parallel over --mesh_model, ring attention over the patch tokens
    # under --mesh_context (parallel/scheduler.py reads these)
    mesh_capable = True
    mesh_tp_capable = True
    mesh_context_capable = True

    def __init__(self, config: ExtractionConfig, external_call: bool = False) -> None:
        super().__init__(config, external_call)
        if self.config.extract_method is None:
            raise ValueError("CLIP extraction needs --extract_method (e.g. uni_12 or fix_2)")
        self.model_cfg = CONFIGS[self.feature_type]
        self.dtype = compute_dtype(self.config)
        self._native_decided()  # an unavailable --host_preprocess native fails here

    def _build(self, device):
        """The tower on ``device``; on a mesh, built on its first device and
        sharded over the mesh (``ShardedVisionTransformer``)."""
        from video_features_tpu_torch.parallel.sharding import is_mesh

        if is_mesh(device):
            model = self._build(device.devices[0, 0])
            return ShardedVisionTransformer(model, device, core=CORES[self.config.attn],
                                            context=self.config.mesh_context)
        model = VisionTransformer(self.model_cfg, core=CORES[self.config.attn])
        if self.config.weights_path:
            model.load_state_dict(load_params(
                self.config.weights_path,
                functools.partial(convert_state_dict, layers=self.model_cfg.layers),
                params_from_jax))
        else:
            random_init_fallback(
                self.config, self.feature_type,
                "an OpenAI CLIP / HF CLIP-vision state dict (.pt/.npz), or its converted "
                ".msgpack / orbax directory",
            )
            init_weights(model, seed=0)
        return cast_for_compute(model.to(device).eval(), self.dtype, exclude=FP32_PARAMS)

    def _preprocess(self, frame: np.ndarray) -> np.ndarray:
        size = self.model_cfg.image_size
        img = pil_center_crop(pil_resize(frame, size, interpolation=Image.BICUBIC), size)
        return normalize_chw(to_float_chw(img), CLIP_MEAN, CLIP_STD)

    def _preprocess_frames(self, frames) -> np.ndarray:
        """Sampled frames -> (T, 3, size, size) float32: the C++ bicubic
        chain in one call under ``--host_preprocess native``, else PIL."""
        if self._native_decided():
            from video_features_tpu_torch import native

            return native.clip_preprocess_batch(
                np.stack(frames), size=self.model_cfg.image_size,
                threads=self._native_threads,
            )
        return np.stack([self._preprocess(f) for f in frames])

    def prepare(self, entry):
        """Host half: (padded batch, T, fps, timestamps, keep). The batch is
        (T_pad, 3, S, S) float32 (a bf16 tensor under ``--dtype
        bfloat16``), or under ``--preprocess device`` the
        (uint8 (T_pad, bh, bw, 3) frames, (wt_y, idx_y), (wt_x, idx_x))
        triple. ``keep`` is the frame-delta gate's mask, or None when the
        gate is off or kept every frame (the ungated payload)."""
        frames, fps, timestamps_ms = extract_frames(
            video_path_of(entry), self.config.extract_method, self.config.decoder
        )
        keep = None
        if self.config.frame_delta_threshold is not None:
            mask = frame_delta_keep_mask(frames, float(self.config.frame_delta_threshold))
            skipped = int(mask.size - mask.sum())
            if skipped:
                self._note_windows_skipped(entry, skipped, int(mask.size))
                keep = mask
                frames = [f for f, k in zip(frames, mask) if k]
        T = len(frames)
        T_pad = bucket_size(T, buckets=self.config.shape_buckets)
        if self._device_preprocess_enabled():
            arr = np.stack(frames)  # (T, H, W, 3) uint8
            h, w = arr.shape[1:3]
            bh, bw = spatial_bucket(h, w, self.config.spatial_bucket)
            size = self.model_cfg.image_size
            wt_y, idx_y, wt_x, idx_x = fused_resize_crop_banded(
                h, w, size, size, "bicubic", pad_h=bh, pad_w=bw
            )
            raw = pad_hw(pad_batch(arr, T_pad), bh, bw)
            return (raw, (wt_y, idx_y), (wt_x, idx_x)), T, fps, timestamps_ms, keep
        batch = pad_batch(self._preprocess_frames(frames), T_pad)
        if self.dtype != torch.float32:
            batch = torch.from_numpy(batch).to(self.dtype)
        return batch, T, fps, timestamps_ms, keep

    def _images_of_raw(self, x_u8: torch.Tensor, taps) -> torch.Tensor:
        """uint8 frames -> resized, cropped and normalized on the device,
        the tower's input; a fused group's (N, T_pad, ...) frames flatten
        to N * T_pad images."""
        x = device_preprocess_frames(x_u8, *taps, CLIP_MEAN, CLIP_STD, out_dtype=self.dtype)
        return x.flatten(0, x.dim() - 4)

    # --- the device half, split (extract/base.py): H2D, forward and D2H
    # enqueued at dispatch, waited for at fetch
    def dispatch_prepared(self, model: VisionTransformer, payload):
        padded, T, fps, timestamps_ms, keep = payload
        with torch.inference_mode():
            if isinstance(model, ShardedVisionTransformer):
                out = model(self._place_sharded(model, padded))
            elif isinstance(padded, tuple):  # --preprocess device
                device = device_of(model)
                raw, wy, wx = padded
                out = model(self._images_of_raw(place_batch(raw, device),
                                                self._device_taps((wy, wx), device)))
            else:
                out = model(place_batch(padded, device_of(model)))
            return HostCopy(out[:T]), fps, timestamps_ms, keep

    def _place_sharded(self, model: ShardedVisionTransformer, padded):
        """A host batch onto the mesh's data rows (``model.place``); under
        ``--preprocess device`` the uint8 frames padded and split over the
        rows, the taps replicated on each (``sharding.place_raw_payload``),
        and each row resized on its own device."""
        from video_features_tpu_torch.parallel.sharding import place_raw_payload

        if not isinstance(padded, tuple):
            return model.place(padded)
        rows = place_raw_payload(padded, model.mesh, place_taps=self._device_taps)
        return [self._images_of_raw(x, taps) for x, taps in rows]

    def fetch_dispatched(self, handle) -> Dict[str, np.ndarray]:
        out, fps, timestamps_ms, keep = handle
        return self._feature_dict(out.numpy(), fps, timestamps_ms, keep)

    def _feature_dict(self, feats: np.ndarray, fps, timestamps_ms, keep) -> Dict[str, np.ndarray]:
        if keep is not None:  # gated: the kept rows back onto the full grid
            feats = copy_forward(feats, keep)
        return {
            self.feature_type: feats,
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
        if isinstance(head, tuple):  # --preprocess device
            # a mesh spreads one video's frames over 'data' already; the
            # raw payload's split covers one video, not a stacked group
            if self.config.sharding == "mesh" or head[0].shape[0] > self.AGG_MAX_FRAMES:
                return None
            # the bucketed (T_pad, bh, bw, 3): videos of other source
            # resolutions in one spatial bucket fuse, each with its taps
            return ("dev", head[0].shape)
        if head.shape[0] > self.AGG_MAX_FRAMES:
            return None
        return head.shape  # the bucketed (T_pad, 3, S, S)

    def transfer_group(self, model: VisionTransformer, payloads):
        """The group's H2D: the videos' batches concatenated (under
        ``--preprocess device``, their uint8 frames stacked and their
        placed taps stacked on the device) and placed now, so the next
        group's copy overlaps this group's forward. A partial group is not
        padded to the full group's size: eager PyTorch compiles no shape,
        and each video's rows are its own."""
        device = device_of(model)
        head = payloads[0][0]
        raw = isinstance(head, tuple)  # --preprocess device; never on a mesh (agg_key)
        bucket = (head[0] if raw else head).shape[0]
        metas = [(i * bucket, T, fps, ts, keep) for i, (_, T, fps, ts, keep) in enumerate(payloads)]
        if raw:
            x = place_batch(np.stack([p[0][0] for p in payloads]), device)
            taps = stack_taps([self._device_taps(p[0][1:], device) for p in payloads])
            return StagedGroup((x, taps), metas)
        heads = [p[0] for p in payloads]
        x = (torch.cat(heads) if isinstance(heads[0], torch.Tensor)
             else np.concatenate(heads, axis=0))
        if isinstance(model, ShardedVisionTransformer):
            return StagedGroup((model.place(x),), metas)
        return StagedGroup((place_batch(x, device),), metas)

    def dispatch_group(self, model: VisionTransformer, payloads):
        if not isinstance(payloads, StagedGroup):
            payloads = self.transfer_group(model, payloads)
        arrays = payloads.arrays
        with torch.inference_mode():
            if len(arrays) == 2:  # --preprocess device: frames and taps
                out = model(self._images_of_raw(*arrays))
            else:
                out = model(arrays[0])
            return HostCopy(out), payloads.metas

    def fetch_group(self, handle):
        out, metas = handle
        arr = out.numpy()
        return [self._feature_dict(arr[off : off + T], fps, ts, keep)
                for off, T, fps, ts, keep in metas]
