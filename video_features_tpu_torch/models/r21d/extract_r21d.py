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
``--show_pred`` prints each stack's top-5 Kinetics-400 classes. With
``--video_batch N`` the stacks of N same-resolution videos re-chunk into
``N * batch_size``-stack forwards. ``--uint8_transfer off`` casts the
stacks to fp32 on the host before the H2D copy (4x the bytes; the
features are the same, as ``kinetics_preprocess`` starts with that cast);
``--conv3d_impl`` picks the 3D convolutions' lowering
(``models/common/layers.py::Conv3dCompat``).

``--dtype bfloat16``: the network's bf16 graph (``models/r21d/
model.py``), its weights cast after loading with ``fc`` kept fp32;
``kinetics_preprocess`` stays fp32 and its output is rounded to bf16 at
the first conv.

``--sharding mesh``: data parallelism over the stack batch. The network
is replicated on the mesh's data rows (``parallel/sharding.py::
replicate``), each group of stacks (and each fused chunk) splits over the
rows (``split_rows``; a row left without stacks sits out), and the rows'
features gather onto the first device before the copy to the host.

Output: ``{r21d_rgb: (S, 512), fps, timestamps_ms}``, fp32, one timestamp
per decoded frame.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from video_features_tpu_torch.extract.base import BaseExtractor, device_of
from video_features_tpu_torch.extract.ingest import HostCopy, place_batch, stack_group
from video_features_tpu_torch.io.paths import form_slices, video_path_of
from video_features_tpu_torch.io.video import (
    CorruptVideoError,
    fps_or_default,
    probe,
    stream_frames,
)
from video_features_tpu_torch.models.common.layers import (
    device_vector,
    explicit_conv3d_impl,
    set_conv3d_impl,
)
from video_features_tpu_torch.models.common.weights import (
    cast_for_compute,
    compute_dtype,
    load_checked,
    load_params,
    random_init_fallback,
)
from video_features_tpu_torch.models.r21d.convert import convert_state_dict, params_from_jax
from video_features_tpu_torch.models.r21d.model import (
    FP32_PARAMS,
    R21D_FEATURE_DIM,
    R2Plus1D,
    init_weights,
)
from video_features_tpu_torch.ops.preprocess import KINETICS_MEAN, KINETICS_STD
from video_features_tpu_torch.ops.resize import resize_bilinear
from video_features_tpu_torch.parallel.sharding import Replicas, is_mesh, replicate
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
    mean = device_vector(KINETICS_MEAN, x).reshape(3, 1, 1)
    std = device_vector(KINETICS_STD, x).reshape(3, 1, 1)
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
        # --conv3d_impl for THIS extractor's model (None: auto)
        self.conv_impl = explicit_conv3d_impl(self.config)

    # --sharding mesh: pure data parallelism over the stack batch, the
    # weights replicated (parallel/scheduler.py reads this)
    mesh_capable = True

    def _build(self, device):
        """The network on ``device``; on a mesh, one copy a distinct device
        of its data rows (``sharding.replicate``)."""
        if is_mesh(device):
            return replicate(self._build, device)
        model = R2Plus1D()
        if self.config.weights_path:
            load_checked(model, load_params(self.config.weights_path, convert_state_dict,
                                            params_from_jax), self.feature_type)
        else:
            random_init_fallback(self.config, self.feature_type,
                                 "a torchvision r2plus1d_18 (Kinetics-400) state dict (.pt/.pth), "
                                 "or its converted .msgpack / orbax directory")
            init_weights(model)
        set_conv3d_impl(model, self.conv_impl)
        return cast_for_compute(model.to(device).eval(), compute_dtype(self.config),
                                exclude=FP32_PARAMS)

    def prepare(self, entry):
        """Host half: ((T, H, W, 3) uint8 clip, stack slices, fps,
        timestamps_ms, path)."""
        path = video_path_of(entry)
        frames: List[np.ndarray] = []
        timestamps_ms: List[float] = []
        for frame, ts in stream_frames(path, self.config.extraction_fps,
                                       self.config.decoder):
            frames.append(frame)
            timestamps_ms.append(ts)
        if not frames:
            raise CorruptVideoError(f"no frames decoded from {path}")
        clip = np.stack(frames)
        slices = form_slices(clip.shape[0], self.stack_size, self.step_size)
        fps = self.config.extraction_fps or fps_or_default(
            probe(path, self.config.decoder)[0], path)
        return clip, slices, fps, timestamps_ms, path

    @staticmethod
    def _prepare(stacks: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) uint8 stacks on the device -> the network's
        (B, 3, T, 112, 112) input."""
        return kinetics_preprocess(stacks).permute(0, 4, 1, 2, 3)

    def _features(self, model, stacks: np.ndarray):
        """(B, T, H, W, 3) host stacks -> (features, logits) on the model's
        device: placed whole, or on a mesh split over the data rows, each
        row preprocessing its own, and gathered (``Replicas.run``)."""
        stacks = self._maybe_widen(stacks)
        if isinstance(model, Replicas):
            return model.run(stacks, prepare=self._prepare)
        return model(self._prepare(place_batch(stacks, device_of(model))))

    # graftcheck: fp32-island — the documented --uint8_transfer off escape
    # hatch: it trades the 4x wire bytes for a transport with a slow uint8
    # copy path, so the host cast here is the feature, not a leak
    def _maybe_widen(self, stacks: np.ndarray) -> np.ndarray:
        """``--uint8_transfer off``: the stacks cast to fp32 on the host, for
        a transport whose uint8 copies are slow; ``kinetics_preprocess``
        starts with the same cast, so the features are identical."""
        if self.config.uint8_transfer == "off":
            return stacks.astype(np.float32)
        return stacks

    # --- the device half, split (extract/base.py): every stack group's
    # H2D (uint8, or fp32 under --uint8_transfer off), preprocess, forward
    # and D2H enqueued at dispatch
    def dispatch_prepared(self, model: R2Plus1D, payload):
        clip, slices, fps, timestamps_ms, path = payload
        outs = []
        with torch.inference_mode():
            for g0 in range(0, len(slices), self.batch_size):
                chunk = slices[g0 : g0 + self.batch_size]
                stacks = stack_group([clip[s:e] for s, e in chunk], pad_to=self.batch_size)
                f, logits = self._features(model, stacks)
                # the 400-class logits cross only for --show_pred
                outs.append((chunk, HostCopy(f[: len(chunk)]),
                             HostCopy(logits[: len(chunk)]) if self.config.show_pred else None))
        return outs, fps, timestamps_ms, path

    def fetch_dispatched(self, handle) -> Dict[str, np.ndarray]:
        outs, fps, timestamps_ms, path = handle
        feats: List[np.ndarray] = []
        for chunk, f, logits in outs:
            feats.append(f.numpy())
            if logits is not None:
                for (start, end), row in zip(chunk, logits.numpy()):
                    print(f"{path} @ frames ({start}, {end})")
                    show_predictions_on_dataset(row, "kinetics")
        return {
            self.feature_type: (np.concatenate(feats) if feats
                                else np.zeros((0, R21D_FEATURE_DIM), np.float32)),
            "fps": np.array(fps),
            "timestamps_ms": np.array(timestamps_ms),
        }

    # --- cross-video aggregation (--video_batch): the uint8 stacks of N
    # same-resolution videos re-chunk into (N * batch_size)-stack forwards.
    # A short video gives 1-4 16-frame stacks, too few to fill the card
    # alone. The key carries (H, W), so only same-resolution videos fuse.
    # The cap is in transfer BYTES (stacks at the source resolution, before
    # the device resize; 4 a pixel channel under --uint8_transfer off): a
    # stack count that is harmless at 240p is gigabytes at 1080p, and
    # N - 1 payloads wait on the host while a group fills. Over-cap videos
    # and --show_pred take the solo path.
    AGG_MAX_BYTES = 256 << 20

    def agg_key(self, payload):
        clip, slices = payload[0], payload[1]
        if self.config.show_pred or not slices:
            return None
        elem = 4 if self.config.uint8_transfer == "off" else 1
        if (len(slices) * self.stack_size * int(np.prod(clip.shape[1:])) * elem
                > self.AGG_MAX_BYTES):
            return None
        return (self.stack_size,) + clip.shape[1:]  # (stack, H, W, 3)

    def dispatch_group(self, model: R2Plus1D, payloads):
        group = max(int(self.config.video_batch or 1), 1)
        rows = [np.stack([clip[s:e] for s, e in slices]) for clip, slices, *_ in payloads]
        outs = self._dispatch_rows_grouped(rows, self.batch_size * group,
                                           lambda x: self._features(model, x)[0])
        return outs, [len(p[1]) for p in payloads], [(p[2], p[3]) for p in payloads]

    def fetch_group(self, handle):
        outs, totals, metas = handle
        return [
            {self.feature_type: feats, "fps": np.array(fps), "timestamps_ms": np.array(ts)}
            for feats, (fps, ts) in zip(self._split_grouped_rows(outs, totals), metas)
        ]
