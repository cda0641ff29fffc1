"""ResNet frame-feature extractor.

Counterpart of ``video_features_tpu/models/resnet/extract_resnet.py``.
Per video: frames stream from the decoder (``--extraction_fps`` picks
them on the target grid), each goes through torchvision's Resize(256) /
CenterCrop(224) / Normalize chain on the host (``imagenet_preprocess``,
byte-identical to the JAX package), and ``--batch_size`` frames go
through the device at a time, the tail batch zero-padded to that size and
its surplus rows cut. ``--show_pred`` prints each frame's top-5 ImageNet
classes. With ``--video_batch N`` the frames of N videos re-chunk into
``N * batch_size``-row forwards. ``--fps_retarget reencode`` decodes the
reference's ffmpeg re-encode instead of picking frames of the source
(``BaseExtractor._fps_source``).

``--host_preprocess native`` (under ``--preprocess host``): a batch's
frames go through the C++ bilinear chain in one threaded call
(``native.imagenet_preprocess_batch``, within ~1/255 per pixel of PIL).
``--decoder`` picks the decode backend.

``--preprocess device``: the batches hold the raw uint8 frames padded to
their spatial bucket, with the bilinear resize + crop taps of their
source resolution; the chain runs on the device before the model
(``device_preprocess_frames``), and in a fused group each row carries its
video's taps. A video longer than its prefetch cap (a byte budget over
the resident prepared videos; under ``--preprocess device`` counted in
bucket-sized uint8 frames) is handed over as ``("stream", entry)`` and
decoded batch by batch at dispatch, so it is never held whole.

``--dtype bfloat16``: the network's bf16 graph (``models/resnet/
model.py``), its weights cast after loading with ``fc`` kept fp32; the
device preprocess returns bf16.

``--sharding mesh``: data parallelism. The network is replicated on the
mesh's data rows (``parallel/sharding.py::replicate``), each frame batch
(and each fused chunk) splits over the rows (``split_rows``), and the
rows' features gather onto the first device before the copy to the host.
``--preprocess device`` stays refused on a mesh (``config.py``), as in
the JAX package.

Output: ``{resnetXX: (T, 512 * expansion), fps, timestamps_ms}``, 2048-d
for resnet50 and deeper, fp32.
"""

from __future__ import annotations

import functools
from typing import Dict, List

import numpy as np
import torch

from video_features_tpu_torch.extract.base import BaseExtractor, device_of
from video_features_tpu_torch.extract.ingest import HostCopy, place_batch, stack_taps
from video_features_tpu_torch.io.paths import video_path_of
from video_features_tpu_torch.io.video import (
    CorruptVideoError,
    fps_or_default,
    probe,
    stream_frames,
)
from video_features_tpu_torch.models.common.weights import (
    cast_for_compute,
    compute_dtype,
    load_checked,
    load_params,
    random_init_fallback,
)
from video_features_tpu_torch.models.resnet.convert import convert_state_dict, params_from_jax
from video_features_tpu_torch.models.resnet.model import FP32_PARAMS, ResNet, init_weights
from video_features_tpu_torch.ops.preprocess import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    device_preprocess_frames,
    imagenet_preprocess,
)
from video_features_tpu_torch.ops.resize import fused_resize_crop_banded
from video_features_tpu_torch.ops.window import pad_batch, pad_hw, spatial_bucket
from video_features_tpu_torch.parallel.sharding import Replicas, is_mesh, replicate
from video_features_tpu_torch.utils.labels import show_predictions_on_dataset


class ExtractResNet(BaseExtractor):
    def __init__(self, config, external_call: bool = False) -> None:
        super().__init__(config, external_call)
        self.batch_size = max(int(self.config.batch_size or 1), 1)
        self.dtype = compute_dtype(self.config)
        self._native_decided()  # an unavailable --host_preprocess native fails here

    # --sharding mesh: pure data parallelism, the weights replicated and
    # the frame batch split over 'data' (parallel/scheduler.py reads this)
    mesh_capable = True

    def _build(self, device):
        """The network on ``device``; on a mesh, one copy a distinct device
        of its data rows (``sharding.replicate``)."""
        if is_mesh(device):
            return replicate(self._build, device)
        model = ResNet(self.feature_type)
        if self.config.weights_path:
            sd = load_params(self.config.weights_path,
                             functools.partial(convert_state_dict, arch=self.feature_type),
                             functools.partial(params_from_jax, arch=self.feature_type))
            load_checked(model, sd, self.feature_type)
        else:
            random_init_fallback(self.config, self.feature_type,
                                 f"a torchvision {self.feature_type} state dict (.pt/.pth), "
                                 "or its converted .msgpack / orbax directory")
            init_weights(model)
        return cast_for_compute(model.to(device).eval(), self.dtype, exclude=FP32_PARAMS)

    # A prepared video holds its preprocessed fp32 224x224 frames (~600 KB
    # each); the pipeline keeps decode_workers + 2 prepared videos, so the
    # byte budget splits into a per-video frame cap. Under --preprocess
    # device a frame costs its bucket's uint8 bytes instead, so the cap
    # follows the first decoded frame's resolution.
    PIPELINE_MAX_BYTES = 4 << 30
    _FRAME_BYTES = 3 * 224 * 224 * 4

    def _device_geometry(self, h: int, w: int):
        """(bucket_h, bucket_w, (wt_y, idx_y), (wt_x, idx_x)) of a source
        resolution: the bilinear Resize(256) + CenterCrop(224) as
        bucket-padded banded taps."""
        bh, bw = spatial_bucket(h, w, self.config.spatial_bucket)
        wt_y, idx_y, wt_x, idx_x = fused_resize_crop_banded(
            h, w, 256, 224, "bilinear", pad_h=bh, pad_w=bw
        )
        return bh, bw, (wt_y, idx_y), (wt_x, idx_x)

    def _preprocess_batch(self, frames: List[np.ndarray]) -> np.ndarray:
        """Decoded frames -> (n, 3, 224, 224) float32: the C++ bilinear
        chain in one call under ``--host_preprocess native``, else the
        reference's PIL chain frame by frame."""
        if self._native_decided():
            from video_features_tpu_torch import native

            return native.imagenet_preprocess_batch(np.stack(frames),
                                                    threads=self._native_threads)
        return np.stack([imagenet_preprocess(f) for f in frames])

    def _batch(self, frames: List[np.ndarray], geom) -> np.ndarray:
        """Up to ``batch_size`` decoded frames -> one batch padded to
        ``batch_size`` rows: (B, 3, 224, 224) float32 on the host chain;
        (B, bh, bw, 3) uint8 on the device chain (``geom``)."""
        if geom is None:
            x = self._preprocess_batch(frames)
        else:
            x = pad_hw(np.stack(frames), geom[0], geom[1])
        return pad_batch(x, self.batch_size)

    def _fps(self, path: str) -> float:
        return self.config.extraction_fps or fps_or_default(
            probe(path, self.config.decoder)[0], path)

    def prepare(self, entry):
        """Host half: (batches, their valid row counts, fps, timestamps_ms,
        taps), with taps None on the host chain and the video's
        ((wt_y, idx_y), (wt_x, idx_x)) under ``--preprocess device``; or
        ("stream", entry, source) over the prefetch cap (the resolved
        decode source travels, so a re-encode is not run twice)."""
        path = video_path_of(entry)
        source = self._fps_source(path)
        device_pre = self._device_preprocess_enabled()
        frames: List[np.ndarray] = []
        batches: List[np.ndarray] = []
        counts: List[int] = []
        timestamps_ms: List[float] = []
        geom = None
        cap = self._prefetch_frame_cap(self.PIPELINE_MAX_BYTES, self._FRAME_BYTES, floor=64)
        for frame, ts in stream_frames(*source, self.config.decoder):
            if device_pre and geom is None:
                geom = self._device_geometry(*frame.shape[:2])
                cap = self._prefetch_frame_cap(self.PIPELINE_MAX_BYTES,
                                               geom[0] * geom[1] * 3, floor=64)
            if len(timestamps_ms) == cap:
                return ("stream", entry, source)
            frames.append(frame)
            timestamps_ms.append(ts)
            if len(frames) == self.batch_size:
                batches.append(self._batch(frames, geom))
                counts.append(len(frames))
                frames = []
        if frames:
            batches.append(self._batch(frames, geom))
            counts.append(len(frames))
        if not batches:
            raise CorruptVideoError(f"no frames decoded from {path}")
        return batches, counts, self._fps(path), timestamps_ms, geom and (geom[2], geom[3])

    def _forward(self, model: ResNet, x: torch.Tensor, taps):
        """One placed batch -> (features, logits); under ``--preprocess
        device`` the resize, crop and normalize run first."""
        if taps is not None:
            x = device_preprocess_frames(x, *taps, IMAGENET_MEAN, IMAGENET_STD,
                                         out_dtype=self.dtype)
        return model(x)

    def _run(self, model, x: np.ndarray, taps):
        """One host batch -> (features, logits) on the model's device; on a
        mesh split over the data rows and gathered (``Replicas.run``)."""
        if isinstance(model, Replicas):
            return model.run(x)
        return self._forward(model, place_batch(x, device_of(model)), taps)

    def _dispatch_batch(self, model: ResNet, x: np.ndarray, n: int, taps):
        """Enqueue one batch: its first ``n`` feature rows (and logits, for
        ``--show_pred``) on their way to the host."""
        f, logits = self._run(model, x, taps)
        # the 1000-class logits cross only for --show_pred
        return HostCopy(f[:n]), HostCopy(logits[:n]) if self.config.show_pred else None

    def _stream(self, model: ResNet, entry, source) -> Dict[str, np.ndarray]:
        """A video over the prefetch cap: decode (``source``, prepare's
        decode path and selection fps) and preprocess one batch at a time,
        interleaved with its forwards, so host memory holds one batch."""
        path = video_path_of(entry)
        device = device_of(model)
        device_pre = self._device_preprocess_enabled()
        outs, frames, timestamps_ms = [], [], []
        geom = taps = None

        def run():
            outs.append(self._dispatch_batch(model, self._batch(frames, geom), len(frames), taps))

        with torch.inference_mode():
            for frame, ts in stream_frames(*source, self.config.decoder):
                if device_pre and geom is None:
                    geom = self._device_geometry(*frame.shape[:2])
                    taps = self._device_taps((geom[2], geom[3]), device)
                frames.append(frame)
                timestamps_ms.append(ts)
                if len(frames) == self.batch_size:
                    run()
                    frames = []
            if frames:
                run()
        if not outs:
            raise CorruptVideoError(f"no frames decoded from {path}")
        return self._feature_dict(outs, self._fps(path), timestamps_ms)

    def _feature_dict(self, outs, fps, timestamps_ms) -> Dict[str, np.ndarray]:
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

    # --- the device half, split (extract/base.py): every batch's H2D,
    # forward and D2H enqueued at dispatch, waited for at fetch. A streamed
    # video decodes as it computes, so it completes at dispatch and fetch
    # passes its dict through.
    def dispatch_prepared(self, model: ResNet, payload):
        if isinstance(payload[0], str):  # ("stream", entry, source): over the cap
            return ("done", self._stream(model, *payload[1:]))
        batches, counts, fps, timestamps_ms, taps = payload
        if taps is not None:
            taps = self._device_taps(taps, device_of(model))
        with torch.inference_mode():
            outs = [self._dispatch_batch(model, x, n, taps) for x, n in zip(batches, counts)]
        return ("batched", outs, fps, timestamps_ms)

    def fetch_dispatched(self, handle) -> Dict[str, np.ndarray]:
        if handle[0] == "done":
            return handle[1]
        return self._feature_dict(*handle[1:])

    # --- cross-video aggregation (--video_batch): the valid frames of N
    # videos re-chunk into (N * batch_size)-row forwards, so short videos,
    # whose lone tail batch is mostly padding, share a dispatch. Streamed
    # and large videos (over AGG_MAX_FRAMES valid rows resident while a
    # group fills) and --show_pred (per-video print order) take the solo
    # path. Under --preprocess device the key is the bucketed uint8 batch
    # shape, so videos of other source resolutions in one bucket fuse:
    # each row gathers its own video's taps.
    AGG_MAX_FRAMES = 512

    def agg_key(self, payload):
        if isinstance(payload[0], str) or self.config.show_pred:
            return None
        batches, counts, _, _, taps = payload
        if sum(counts) > self.AGG_MAX_FRAMES:
            return None
        shape = batches[0].shape  # (B, 3, 224, 224), or (B, bh, bw, 3) uint8
        return shape if taps is None else ("dev", shape)

    def dispatch_group(self, model: ResNet, payloads):
        group = max(int(self.config.video_batch or 1), 1)
        device = device_of(model)
        rows, totals = [], []
        for batches, counts, _, _, _ in payloads:
            rows.extend(x[:n] for x, n in zip(batches, counts))
            totals.append(sum(counts))
        chunk = self.batch_size * group
        forward = lambda x: self._run(model, x, None)[0]  # noqa: E731
        if payloads[0][4] is not None:  # --preprocess device: each row its video's taps
            video_taps = stack_taps([self._device_taps(p[4], device) for p in payloads])
            row_ids = np.repeat(np.arange(len(payloads)), totals)
            # the chunks' video ids, in the order the chunks are dispatched
            chunk_ids = (row_ids[i : i + chunk] for i in range(0, row_ids.size, chunk))

            def forward(x):
                ids = place_batch(next(chunk_ids), device)
                taps = tuple((wt[ids], idx[ids]) for wt, idx in video_taps)
                return self._forward(model, place_batch(x, device), taps)[0]

        outs = self._dispatch_rows_grouped(rows, chunk, forward)
        return outs, totals, [(p[2], p[3]) for p in payloads]

    def fetch_group(self, handle):
        outs, totals, metas = handle
        return [
            {self.feature_type: feats, "fps": np.array(fps), "timestamps_ms": np.array(ts)}
            for feats, (fps, ts) in zip(self._split_grouped_rows(outs, totals), metas)
        ]
