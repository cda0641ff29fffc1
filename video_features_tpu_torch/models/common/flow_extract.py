"""Shared runtime of the pairwise optical-flow extractors (RAFT, PWC).

Counterpart of
``video_features_tpu/models/common/flow_extract.py::PairwiseFlowExtractor``:
frames stream from the decoder (``--extraction_fps`` picks
them on the target grid), each optionally PIL-resized to ``--side_size``,
as raw [0, 255] float32; windows of B+1 frames share their boundary frame
so each window gives B flow pairs (B = ``--batch_size``). The tail window
is filled by repeating its last frame, so every window has one shape, and
the surplus pairs are dropped. A subclass's padder (built from the
first frame's shape) pads each window before the model and unpads the
flow after it: RAFT's replicate padding to multiples of 8; none for PWC,
whose /64 stretch is part of its forward.

``prepare`` decodes the whole video into its padded windows on a decode
thread (the JAX package's eager prepare, :316-410), up to a byte cap
over which the video streams at dispatch instead; ``dispatch_prepared``
enqueues every window and ``fetch_dispatched`` waits for them. With
``--video_batch G`` the windows of any videos of one shape run G at a
time (:460-574). Not ported yet: ``--show_pred`` (refused in
``config.py``) and the ``--preprocess device`` payloads (ROADMAP queue 1,
item 7).

Output: ``{<feature_type>: (T-1, 2, H, W), fps, timestamps_ms}``, flow at
the frames' resolution.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from video_features_tpu_torch.extract.base import BaseExtractor, device_of
from video_features_tpu_torch.extract.ingest import HostCopy, place_batch, stack_group
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
from video_features_tpu_torch.ops.preprocess import pil_resize


class NullPadder:
    """No host-side padding (PWC)."""

    def pad(self, x: np.ndarray) -> np.ndarray:
        return x

    def unpad(self, x):
        return x


class PairwiseFlowExtractor(BaseExtractor):
    """Subclasses set ``checkpoint`` (what ``--weights_path`` should
    hold) and implement ``_model()`` (the module),
    ``_convert_state_dict(sd)`` and ``_init_weights(model)``, and
    optionally ``_make_padder(shape)``."""

    checkpoint = ""

    def __init__(self, config, external_call: bool = False) -> None:
        super().__init__(config, external_call)
        self.batch_size = max(int(self.config.batch_size or 1), 1)

    def _model(self) -> torch.nn.Module:
        raise NotImplementedError

    @staticmethod
    def _convert_state_dict(sd):
        raise NotImplementedError

    @staticmethod
    def _init_weights(model):
        raise NotImplementedError

    def _make_padder(self, shape):
        return NullPadder()

    def _build(self, device: torch.device) -> torch.nn.Module:
        model = self._model()
        if self.config.weights_path:
            sd = self._convert_state_dict(load_state_dict(self.config.weights_path))
            load_checked(model, sd, self.feature_type)
        else:
            random_init_fallback(self.config, self.feature_type, self.checkpoint)
            self._init_weights(model)
        return model.to(device).eval()

    def _preprocess(self, frame: np.ndarray) -> np.ndarray:
        if self.config.side_size is not None:
            frame = pil_resize(frame, int(self.config.side_size),
                               self.config.resize_to_smaller_edge)
        return frame.astype(np.float32)

    # --- host: an eager prepare, capped in bytes --------------------------
    # A prepared video holds its padded windows; the pipeline keeps up to
    # decode_workers + 2 prepared videos, so the byte budget splits into a
    # per-video frame cap (``_prefetch_frame_cap``). A video over it is
    # handed over as ("stream", entry): its decode then interleaves with
    # its windows' forwards at dispatch, one such video resident at a time.
    PIPELINE_MAX_BYTES = 4 << 30

    def _window_cap(self, padded_frame: np.ndarray) -> int:
        """The prefetch cap in frames, given one padded frame."""
        return self._prefetch_frame_cap(self.PIPELINE_MAX_BYTES, padded_frame.nbytes,
                                        floor=4 * self.batch_size)

    def _fps(self, path: str) -> float:
        return self.config.extraction_fps or fps_or_default(probe(path)[0], path)

    def _windows(self, path: str, timestamps_ms: List[float], capped: bool):
        """Decode ``path`` into padded B+1-frame windows, yielding
        (window, pairs, padder) as each fills and appending each frame's
        timestamp to ``timestamps_ms``. The tail window repeats its last
        frame, so every window has one shape; its surplus pairs are cut
        after the forward. With ``capped``, yield None and stop once the
        video passes the prefetch cap."""
        batch: List[np.ndarray] = []
        padder = cap = None
        for count, (frame, ts) in enumerate(stream_frames(path, self.config.extraction_fps), 1):
            frame = self._preprocess(frame)
            if padder is None:
                padder = self._make_padder(frame.shape[:2])
                cap = self._window_cap(padder.pad(frame[None])[0]) if capped else None
            if cap is not None and count > cap:
                yield None
                return
            timestamps_ms.append(ts)
            batch.append(frame)
            # B+1 frames make B pairs; the boundary frame carries over
            if len(batch) - 1 == self.batch_size:
                yield self._pad_window(batch, padder), len(batch) - 1, padder
                batch = [batch[-1]]
        if len(batch) > 1:
            yield self._pad_window(batch, padder), len(batch) - 1, padder
        if padder is None:
            raise CorruptVideoError(f"no frames decoded from {path}")

    def _pad_window(self, batch: List[np.ndarray], padder) -> np.ndarray:
        return padder.pad(np.stack(batch + [batch[-1]] * (self.batch_size + 1 - len(batch))))

    def prepare(self, entry):
        """Host half: (padded (B+1, Hp, Wp, 3) windows, their pair counts,
        padder, fps, timestamps_ms), or ("stream", entry) over the cap."""
        path = video_path_of(entry)
        windows: List[np.ndarray] = []
        n_pairs: List[int] = []
        timestamps_ms: List[float] = []
        padder = None
        for item in self._windows(path, timestamps_ms, capped=True):
            if item is None:
                return ("stream", entry)
            window, n, padder = item
            windows.append(window)
            n_pairs.append(n)
        return windows, n_pairs, padder, self._fps(path), timestamps_ms

    # --- the device half, split (extract/base.py) --------------------------
    @staticmethod
    def _dispatch_window(model: torch.nn.Module, window: np.ndarray, n_pairs: int,
                         padder, device: torch.device) -> HostCopy:
        """One padded window -> its (n, 2, H, W) flows on their way to the
        host, surplus pairs cut."""
        with torch.inference_mode():
            flow = padder.unpad(model(place_batch(window, device)))
            return HostCopy(flow[:n_pairs].permute(0, 3, 1, 2))

    def _stream(self, model: torch.nn.Module, entry) -> Dict[str, np.ndarray]:
        """A video over the prefetch cap: decode interleaved with its
        windows' forwards, so it is never held whole."""
        path = video_path_of(entry)
        timestamps_ms: List[float] = []
        device = device_of(model)
        flows = [self._dispatch_window(model, w, n, padder, device)
                 for w, n, padder in self._windows(path, timestamps_ms, capped=False)]
        return self._flow_dict([f.numpy() for f in flows], self._fps(path), timestamps_ms)

    def _flow_dict(self, flows: List[np.ndarray], fps, timestamps_ms) -> Dict[str, np.ndarray]:
        """Per-window (n, 2, H, W) flows -> the video's feature dict."""
        return {
            self.feature_type: np.array([f for w in flows for f in w]),
            "fps": np.array(fps),
            "timestamps_ms": np.array(timestamps_ms),
        }

    def dispatch_prepared(self, model: torch.nn.Module, payload):
        if isinstance(payload[0], str):  # ("stream", entry): over the cap
            return ("done", self._stream(model, payload[1]))
        windows, n_pairs, padder, fps, timestamps_ms = payload
        device = device_of(model)
        outs = [self._dispatch_window(model, w, n, padder, device)
                for w, n in zip(windows, n_pairs)]
        return ("batched", outs, fps, timestamps_ms)

    def fetch_dispatched(self, handle) -> Dict[str, np.ndarray]:
        if handle[0] == "done":
            return handle[1]
        _, outs, fps, timestamps_ms = handle
        return self._flow_dict([o.numpy() for o in outs], fps, timestamps_ms)

    # --- cross-video aggregation (--video_batch) ---------------------------
    # Same-resolution windows share one shape, so G = --video_batch of them,
    # from any mix of videos, fuse into one batched forward (G * B pairs);
    # the flows split back per video by window counts. The reference
    # batches pairs only within a video.
    AGG_MAX_BYTES = 512 << 20

    def agg_key(self, payload):
        if isinstance(payload[0], str):
            return None
        windows = payload[0]
        # a 1-frame video makes no pairs, hence no windows: nothing to fuse
        if not windows or len(windows) * windows[0].nbytes > self.AGG_MAX_BYTES:
            return None
        return windows[0].shape  # (B+1, Hp, Wp, 3)

    def dispatch_group(self, model: torch.nn.Module, payloads):
        """The windows of the group's videos, G at a time, as (G, B+1, Hp,
        Wp, 3) forwards; the last forward is not padded to G windows."""
        group = max(int(self.config.video_batch or 1), 1)
        device = device_of(model)
        flat_w = [w for p in payloads for w in p[0]]
        outs = []
        with torch.inference_mode():
            for i in range(0, len(flat_w), group):
                x = place_batch(stack_group(flat_w[i : i + group]), device)
                outs.append(HostCopy(model(x)))  # (g, B, Hp, Wp, 2)
        metas = [(p[1], p[2], p[3], p[4]) for p in payloads]
        return outs, metas

    def fetch_group(self, handle):
        outs, metas = handle
        per_window = [w for out in outs for w in out.numpy()]
        dicts, off = [], 0
        for n_pairs, padder, fps, timestamps_ms in metas:
            flows = [np.transpose(padder.unpad(w)[:n], (0, 3, 1, 2))
                     for w, n in zip(per_window[off : off + len(n_pairs)], n_pairs)]
            off += len(n_pairs)
            dicts.append(self._flow_dict(flows, fps, timestamps_ms))
        return dicts
