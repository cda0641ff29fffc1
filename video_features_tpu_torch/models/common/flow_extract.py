"""Shared runtime of the pairwise optical-flow extractors (RAFT, PWC).

Counterpart of the serial loop of
``video_features_tpu/models/common/flow_extract.py::PairwiseFlowExtractor``
(:231-312): frames stream from the decoder (``--extraction_fps`` picks
them on the target grid), each optionally PIL-resized to ``--side_size``,
as raw [0, 255] float32; windows of B+1 frames share their boundary frame
so each window gives B flow pairs (B = ``--batch_size``). The tail window
is filled by repeating its last frame, so every window has one shape, and
the surplus pairs are dropped. A subclass's padder (built from the
first frame's shape) pads each window before the model and unpads the
flow after it: RAFT's replicate padding to multiples of 8; none for PWC,
whose /64 stretch is part of its forward.

Output: ``{<feature_type>: (T-1, 2, H, W), fps, timestamps_ms}``, flow at
the frames' resolution.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from video_features_tpu_torch.extract.base import BaseExtractor
from video_features_tpu_torch.io.paths import video_path_of
from video_features_tpu_torch.io.video import DEFAULT_FPS, CorruptVideoError, probe, stream_frames
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

    def prepare(self, entry):
        """(lazy stream of (preprocessed frame, timestamp_ms), fps): decode
        interleaves with the windows' forwards, so a long video is never
        held whole."""
        path = video_path_of(entry)
        fps = self.config.extraction_fps or probe(path)[0] or DEFAULT_FPS
        frames = (
            (self._preprocess(frame), ts)
            for frame, ts in stream_frames(path, self.config.extraction_fps)
        )
        return frames, fps, path

    def _window(self, model: torch.nn.Module, batch: List[np.ndarray], padder) -> List[np.ndarray]:
        """One B+1-frame window -> its (2, H, W) flows, surplus pairs cut."""
        n_pairs = len(batch) - 1
        window = padder.pad(np.stack(batch + [batch[-1]] * (self.batch_size + 1 - len(batch))))
        device = next(model.parameters()).device
        with torch.inference_mode():
            flow = padder.unpad(model(torch.from_numpy(window).to(device)))
        return list(flow[:n_pairs].permute(0, 3, 1, 2).cpu().numpy())

    def forward(self, model: torch.nn.Module, payload) -> Dict[str, np.ndarray]:
        frames, fps, path = payload
        flows: List[np.ndarray] = []
        timestamps_ms: List[float] = []
        batch: List[np.ndarray] = []
        padder = None
        for frame, ts in frames:
            timestamps_ms.append(ts)
            if padder is None:
                padder = self._make_padder(frame.shape[:2])
            batch.append(frame)
            # B+1 frames make B pairs; the boundary frame carries over
            if len(batch) - 1 == self.batch_size:
                flows.extend(self._window(model, batch, padder))
                batch = [batch[-1]]
        if len(batch) > 1:
            flows.extend(self._window(model, batch, padder))
        if not timestamps_ms:
            raise CorruptVideoError(f"no frames decoded from {path}")
        return {
            self.feature_type: np.array(flows),
            "fps": np.array(fps),
            "timestamps_ms": np.array(timestamps_ms),
        }
