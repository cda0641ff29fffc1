"""I3D two-stream extractor: RGB and optical-flow Kinetics features over
sliding stacks of frames, with flow computed on the fly by PWC-Net.

Counterpart of the serial, single-device path of
``video_features_tpu/models/i3d/extract_i3d.py``. Per video: frames are
sampled on the reference's grid (all frames; the ``--extraction_fps``
linspace; or, for a video shorter than 65 frames, upsampled to 65) and
PIL-resized to a smaller edge of 256 as float32. They are windowed into
``stack_size + 1``-frame stacks every ``step_size`` frames (the ragged
tail dropped), and ``--batch_size`` stacks go through the device at a
time, the last group zero-padded to that size and its surplus rows cut:

- rgb: the first ``stack_size`` frames -> floor-offset center crop 224 ->
  [-1, 1] -> I3D-rgb;
- flow: PWC-Net over the ``stack_size`` consecutive pairs (the CUDA cost
  volume at each of its 5 levels) -> crop 224 -> clamp to [-20, 20] and
  quantise to uint8 levels -> [-1, 1] -> I3D-flow.

Weights: ``--weights_path`` is a directory holding any of ``i3d_rgb.pt``,
``i3d_flow.pt`` and ``pwc_net_sintel.pt``; a missing file is an error
unless ``--allow_random_init``. Output: ``{rgb: (S, 1024), flow: (S,
1024), fps, timestamps_ms}``, saved as ``<stem>_rgb.npy`` and
``<stem>_flow.npy``. RAFT, flow read from disk and ``--show_pred`` are
not ported yet (``config.py`` refuses them).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from video_features_tpu_torch.extract.base import BaseExtractor
from video_features_tpu_torch.io.paths import form_slices, video_path_of
from video_features_tpu_torch.io.video import DEFAULT_FPS, CorruptVideoError, probe, read_frames_at_indices
from video_features_tpu_torch.models.common.weights import (
    load_checked,
    load_state_dict,
    random_init_fallback,
)
from video_features_tpu_torch.models.i3d import convert as i3d_convert
from video_features_tpu_torch.models.i3d.model import I3D, I3D_FEATURE_DIM, IN_CHANNELS
from video_features_tpu_torch.models.i3d.model import init_weights as i3d_init
from video_features_tpu_torch.models.pwc import convert as pwc_convert
from video_features_tpu_torch.models.pwc.model import PWCNet
from video_features_tpu_torch.models.pwc.model import init_weights as pwc_init
from video_features_tpu_torch.ops.preprocess import flow_to_uint8, pil_resize, scale_to_1_1
from video_features_tpu_torch.ops.window import pad_batch

MIN_SIDE_SIZE = 256
CENTRAL_CROP_SIZE = 224
DEFAULT_STACK_SIZE = 64
DEFAULT_STEP_SIZE = 64
# checkpoint file names looked up under --weights_path (a directory)
WEIGHT_FILES = {"rgb": "i3d_rgb.pt", "flow": "i3d_flow.pt", "pwc": "pwc_net_sintel.pt"}


def center_crop(x: torch.Tensor, crop: int = CENTRAL_CROP_SIZE) -> torch.Tensor:
    """(..., H, W, C) center crop at floor offsets."""
    H, W = x.shape[-3], x.shape[-2]
    fh, fw = (H - crop) // 2, (W - crop) // 2
    return x[..., fh : fh + crop, fw : fw + crop, :]


def rgb_chain(stack_tail: torch.Tensor) -> torch.Tensor:
    """RGB frames in [0, 255] -> I3D-rgb input."""
    return scale_to_1_1(center_crop(stack_tail))


def flow_chain(flow: torch.Tensor) -> torch.Tensor:
    """PWC flow -> I3D-flow input: crop, clamp and quantise, scale."""
    return scale_to_1_1(flow_to_uint8(center_crop(flow)))


class ExtractI3D(BaseExtractor):
    def __init__(self, config, external_call: bool = False) -> None:
        super().__init__(config, external_call)
        self.streams = list(self.config.streams or ["rgb", "flow"])
        self.stack_size = int(self.config.stack_size or DEFAULT_STACK_SIZE)
        self.step_size = int(self.config.step_size or DEFAULT_STEP_SIZE)
        self.stack_batch = max(int(self.config.batch_size or 1), 1)

    def feature_keys(self) -> List[str]:
        return list(self.streams)  # <stem>_rgb.npy / <stem>_flow.npy

    # --- weights -----------------------------------------------------------
    def _weights_file(self, kind: str):
        root = self.config.weights_path
        if root is None:
            return None
        if not os.path.isdir(root):
            raise ValueError(
                "i3d needs several checkpoints; --weights_path must be a "
                f"DIRECTORY containing any of {sorted(WEIGHT_FILES.values())} "
                f"(got file: {root})"
            )
        path = os.path.join(root, WEIGHT_FILES[kind])
        return path if os.path.exists(path) else None

    def _model(self, kind: str) -> torch.nn.Module:
        """The stream's I3D or the flow net, with weights or seeded init."""
        if kind == "pwc":
            model, convert, init = PWCNet(), pwc_convert.convert_state_dict, pwc_init
        else:
            model, convert, init = I3D(IN_CHANNELS[kind]), i3d_convert.convert_state_dict, i3d_init
        path = self._weights_file(kind)
        if path is None:
            root = self.config.weights_path
            expected = (os.path.join(root, WEIGHT_FILES[kind]) if root
                        else f"a directory containing {WEIGHT_FILES[kind]}")
            random_init_fallback(self.config, f"i3d[{kind}]", expected)
            init(model)
        else:
            load_checked(model, convert(load_state_dict(path)), f"i3d[{kind}]")
        return model

    def _build(self, device: torch.device) -> Dict[str, torch.nn.Module]:
        kinds = self.streams + (["pwc"] if "flow" in self.streams else [])
        return {kind: self._model(kind).to(device).eval() for kind in kinds}

    # --- host: decode and resize -------------------------------------------
    def _sample_frames(self, path: str):
        """The reference's I3D sampling grid: the ``--extraction_fps``
        linspace, upsampling to 65 frames (against the default stack of
        64, whatever ``--stack_size`` is) for a shorter video, or all
        frames. Returns (frames, fps, timestamps_ms)."""
        fps, frame_cnt = probe(path)
        fps = fps or DEFAULT_FPS
        if self.config.extraction_fps is not None:
            samples_num = max(int(frame_cnt / fps * self.config.extraction_fps), 1)
        elif frame_cnt < DEFAULT_STACK_SIZE + 1:
            samples_num = DEFAULT_STACK_SIZE + 1
        else:
            samples_num = frame_cnt
        if self.config.extraction_fps is None and frame_cnt >= DEFAULT_STACK_SIZE + 1:
            samples_ix = np.arange(frame_cnt)
        else:
            samples_ix = np.linspace(1, max(frame_cnt - 1, 1), samples_num).astype(int)
        got = read_frames_at_indices(path, samples_ix)
        # undecodable sampled indices are dropped, as the reference does
        kept = [i for i in samples_ix if i in got]
        mspf = 1000.0 / fps
        return [got[i] for i in kept], fps, [i * mspf for i in kept]

    def prepare(self, entry):
        """Host half: (min-side-256 float32 frames, fps, timestamps_ms)."""
        path = video_path_of(entry)
        frames, fps, timestamps_ms = self._sample_frames(path)
        if not frames:
            raise CorruptVideoError(f"no frames decoded from {path}")
        frames = [pil_resize(f, MIN_SIDE_SIZE).astype(np.float32) for f in frames]
        return frames, fps, timestamps_ms

    # --- device --------------------------------------------------------------
    def forward(self, models: Dict[str, torch.nn.Module], payload) -> Dict[str, np.ndarray]:
        frames, fps, timestamps_ms = payload
        device = next(models[self.streams[0]].parameters()).device
        slices = form_slices(len(frames), self.stack_size + 1, self.step_size)
        feats: Dict[str, List[np.ndarray]] = {s: [] for s in self.streams}
        for g0 in range(0, len(slices), self.stack_batch):
            chunk = slices[g0 : g0 + self.stack_batch]
            stacks = pad_batch(np.stack([np.stack(frames[s:e]) for s, e in chunk]),
                               self.stack_batch)
            x = torch.from_numpy(stacks).to(device)  # (B, S+1, H, W, 3)
            with torch.inference_mode():
                for stream in self.streams:
                    if stream == "rgb":
                        f, _ = models["rgb"](rgb_chain(x[:, :-1]))
                    else:
                        f, _ = models["flow"](flow_chain(models["pwc"](x)))
                    feats[stream].append(f[: len(chunk)].cpu().numpy())
        out: Dict[str, np.ndarray] = {
            s: (np.concatenate(v).astype(np.float32) if v
                else np.zeros((0, I3D_FEATURE_DIM), np.float32))
            for s, v in feats.items()
        }
        out["fps"] = np.array(fps)
        out["timestamps_ms"] = np.array(timestamps_ms)
        return out
