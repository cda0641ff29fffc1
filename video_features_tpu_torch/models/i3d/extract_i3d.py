"""I3D two-stream extractor: RGB and optical-flow Kinetics features over
sliding stacks of frames, with flow computed on the fly by PWC-Net or
RAFT (``--flow_type``).

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
- flow: the flow model over the ``stack_size`` consecutive pairs of each
  stack -> crop 224 -> clamp to [-20, 20] and quantise to uint8 levels ->
  [-1, 1] -> I3D-flow. PWC-Net runs at the frames' resolution (the CUDA
  cost volume at each of its 5 levels). RAFT runs on the stack
  replicate-padded to multiples of 8 (``InputPadder.pad_tensor``, on
  the device), and its flow is kept at the padded resolution into the crop,
  as the reference does: a 256x341 stack runs at 256x344, and the crop
  starts at column 60 of the padded flow, column 59 of the image.

Weights: ``--weights_path`` is a directory holding any of ``i3d_rgb.pt``,
``i3d_flow.pt``, ``raft-sintel.pth`` and ``pwc_net_sintel.pt``; a missing
file is an error unless ``--allow_random_init``. Output: ``{rgb: (S,
1024), flow: (S, 1024), fps, timestamps_ms}``, saved as
``<stem>_rgb.npy`` and ``<stem>_flow.npy``. With ``--video_batch N`` the
stacks of N same-resolution clips fill the ``--batch_size`` stack groups.
Flow read from disk and ``--show_pred`` are not ported yet (``config.py``
refuses them).

``--preprocess device``: ``prepare`` keeps the sampled frames raw (uint8
at the source resolution), and the stacks, zero-padded to their spatial
bucket, are resized on the device with the taps of ``_device_geometry``:
the rgb stream's min-edge-256 resize and floor-offset 224 crop in one
pass; the flow stream's min-edge-256 resize onto the flow net's grid
(RAFT's InputPadder grid rounded up to ``--spatial_bucket``, the image
edge-replicated where the padder puts it; PWC's exact resized grid, as
its /64 stretch is part of its forward), and the 224 crop of the flow at
the offsets where the host crops the padded flow.

``--dtype bfloat16``: both I3D streams run their bf16 graph
(``models/i3d/model.py``, the logits head fp32), and the flow net its own
mixed-precision graph (``models/raft/model.py``, ``models/pwc/model.py``:
PWC's cost volumes get fp32 inputs), each with its family's parameters
kept fp32; the flow goes through ``flow_to_uint8`` in fp32. Features are
fp32.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List

import numpy as np
import torch

from video_features_tpu_torch.extract.base import BaseExtractor, device_of
from video_features_tpu_torch.extract.ingest import HostCopy, place_batch, stack_group
from video_features_tpu_torch.io.paths import form_slices, video_path_of
from video_features_tpu_torch.io.video import (
    CorruptVideoError,
    fps_or_default,
    frame_size,
    probe,
    read_frames_at_indices,
)
from video_features_tpu_torch.models.common.weights import (
    cast_for_compute,
    compute_dtype,
    load_checked,
    load_state_dict,
    random_init_fallback,
)
from video_features_tpu_torch.models.i3d import convert as i3d_convert
from video_features_tpu_torch.models.i3d.model import FP32_PARAMS as I3D_FP32_PARAMS
from video_features_tpu_torch.models.i3d.model import I3D, I3D_FEATURE_DIM, IN_CHANNELS
from video_features_tpu_torch.models.i3d.model import init_weights as i3d_init
from video_features_tpu_torch.models.pwc import convert as pwc_convert
from video_features_tpu_torch.models.pwc.model import FP32_PARAMS as PWC_FP32_PARAMS
from video_features_tpu_torch.models.pwc.model import PWCNet
from video_features_tpu_torch.models.pwc.model import init_weights as pwc_init
from video_features_tpu_torch.models.raft import convert as raft_convert
from video_features_tpu_torch.models.raft.extract_raft import InputPadder
from video_features_tpu_torch.models.raft.model import FP32_PARAMS as RAFT_FP32_PARAMS
from video_features_tpu_torch.models.raft.model import RAFT, input_grid
from video_features_tpu_torch.models.raft.model import init_weights as raft_init
from video_features_tpu_torch.ops.preprocess import (
    device_resize_frames,
    dynamic_center_crop,
    flow_to_uint8,
    pil_resize,
    scale_to_1_1,
)
from video_features_tpu_torch.ops.resize import (
    fused_resize_crop_banded,
    resized_hw,
    shape_contract_banded,
)
from video_features_tpu_torch.ops.window import flow_output_bucket, pad_hw, spatial_bucket

MIN_SIDE_SIZE = 256
CENTRAL_CROP_SIZE = 224
DEFAULT_STACK_SIZE = 64
DEFAULT_STEP_SIZE = 64
# checkpoint file names looked up under --weights_path (a directory)
WEIGHT_FILES = {"rgb": "i3d_rgb.pt", "flow": "i3d_flow.pt", "raft": "raft-sintel.pth",
                "pwc": "pwc_net_sintel.pt"}
# the parameters each model keeps fp32 under --dtype bfloat16
FP32_PARAMS = {"rgb": I3D_FP32_PARAMS, "flow": I3D_FP32_PARAMS, "raft": RAFT_FP32_PARAMS,
               "pwc": PWC_FP32_PARAMS}


@functools.lru_cache(maxsize=256)
def _device_geometry(h: int, w: int, bucket_multiple: int, flow_type: str):
    """The shape contracts of a source resolution under ``--preprocess
    device``, as the JAX package's ``_device_geometry``:

    - rgb: min-edge-256 taps composed with the floor-offset 224 crop, a
      fixed (224, 224) output;
    - flow: min-edge-256 taps onto the flow net's grid, edge-replicated:
      for RAFT the InputPadder /8 grid rounded up to ``bucket_multiple``
      (``flow_output_bucket``), the image at the padder's place; for PWC
      the exact resized shape;
    - the (top, left) of the flow's 224 crop: where the host crops the
      padded flow at floor offsets, measured from where the grid places
      the image.
    """
    bh, bw = spatial_bucket(h, w, bucket_multiple)
    oh, ow = resized_hw(h, w, MIN_SIDE_SIZE)
    rgb_wy_t, rgb_wy_i, rgb_wx_t, rgb_wx_i = fused_resize_crop_banded(
        h, w, MIN_SIDE_SIZE, CENTRAL_CROP_SIZE, "bilinear",
        pad_h=bh, pad_w=bw, crop_offset="floor",
    )
    if flow_type == "raft":
        tgt_h, tgt_w = input_grid(oh, ow)
        out_h, out_w = flow_output_bucket(oh, ow, multiple=bucket_multiple)
        top, left = (out_h - oh) // 2, (out_w - ow) // 2
        fh = top + (tgt_h - CENTRAL_CROP_SIZE) // 2 - (tgt_h - oh) // 2
        fw = left + (tgt_w - CENTRAL_CROP_SIZE) // 2 - (tgt_w - ow) // 2
    else:  # pwc
        out_h, out_w, top, left = oh, ow, 0, 0
        fh = (oh - CENTRAL_CROP_SIZE) // 2
        fw = (ow - CENTRAL_CROP_SIZE) // 2
    if not (0 <= fh <= out_h - CENTRAL_CROP_SIZE and 0 <= fw <= out_w - CENTRAL_CROP_SIZE):
        raise AssertionError(
            f"flow crop {(fh, fw)} escapes the {(out_h, out_w)} grid for source {(h, w)}"
        )
    f_wy_t, f_wy_i, f_wx_t, f_wx_i = shape_contract_banded(
        h, w, MIN_SIDE_SIZE, out_h, out_w, top, left, "bilinear",
        pad_h=bh, pad_w=bw, pad_mode="edge",
    )
    return {
        "bucket": (bh, bw),
        "rgb": ((rgb_wy_t, rgb_wy_i), (rgb_wx_t, rgb_wx_i)),
        "flow": ((f_wy_t, f_wy_i), (f_wx_t, f_wx_i)),
        "crop": (fh, fw),
    }


def center_crop(x: torch.Tensor, crop: int = CENTRAL_CROP_SIZE) -> torch.Tensor:
    """(..., H, W, C) center crop at floor offsets."""
    H, W = x.shape[-3], x.shape[-2]
    fh, fw = (H - crop) // 2, (W - crop) // 2
    return x[..., fh : fh + crop, fw : fw + crop, :]


def rgb_chain(stack_tail: torch.Tensor) -> torch.Tensor:
    """RGB frames in [0, 255] -> I3D-rgb input."""
    return scale_to_1_1(center_crop(stack_tail))


def flow_chain(flow: torch.Tensor, crop=None) -> torch.Tensor:
    """Flow -> I3D-flow input: crop (at floor center offsets, or at the
    (top, left) of ``crop``), clamp and quantise, scale."""
    cropped = center_crop(flow) if crop is None else dynamic_center_crop(
        flow, *crop, CENTRAL_CROP_SIZE)
    return scale_to_1_1(flow_to_uint8(cropped))


class ExtractI3D(BaseExtractor):
    def __init__(self, config, external_call: bool = False) -> None:
        super().__init__(config, external_call)
        self.streams = list(self.config.streams or ["rgb", "flow"])
        self.stack_size = int(self.config.stack_size or DEFAULT_STACK_SIZE)
        self.step_size = int(self.config.step_size or DEFAULT_STEP_SIZE)
        self.stack_batch = max(int(self.config.batch_size or 1), 1)
        self.flow_type = self.config.flow_type

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
        elif kind == "raft":
            model, convert, init = RAFT(), raft_convert.convert_state_dict, raft_init
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
        kinds = self.streams + ([self.flow_type] if "flow" in self.streams else [])
        dt = compute_dtype(self.config)
        return {kind: cast_for_compute(self._model(kind).to(device).eval(), dt,
                                       exclude=FP32_PARAMS[kind])
                for kind in kinds}

    # --- host: decode and resize -------------------------------------------
    # A prepared video is T x 256 x W x 3 float32 and the pipeline keeps
    # decode_workers + 2 of them, so a byte budget gives the per-video
    # frame cap (``_prefetch_frame_cap``, in units of a min-side-256 4:3
    # frame; floor one 65-frame stack). A video over it is handed over as
    # ("deferred", entry) and decoded at dispatch, one resident at a time.
    PIPELINE_MAX_BYTES = 4 << 30
    _FRAME_BYTES = 256 * 342 * 3 * 4

    def _sample_grid(self, path: str):
        """The reference's I3D sampling grid: the ``--extraction_fps``
        linspace, upsampling to 65 frames (against the default stack of
        64, whatever ``--stack_size`` is) for a shorter video, or all
        frames. Returns (fps, sampled indices)."""
        fps, frame_cnt = probe(path)
        fps = fps_or_default(fps, path)
        if self.config.extraction_fps is not None:
            samples_num = max(int(frame_cnt / fps * self.config.extraction_fps), 1)
        elif frame_cnt < DEFAULT_STACK_SIZE + 1:
            samples_num = DEFAULT_STACK_SIZE + 1
        else:
            samples_num = frame_cnt
        if self.config.extraction_fps is None and frame_cnt >= DEFAULT_STACK_SIZE + 1:
            return fps, np.arange(frame_cnt)
        return fps, np.linspace(1, max(frame_cnt - 1, 1), samples_num).astype(int)

    def _sample_frames(self, path: str, grid=None):
        """(RGB frames, fps, timestamps_ms) on the grid (``_sample_grid``'s,
        or the one given); undecodable sampled indices are dropped, as the
        reference does."""
        fps, samples_ix = grid or self._sample_grid(path)
        got = read_frames_at_indices(path, samples_ix)
        kept = [i for i in samples_ix if i in got]
        mspf = 1000.0 / fps
        return [got[i] for i in kept], fps, [i * mspf for i in kept]

    def _decode(self, path: str, grid=None):
        """(min-side-256 float32 frames, fps, timestamps_ms); under
        ``--preprocess device`` the raw uint8 frames, resized on the
        device."""
        frames, fps, timestamps_ms = self._sample_frames(path, grid)
        if not frames:
            raise CorruptVideoError(f"no frames decoded from {path}")
        if self._device_preprocess_enabled():
            return frames, fps, timestamps_ms
        return [pil_resize(f, MIN_SIDE_SIZE).astype(np.float32) for f in frames], fps, timestamps_ms

    def prepare(self, entry):
        """Host half: (min-side-256 float32 frames, fps, timestamps_ms),
        raw frames under ``--preprocess device``, or ("deferred", entry)
        over the prefetch cap (counted in resized float32 frames; raw
        frames are restated in those units from the source resolution)."""
        path = video_path_of(entry)
        grid = self._sample_grid(path)
        cap = self._prefetch_frame_cap(self.PIPELINE_MAX_BYTES, self._FRAME_BYTES,
                                       floor=DEFAULT_STACK_SIZE + 1)
        cost = len(grid[1])
        if self._device_preprocess_enabled():
            h, w = frame_size(path)
            cost = max(cost * h * w * 3 // self._FRAME_BYTES, 1)
        if cost > cap:
            return ("deferred", entry)
        return self._decode(path, grid)

    # --- device --------------------------------------------------------------
    def flow(self, models: Dict[str, torch.nn.Module], stacks: torch.Tensor) -> torch.Tensor:
        """(B, S+1, H, W, 3) stacks -> (B, S, H', W', 2) flow: PWC's at
        (H, W); RAFT's at its padded grid, which the crop then reads."""
        if self.flow_type == "raft":
            stacks = InputPadder(stacks.shape[-3:-1]).pad_tensor(stacks)
        return models[self.flow_type](stacks)

    def _stacks(self, frames) -> List[tuple]:
        """The video's ``stack_size + 1``-frame stacks, as (frames, start,
        end), stacked only when their group is placed."""
        return [(frames, s, e)
                for s, e in form_slices(len(frames), self.stack_size + 1, self.step_size)]

    def _dispatch_stacks(self, models: Dict[str, torch.nn.Module],
                         stacks) -> List[Dict[str, HostCopy]]:
        """Enqueue the stacks ``--batch_size`` at a time, the last group
        zero-padded to that size (so a fused group runs at the solo path's
        shapes), each stream's features on their way to the host."""
        device = device_of(models)
        geom = None
        if self._device_preprocess_enabled() and stacks:
            frames0 = stacks[0][0]
            geom = _device_geometry(*frames0[0].shape[:2], int(self.config.spatial_bucket),
                                    self.flow_type)
            taps = {k: self._device_taps(geom[k], device) for k in ("rgb", "flow")}
        outs = []
        with torch.inference_mode():
            for g0 in range(0, len(stacks), self.stack_batch):
                chunk = stacks[g0 : g0 + self.stack_batch]
                x = stack_group([np.stack(f[s:e]) for f, s, e in chunk], pad_to=self.stack_batch)
                if geom is not None:  # raw uint8 onto the spatial bucket
                    x = pad_hw(x, *geom["bucket"])
                x = place_batch(x, device)  # (B, S+1, H, W, 3)
                feats = {}
                for stream in self.streams:
                    if stream == "rgb" and geom is None:
                        f, _ = models["rgb"](rgb_chain(x[:, :-1]))
                    elif stream == "rgb":
                        f, _ = models["rgb"](scale_to_1_1(
                            device_resize_frames(x[:, :-1], *taps["rgb"])))
                    elif geom is None:
                        f, _ = models["flow"](flow_chain(self.flow(models, x)))
                    else:  # the taps put the frames on the flow net's grid
                        flow = models[self.flow_type](device_resize_frames(x, *taps["flow"]))
                        f, _ = models["flow"](flow_chain(flow, geom["crop"]))
                    feats[stream] = HostCopy(f[: len(chunk)])
                outs.append(feats)
        return outs

    def _fetch_stacks(self, outs) -> Dict[str, np.ndarray]:
        return {
            s: (np.concatenate([o[s].numpy() for o in outs]).astype(np.float32) if outs
                else np.zeros((0, I3D_FEATURE_DIM), np.float32))
            for s in self.streams
        }

    # the split of the device half (extract/base.py)
    def dispatch_prepared(self, models: Dict[str, torch.nn.Module], payload):
        if isinstance(payload[0], str):  # ("deferred", entry): decode now
            payload = self._decode(video_path_of(payload[1]))
        frames, fps, timestamps_ms = payload
        return self._dispatch_stacks(models, self._stacks(frames)), fps, timestamps_ms

    def fetch_dispatched(self, handle) -> Dict[str, np.ndarray]:
        outs, fps, timestamps_ms = handle
        out = self._fetch_stacks(outs)
        out["fps"] = np.array(fps)
        out["timestamps_ms"] = np.array(timestamps_ms)
        return out

    # --- cross-video aggregation (--video_batch) ---------------------------
    # A corpus of short clips (one 65-frame stack each) dispatches one stack
    # per video through the deepest pipeline of the package: the flow net
    # over 64 pairs and two I3D towers. Same-resolution stacks share one
    # shape, so the stacks of several videos fill the --batch_size stack
    # groups instead of zero padding. A video too short for one stack, over
    # AGG_MAX_FRAMES sampled frames, or deferred takes the solo path.
    AGG_MAX_FRAMES = 256

    def agg_key(self, payload):
        if isinstance(payload[0], str) or self.config.show_pred:
            return None
        frames = payload[0]
        if len(frames) > self.AGG_MAX_FRAMES or len(frames) < self.stack_size + 1:
            return None
        # under --preprocess device the frames are raw, so this is the source
        # resolution, and the group shares one geometry
        return (frames[0].shape[:2], self.stack_size, self.step_size, tuple(self.streams),
                self.flow_type)

    def dispatch_group(self, models: Dict[str, torch.nn.Module], payloads):
        stacks = [self._stacks(frames) for frames, _, _ in payloads]
        outs = self._dispatch_stacks(models, [st for per_video in stacks for st in per_video])
        return outs, [len(st) for st in stacks], [(fps, ts) for _, fps, ts in payloads]

    def fetch_group(self, handle):
        outs, counts, metas = handle
        cat = self._fetch_stacks(outs)
        dicts, off = [], 0
        for count, (fps, timestamps_ms) in zip(counts, metas):
            d: Dict[str, np.ndarray] = {s: cat[s][off : off + count] for s in self.streams}
            d["fps"] = np.array(fps)
            d["timestamps_ms"] = np.array(timestamps_ms)
            dicts.append(d)
            off += count
        return dicts
