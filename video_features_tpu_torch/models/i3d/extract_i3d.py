"""I3D two-stream extractor: RGB and optical-flow Kinetics features over
sliding stacks of frames, with flow computed on the fly by PWC-Net or
RAFT, or read from disk as flow JPEGs (``--flow_type``).

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
``i3d_flow.pt``, ``raft-sintel.pth`` and ``pwc_net_sintel.pt`` (each a
reference state dict or, as in the JAX package, an orbax checkpoint
directory under that name); a missing file is an error unless
``--allow_random_init``. Output: ``{rgb: (S,
1024), flow: (S, 1024), fps, timestamps_ms}``, saved as
``<stem>_rgb.npy`` and ``<stem>_flow.npy``. With ``--video_batch N`` the
stacks of N same-resolution clips fill the ``--batch_size`` stack groups.
``--show_pred`` prints each stack's top-5 Kinetics-400 classes per
stream, as the JAX package does (``:1026-1030``); such a video is not
fused with others, so the lines stay per video.

``--flow_type flow`` (:633-703, :751-781): a path entry is a (video,
flow dir) pair (``io/paths.py``), the dir holding ``flow_x_<n>.jpg`` /
``flow_y_<n>.jpg`` of the uint8-quantized flow (``save_jpg``'s files,
paired by numeric suffix). Each pair is decoded once, in fp32 whatever
``--dtype`` (the JAX package's declared fp32 island), and the flow
stream runs ``disk_flow_chain``: crop 224 and [-1, 1], with no second
quantization (the divergence from the reference PARITY.md documents).
The frames and the flow pairs are zipped: the windows are ``stack_size``
frames over the shorter of the two, the rgb stream takes the first
``stack_size - 1`` of each window (the JAX package's ``[:, :-1]``), and
no flow model runs. Such payloads are not fused, as in the JAX package.

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

``--sharding mesh`` (the JAX package's :176-193, :376-459, :811-827):
sequence parallelism over each stack's frame axis, one stack at a time
(``--batch_size`` pinned to 1), every net replicated on the mesh's data
rows (``parallel/sharding.py::replicate``). The split is chosen once per
stack, in blocks of 8 frames (I3D's cumulative temporal stride; only the
last block ragged, and a row left without frames sits out):

- rgb: the stack's first ``stack_size`` frames through ``split_rows``;
- flow from RAFT or PWC: the ``stack_size + 1`` frames through
  ``halo_split``, so row ``r``'s pairs are exactly the rgb split's block
  ``r``; each row runs the flow net (PWC's cost volumes at ``N = b_r``)
  and ``flow_chain`` on its own frames, and the flow never moves;
- flow from disk: the flow images through ``split_rows``.

Each stream's blocks then go through ``I3D.forward_sharded`` (the time
halos of its temporal convs and pools, the time mean a sum over blocks).
Under ``--preprocess device`` the raw uint8 stack splits so, with the
taps and the flow crop offsets on each row. Nothing is fused across
videos on a mesh (``agg_key``).
"""

from __future__ import annotations

import functools
import os
import pathlib
from typing import Dict, List, Tuple

import cv2
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
from video_features_tpu_torch.models.common.layers import explicit_conv3d_impl, set_conv3d_impl
from video_features_tpu_torch.models.common.weights import (
    cast_for_compute,
    compute_dtype,
    load_checked,
    load_params,
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
from video_features_tpu_torch.parallel.sharding import (
    Replicas,
    halo_split,
    is_mesh,
    replicate,
    split_rows,
    stand_ins,
)
from video_features_tpu_torch.utils.labels import show_predictions_on_dataset

MIN_SIDE_SIZE = 256
CENTRAL_CROP_SIZE = 224
# a mesh's time blocks: I3D's cumulative temporal stride (the stem and the
# two strided max pools), so each block's strided outputs are its own
TIME_BLOCK = 8
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


def disk_flow_chain(flow_imgs: torch.Tensor) -> torch.Tensor:
    """Flow JPEGs -> I3D-flow input: crop 224 and [-1, 1]. The JPEGs hold
    the uint8-QUANTIZED flow already (``save_jpg``'s 128 + 255/40 f map),
    so only the scaling remains; the reference's second clamp and
    quantization of the 0..255 pixels is the divergence PARITY.md
    documents."""
    return scale_to_1_1(center_crop(flow_imgs))


class ExtractI3D(BaseExtractor):
    # --sharding mesh: each stack's frame axis over 'data' (sequence
    # parallelism, time halos), the weights replicated
    # (parallel/scheduler.py reads this)
    mesh_capable = True

    def __init__(self, config, external_call: bool = False) -> None:
        super().__init__(config, external_call)
        self.streams = list(self.config.streams or ["rgb", "flow"])
        self.stack_size = int(self.config.stack_size or DEFAULT_STACK_SIZE)
        self.step_size = int(self.config.step_size or DEFAULT_STEP_SIZE)
        # a mesh shards one stack's frame axis: one stack a forward, as the
        # JAX package pins B=1 there
        self.stack_batch = (1 if self.config.sharding == "mesh"
                            else max(int(self.config.batch_size or 1), 1))
        self.flow_type = self.config.flow_type
        # --conv3d_impl for THIS extractor's I3D models (None: auto)
        self.conv_impl = explicit_conv3d_impl(self.config)

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
            model, convert, init = PWCNet(), pwc_convert, pwc_init
        elif kind == "raft":
            model, convert, init = RAFT(), raft_convert, raft_init
        else:
            model, convert, init = I3D(IN_CHANNELS[kind]), i3d_convert, i3d_init
        path = self._weights_file(kind)
        if path is None:
            root = self.config.weights_path
            expected = (os.path.join(root, WEIGHT_FILES[kind]) if root
                        else f"a directory containing {WEIGHT_FILES[kind]}")
            random_init_fallback(self.config, f"i3d[{kind}]", expected)
            init(model)
        else:
            # the JAX package's lookup: a file under its reference name, which
            # may be an orbax directory (a .msgpack is not looked for)
            load_checked(model, load_params(path, convert.convert_state_dict,
                                            convert.params_from_jax), f"i3d[{kind}]")
        return set_conv3d_impl(model, self.conv_impl)

    def _build(self, device) -> Dict[str, torch.nn.Module]:
        """Each stream's I3D and the flow net (unless the flow is read from
        disk) on ``device``; on a mesh, each replicated over its data rows
        (``sharding.replicate``)."""
        kinds = self.streams + ([self.flow_type] if "flow" in self.streams
                                and self.flow_type != "flow" else [])
        if is_mesh(device):
            return {kind: replicate(functools.partial(self._built, kind), device)
                    for kind in kinds}
        return {kind: self._built(kind, device) for kind in kinds}

    def _built(self, kind: str, device: torch.device) -> torch.nn.Module:
        return cast_for_compute(self._model(kind).to(device).eval(),
                                compute_dtype(self.config), exclude=FP32_PARAMS[kind])

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
        fps, frame_cnt = probe(path, self.config.decoder)
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
        got = read_frames_at_indices(path, samples_ix, self.config.decoder)
        kept = [i for i in samples_ix if i in got]
        mspf = 1000.0 / fps
        return [got[i] for i in kept], fps, [i * mspf for i in kept]

    # graftcheck: fp32-island — host PIL-parity decode (--preprocess host):
    # pil_resize wants float pixels; the production path is --preprocess
    # device, which ships uint8 and resizes on the card (4x fewer bytes)
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

    def _load_flow_pairs(self, flow_dir: str):
        """The dir's flow_x_*/flow_y_* JPEG pairs in numeric suffix order;
        the x and y suffixes must match pair by pair, so one missing file
        fails loudly instead of shifting every later pair."""
        def key(p):
            sfx = p.stem[7:]
            return (0, int(sfx)) if sfx.isdigit() else (1, sfx)

        xs = sorted(pathlib.Path(flow_dir).glob("flow_x*.jpg"), key=key)
        ys = sorted(pathlib.Path(flow_dir).glob("flow_y*.jpg"), key=key)
        if len(xs) != len(ys):
            raise ValueError(f"{flow_dir}: {len(xs)} flow_x vs {len(ys)} flow_y images")
        for x, y in zip(xs, ys):
            if x.stem[7:] != y.stem[7:]:
                raise ValueError(f"flow pair mismatch: {x.name} vs {y.name}")
        return list(zip(xs, ys))

    # graftcheck: fp32-island — precomputed-flow ingest: grayscale JPEGs
    # already encode clamped flow, decoded float here for the [-20, 20]
    # un-mapping; this input mode never takes the uint8 wire
    def _read_flow_images(self, flow_dir: str, pairs=None) -> np.ndarray:
        """Every flow JPEG pair decoded ONCE -> (N, H, W, 2) float32 (the
        windows overlap when step < stack; decoding per window would read
        the files again). fp32 whatever ``--dtype``: the pixels are the
        flow's uint8 levels, which the I3D-flow model's input cast takes
        as they are. ``pairs`` reuses a ``_load_flow_pairs`` scan."""
        if pairs is None:
            pairs = self._load_flow_pairs(flow_dir)
        if not pairs:
            return np.zeros((0, 1, 1, 2), np.float32)
        imgs = np.stack([
            np.stack([cv2.imread(str(fx), cv2.IMREAD_GRAYSCALE),
                      cv2.imread(str(fy), cv2.IMREAD_GRAYSCALE)], axis=-1)
            for fx, fy in pairs
        ]).astype(np.float32)
        if min(imgs.shape[1:3]) < CENTRAL_CROP_SIZE:
            raise ValueError(f"flow images {imgs.shape[1:3]} are smaller than the "
                             f"{CENTRAL_CROP_SIZE}px center crop")
        return imgs

    def _flow_prefetch_cost(self, pairs) -> int:
        """The disk flow's resident cost in resized-frame units: the JPEGs
        stay at their own resolution until the device crop, so a 1080p
        flow dir can dwarf the frames the cap was sized for. PIL reads
        the first image's header for the size."""
        if not pairs:
            return 0
        from PIL import Image

        try:
            with Image.open(pairs[0][0]) as im:
                w, h = im.size
        except OSError:  # unreadable: _read_flow_images raises later
            return 0
        return len(pairs) * (h * w * 2 * 4) // self._FRAME_BYTES

    def _flow_dir(self, entry):
        """The entry's flow dir under ``--flow_type flow``, else None."""
        if self.flow_type != "flow":
            return None
        if not isinstance(entry, (tuple, list)) or len(entry) != 2:
            raise ValueError(
                "--flow_type flow needs (video, flow_dir) pairs; provide "
                "--flow_paths / --flow_dir alongside the videos"
            )
        return entry[1]

    def prepare(self, entry):
        """Host half: (min-side-256 float32 frames, fps, timestamps_ms,
        flow images or None, video path), raw frames under ``--preprocess
        device``, or ("deferred", entry) over the prefetch cap (counted in
        resized float32 frames; raw frames are restated in those units
        from the source resolution, and disk flow adds its images)."""
        path = video_path_of(entry)
        flow_dir = self._flow_dir(entry)
        grid = self._sample_grid(path)
        cap = self._prefetch_frame_cap(self.PIPELINE_MAX_BYTES, self._FRAME_BYTES,
                                       floor=DEFAULT_STACK_SIZE + 1)
        cost = len(grid[1])
        if self._device_preprocess_enabled():
            h, w = frame_size(path, self.config.decoder)
            cost = max(cost * h * w * 3 // self._FRAME_BYTES, 1)
        pairs = self._load_flow_pairs(flow_dir) if flow_dir is not None else None
        cost += self._flow_prefetch_cost(pairs)
        if cost > cap:
            # frames AND disk flow wait for the dispatch, one such video
            # resident at a time
            return ("deferred", entry)
        flow_imgs = self._read_flow_images(flow_dir, pairs) if flow_dir is not None else None
        return (*self._decode(path, grid), flow_imgs, path)

    # --- device --------------------------------------------------------------
    def flow(self, models: Dict[str, torch.nn.Module], stacks: torch.Tensor) -> torch.Tensor:
        """(B, S+1, H, W, 3) stacks -> (B, S, H', W', 2) flow: PWC's at
        (H, W); RAFT's at its padded grid, which the crop then reads."""
        return models[self.flow_type](self._flow_input(stacks))

    def _flow_input(self, stacks: torch.Tensor) -> torch.Tensor:
        """The flow net's input: RAFT's InputPadder grid, PWC's frames."""
        if self.flow_type == "raft":
            return InputPadder(stacks.shape[-3:-1]).pad_tensor(stacks)
        return stacks

    def _stacks(self, frames, flow_imgs=None) -> List[tuple]:
        """The video's stacks, as (frames, flow images, start, end),
        stacked only when their group is placed: ``stack_size + 1`` frames
        (``stack_size`` pairs for the flow net); with disk flow
        ``stack_size`` frames and flow images over the shorter of the two,
        as the reference zips them."""
        window, extent = self.stack_size + 1, len(frames)
        if flow_imgs is not None:
            window, extent = self.stack_size, min(len(frames), len(flow_imgs))
        return [(frames, flow_imgs, s, e)
                for s, e in form_slices(extent, window, self.step_size)]

    def _dispatch_stacks(self, models: Dict[str, torch.nn.Module],
                         stacks) -> List[Dict[str, tuple]]:
        """Enqueue the stacks ``--batch_size`` at a time, the last group
        zero-padded to that size (so a fused group runs at the solo path's
        shapes), each stream's (features, logits under ``--show_pred``) on
        their way to the host. On a mesh: ``_dispatch_stacks_sharded``."""
        if isinstance(models[self.streams[0]], Replicas):
            return self._dispatch_stacks_sharded(models, stacks)
        device = device_of(models)
        geom = self._geometry(stacks)
        if geom is not None:
            taps = {k: self._device_taps(geom[k], device) for k in ("rgb", "flow")}
        outs = []
        with torch.inference_mode():
            for g0 in range(0, len(stacks), self.stack_batch):
                chunk = stacks[g0 : g0 + self.stack_batch]
                x = stack_group([np.stack(f[s:e]) for f, _, s, e in chunk],
                                pad_to=self.stack_batch)
                if geom is not None:  # raw uint8 onto the spatial bucket
                    x = pad_hw(x, *geom["bucket"])
                x = place_batch(x, device)  # (B, S+1, H, W, 3); S with disk flow
                fl = None
                if chunk[0][1] is not None:  # disk flow: (B, S, H', W', 2)
                    fl = place_batch(stack_group([fi[s:e] for _, fi, s, e in chunk],
                                                 pad_to=self.stack_batch), device)
                feats = {}
                for stream in self.streams:
                    if stream == "rgb" and geom is None:
                        f, logits = models["rgb"](rgb_chain(x[:, :-1]))
                    elif stream == "rgb":
                        f, logits = models["rgb"](scale_to_1_1(
                            device_resize_frames(x[:, :-1], *taps["rgb"])))
                    elif fl is not None:
                        f, logits = models["flow"](disk_flow_chain(fl))
                    elif geom is None:
                        f, logits = models["flow"](flow_chain(self.flow(models, x)))
                    else:  # the taps put the frames on the flow net's grid
                        flow = models[self.flow_type](device_resize_frames(x, *taps["flow"]))
                        f, logits = models["flow"](flow_chain(flow, geom["crop"]))
                    # the 400-class logits cross only for --show_pred
                    feats[stream] = (HostCopy(f[: len(chunk)]),
                                     HostCopy(logits[: len(chunk)]) if self.config.show_pred
                                     else None)
                outs.append(feats)
        return outs

    def _geometry(self, stacks):
        """``_device_geometry`` of the stacks' source resolution under
        ``--preprocess device``, else None."""
        if not (self._device_preprocess_enabled() and stacks):
            return None
        return _device_geometry(*stacks[0][0][0].shape[:2], int(self.config.spatial_bucket),
                                self.flow_type)

    def _stream_blocks(self, models, stream: str, stack: np.ndarray, flow_imgs,
                       geom) -> Tuple[List[torch.Tensor], List[int]]:
        """One stack's input to ``stream``'s I3D as (1, T_r, 224, 224, C)
        time blocks on this process's data rows (module docstring), and
        every row's block size: ``stack`` is the host window (raw uint8 on
        its bucket under ``--preprocess device``), ``flow_imgs`` the
        window's disk flow or None."""
        mesh = models[stream].mesh
        if stream == "rgb":
            parts, sizes = split_rows(stack[:-1], mesh, TIME_BLOCK)
            if geom is None:
                return [rgb_chain(p[None]) for p in parts], sizes
            return [scale_to_1_1(device_resize_frames(
                p[None], *self._device_taps(geom["rgb"], p.device))) for p in parts], sizes
        if flow_imgs is not None:
            parts, sizes = split_rows(flow_imgs, mesh, TIME_BLOCK)
            return [disk_flow_chain(p[None]) for p in parts], sizes
        # the pairs of row r are the rgb split's block r
        parts, sizes = halo_split(stack, mesh, TIME_BLOCK)
        if geom is None:
            flows = models[self.flow_type]([self._flow_input(p[None]) for p in parts])
            return [flow_chain(f) for f in flows], sizes
        flows = models[self.flow_type]([device_resize_frames(
            p[None], *self._device_taps(geom["flow"], p.device)) for p in parts])
        return [flow_chain(f, geom["crop"]) for f in flows], sizes

    def _dispatch_stacks_sharded(self, models: Dict[str, Replicas],
                                 stacks) -> List[Dict[str, tuple]]:
        """The mesh's dispatch: one stack at a time, each stream's time
        blocks (``_stream_blocks``) through ``I3D.forward_sharded`` over the
        stream's replicas, the (1, 1024) features and logits landing on the
        first device. On a mesh across launched processes the blocks and
        replicas of the other processes' rows stand in on the ``meta``
        device (``sharding.stand_ins``: a (1, T_r, 224, 224, C) block of
        the row's size, ``Replicas.row_modules``), and the features land
        on every process."""
        geom = self._geometry(stacks)
        outs = []
        with torch.inference_mode():
            for frames, flow_imgs, s, e in stacks:
                stack = np.stack(frames[s:e])  # (S+1, H, W, 3); S with disk flow
                if geom is not None:  # raw uint8 onto the spatial bucket
                    stack = pad_hw(stack, *geom["bucket"])
                fl = flow_imgs[s:e] if flow_imgs is not None else None
                feats = {}
                for stream in self.streams:
                    i3d = models[stream]
                    blocks, sizes = self._stream_blocks(models, stream, stack, fl, geom)
                    channels = 3 if stream == "rgb" else 2
                    blocks = stand_ins(blocks, i3d.mesh, sizes, lambda t, c=channels: (
                        1, t, CENTRAL_CROP_SIZE, CENTRAL_CROP_SIZE, c))
                    f, logits = i3d.copies[0].forward_sharded(blocks, i3d.row_modules(sizes),
                                                              i3d.mesh)
                    feats[stream] = (HostCopy(f), HostCopy(logits) if self.config.show_pred
                                     else None)
                outs.append(feats)
        return outs

    def _fetch_stacks(self, outs) -> Dict[str, np.ndarray]:
        return {
            s: (np.concatenate([o[s][0].numpy() for o in outs]).astype(np.float32) if outs
                else np.zeros((0, I3D_FEATURE_DIM), np.float32))
            for s in self.streams
        }

    # the split of the device half (extract/base.py)
    def dispatch_prepared(self, models: Dict[str, torch.nn.Module], payload):
        if isinstance(payload[0], str):  # ("deferred", entry): decode now
            entry = payload[1]
            flow_dir = self._flow_dir(entry)
            payload = (*self._decode(video_path_of(entry)),
                       self._read_flow_images(flow_dir) if flow_dir is not None else None,
                       video_path_of(entry))
        frames, fps, timestamps_ms, flow_imgs, path = payload
        outs = self._dispatch_stacks(models, self._stacks(frames, flow_imgs))
        return outs, fps, timestamps_ms, path

    def fetch_dispatched(self, handle) -> Dict[str, np.ndarray]:
        outs, fps, timestamps_ms, path = handle
        out = self._fetch_stacks(outs)
        # --show_pred: each stack's top-5 per stream, group by group, as
        # the JAX package prints them
        for g, group in enumerate(outs):
            for stream in self.streams:
                logits = group[stream][1]
                if logits is None:
                    continue
                for j, row in enumerate(logits.numpy()):
                    print(f"{path} @ stack {g * self.stack_batch + j} ({stream} stream)")
                    show_predictions_on_dataset(row, "kinetics")
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
        # deferred videos, disk flow (zipped frame and flow-image payloads,
        # as in the JAX package), --show_pred (per-video prints) and a mesh
        # (one stack at a time) stay solo
        if (isinstance(payload[0], str) or payload[3] is not None or self.config.show_pred
                or self.config.sharding == "mesh"):
            return None
        frames = payload[0]
        if len(frames) > self.AGG_MAX_FRAMES or len(frames) < self.stack_size + 1:
            return None
        # under --preprocess device the frames are raw, so this is the source
        # resolution, and the group shares one geometry
        return (frames[0].shape[:2], self.stack_size, self.step_size, tuple(self.streams),
                self.flow_type)

    def dispatch_group(self, models: Dict[str, torch.nn.Module], payloads):
        stacks = [self._stacks(p[0]) for p in payloads]
        outs = self._dispatch_stacks(models, [st for per_video in stacks for st in per_video])
        return outs, [len(st) for st in stacks], [(p[1], p[2]) for p in payloads]

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
