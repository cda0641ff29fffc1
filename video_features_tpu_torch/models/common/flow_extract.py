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
time (:460-574). ``--fps_retarget reencode`` decodes the reference's
ffmpeg re-encode instead of picking frames of the source
(``BaseExtractor._fps_source``). ``--show_pred`` (:258-270, :329-333)
takes the streaming path, where each window's frames are still in hand,
and hands each pair's flow and first frame to
``utils/flow_viz.py::show_flow_on_frame``.

``--preprocess device`` (:78-115, :343-): the windows hold the raw uint8
frames, zero-padded to their spatial bucket, and the video carries the
banded bilinear taps of its source resolution
(``ops/resize.py::shape_contract_banded``), which resize each frame to
``--side_size`` and place it on the model's grid (``_device_grid``) in one
gather: RAFT's InputPadder grid, its replicate pad inside the taps; PWC's
exact resized grid. The dispatch runs the taps on the device
(``device_resize_frames``) before the model. With no ``--side_size`` the
taps are the identity band, so the model's input equals the host's
``InputPadder.pad`` bit for bit. Fused windows of other source
resolutions share a key when their bucket and grid agree, each with its
video's taps.

``--dtype bfloat16``: the flow net's mixed-precision graph
(``models/raft/model.py``, ``models/pwc/model.py``), its weights cast
after loading, those in ``_fp32_params`` kept fp32. The windows stay
fp32 [0, 255] frames; the flow is fp32.

``--sharding mesh`` (:40-55, :140-172): sequence parallelism over the
frame axis. The flow net is replicated on the mesh's data rows
(``parallel/sharding.py::replicate``); a window's B+1 frames go through
``halo_split``, so row ``r`` runs the unchanged model on its ``b_r + 1``
frames and returns its ``b_r`` pairs (PWC's cost volumes at ``N = b_r``
on each row), and the pairs gather onto the first device in order (in a
mesh across launched processes, each process runs its own rows and
every row's pairs gather onto every process). Under
``--preprocess device`` the raw window splits so and the taps are
replicated on each row. With ``--video_batch`` the fused windows split
over the rows whole (data parallel), so no pair couples two videos; a
device payload is not fused on a mesh (``agg_key``), as in the JAX
package. The JAX package's last-frame mesh fill has no counterpart: a
list of per-row tensors may be uneven.

Output: ``{<feature_type>: (T-1, 2, H, W), fps, timestamps_ms}``, flow at
the frames' resolution.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from video_features_tpu_torch.extract.base import BaseExtractor, device_of
from video_features_tpu_torch.extract.ingest import (
    HostCopy,
    place_batch,
    stack_group,
    stack_taps,
)
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
from video_features_tpu_torch.ops.preprocess import device_resize_frames, pil_resize
from video_features_tpu_torch.ops.resize import resized_hw, shape_contract_banded
from video_features_tpu_torch.ops.window import pad_hw, spatial_bucket
from video_features_tpu_torch.parallel.sharding import (
    Replicas,
    gather_rows,
    halo_split,
    is_mesh,
    replicate,
)
from video_features_tpu_torch.utils import flow_viz


class NullPadder:
    """No host-side padding (PWC)."""

    def pad(self, x: np.ndarray) -> np.ndarray:
        return x

    def unpad(self, x):
        return x


class PairwiseFlowExtractor(BaseExtractor):
    """Subclasses set ``checkpoint`` (what ``--weights_path`` should
    hold) and ``_fp32_params`` (the parameters a bf16 model keeps fp32),
    implement ``_model()`` (the module), ``_convert_state_dict(sd)``,
    ``_params_from_jax(params)`` and ``_init_weights(model)``, and
    optionally ``_make_padder(shape)``."""

    checkpoint = ""
    _fp32_params: tuple = ()
    # --sharding mesh: sequence parallel over each window's frame axis
    # (halo_split), the weights replicated (parallel/scheduler.py reads this)
    mesh_capable = True

    def __init__(self, config, external_call: bool = False) -> None:
        super().__init__(config, external_call)
        self.batch_size = max(int(self.config.batch_size or 1), 1)

    def _model(self) -> torch.nn.Module:
        raise NotImplementedError

    @staticmethod
    def _convert_state_dict(sd):
        raise NotImplementedError

    @staticmethod
    def _params_from_jax(params):
        raise NotImplementedError

    @staticmethod
    def _init_weights(model):
        raise NotImplementedError

    def _make_padder(self, shape):
        return NullPadder()

    def _build(self, device):
        """The flow net on ``device``; on a mesh, one copy a distinct
        device of its data rows (``sharding.replicate``)."""
        if is_mesh(device):
            return replicate(self._build, device)
        model = self._model()
        if self.config.weights_path:
            sd = load_params(self.config.weights_path, self._convert_state_dict,
                             self._params_from_jax)
            load_checked(model, sd, self.feature_type)
        else:
            random_init_fallback(self.config, self.feature_type, self.checkpoint)
            self._init_weights(model)
        return cast_for_compute(model.to(device).eval(), compute_dtype(self.config),
                                exclude=self._fp32_params)

    def _preprocess(self, frame: np.ndarray) -> np.ndarray:
        if self.config.side_size is not None:
            frame = pil_resize(frame, int(self.config.side_size),
                               self.config.resize_to_smaller_edge)
        return frame.astype(np.float32)

    # --- the device preprocess's shape contract ---------------------------
    def _device_grid(self, oh: int, ow: int):
        """(out_h, out_w, top, left): where the resized (oh, ow) image lands
        on the model's input grid. Here the exact resized shape (PWC, whose
        /64 stretch is part of its forward); RAFT places it on its
        InputPadder grid."""
        return oh, ow, 0, 0

    def _device_contract(self, h: int, w: int):
        """(taps, (bh, bw), (oh, ow)) of a source resolution: the banded
        taps onto ``_device_grid``, the spatial bucket the raw frames pad
        to, and the resized shape the video's padder (and so ``unpad``) is
        built from."""
        side = int(self.config.side_size) if self.config.side_size is not None else 0
        smaller = bool(self.config.resize_to_smaller_edge)
        oh, ow = resized_hw(h, w, side, smaller) if side else (h, w)
        out_h, out_w, top, left = self._device_grid(oh, ow)
        bh, bw = spatial_bucket(h, w, self.config.spatial_bucket)
        wt_y, idx_y, wt_x, idx_x = shape_contract_banded(
            h, w, side, out_h, out_w, top, left, "bilinear",
            pad_h=bh, pad_w=bw, pad_mode="edge", smaller_edge=smaller,
        )
        return ((wt_y, idx_y), (wt_x, idx_x)), (bh, bw), (oh, ow)

    # --- host: an eager prepare, capped in bytes --------------------------
    # A prepared video holds its padded windows; the pipeline keeps up to
    # decode_workers + 2 prepared videos, so the byte budget splits into a
    # per-video frame cap (``_prefetch_frame_cap``). A video over it is
    # handed over as ("stream", entry): its decode then interleaves with
    # its windows' forwards at dispatch, one such video resident at a time.
    # Under --preprocess device a window frame is a uint8 frame at its
    # spatial bucket, so more frames fit under the same budget.
    PIPELINE_MAX_BYTES = 4 << 30

    def _window_cap(self, padded_frame: np.ndarray) -> int:
        """The prefetch cap in frames, given one padded frame."""
        return self._prefetch_frame_cap(self.PIPELINE_MAX_BYTES, padded_frame.nbytes,
                                        floor=4 * self.batch_size)

    def _fps(self, path: str) -> float:
        return self.config.extraction_fps or fps_or_default(
            probe(path, self.config.decoder)[0], path)

    def _layout(self, h: int, w: int):
        """(padder, taps, bucket) of a video of source resolution (h, w):
        the padder of the resized frame, and under ``--preprocess device``
        the contract's taps and bucket (None on the host chain)."""
        if self._device_preprocess_enabled():
            taps, bucket, resized = self._device_contract(h, w)
            return self._make_padder(resized), taps, bucket
        side = self.config.side_size
        resized = (resized_hw(h, w, int(side), bool(self.config.resize_to_smaller_edge))
                   if side is not None else (h, w))
        return self._make_padder(resized), None, None

    def _windows(self, source, timestamps_ms: List[float], capped: bool):
        """Decode ``source`` (``_fps_source``'s decode path and selection
        fps) into padded B+1-frame windows, yielding (window, pairs,
        (padder, taps)) as each fills and appending each frame's timestamp
        to ``timestamps_ms``. The tail window repeats its last frame, so
        every window has one shape; its surplus pairs are cut after the
        forward. With ``capped``, yield None and stop once the video
        passes the prefetch cap."""
        path, sel_fps = source
        batch: List[np.ndarray] = []
        layout = cap = None
        frames = stream_frames(path, sel_fps, self.config.decoder)
        for count, (frame, ts) in enumerate(frames, 1):
            if layout is None:
                layout = self._layout(*frame.shape[:2])
            if layout[2] is None:  # the host chain
                frame = self._preprocess(frame)
            if cap is None and capped:
                cap = self._window_cap(self._pad_window([frame], layout)[0])
            if cap is not None and count > cap:
                yield None
                return
            timestamps_ms.append(ts)
            batch.append(frame)
            # B+1 frames make B pairs; the boundary frame carries over
            if len(batch) - 1 == self.batch_size:
                yield self._pad_window(batch, layout), len(batch) - 1, layout[:2]
                batch = [batch[-1]]
        if len(batch) > 1:
            yield self._pad_window(batch, layout), len(batch) - 1, layout[:2]
        if layout is None:
            raise CorruptVideoError(f"no frames decoded from {path}")

    def _pad_window(self, batch: List[np.ndarray], layout) -> np.ndarray:
        """Frames -> one (B+1, ...) window, padded by the padder on the host
        chain and zero-padded to the bucket under ``--preprocess device``."""
        padder, _, bucket = layout
        window = np.stack(batch + [batch[-1]] * (self.batch_size + 1 - len(batch)))
        return padder.pad(window) if bucket is None else pad_hw(window, *bucket)

    def prepare(self, entry):
        """Host half: (padded (B+1, Hp, Wp, 3) windows, their pair counts,
        padder, taps, fps, timestamps_ms), or ("stream", entry, source)
        over the cap (the resolved decode source travels, so a re-encode
        is not run twice), or ("stream", entry) under ``--show_pred``;
        taps are None on the host chain."""
        if self.config.show_pred:
            # the pairs are drawn over their frames: the streaming path
            # keeps each window's frames in hand
            return ("stream", entry)
        path = video_path_of(entry)
        source = self._fps_source(path)
        windows: List[np.ndarray] = []
        n_pairs: List[int] = []
        timestamps_ms: List[float] = []
        padder = taps = None
        for item in self._windows(source, timestamps_ms, capped=True):
            if item is None:
                return ("stream", entry, source)
            window, n, (padder, taps) = item
            windows.append(window)
            n_pairs.append(n)
        return windows, n_pairs, padder, taps, self._fps(path), timestamps_ms

    # --- the device half, split (extract/base.py) --------------------------
    def _dispatch_window(self, model: torch.nn.Module, window: np.ndarray, n_pairs: int,
                         padder, taps) -> HostCopy:
        """One padded window -> its (n, 2, H, W) flows on their way to the
        host, surplus pairs cut; ``taps`` (host) resize a uint8 window on
        the device first. On a mesh the window's frames split over the
        data rows with their halo frame (``halo_split``), each row's pairs
        come from its own copy of the net, and they gather in order (onto
        every process of a mesh across launched processes)."""
        with torch.inference_mode():
            mesh = isinstance(model, Replicas)
            if mesh:
                parts, sizes = halo_split(window, model.mesh)
            else:
                parts = [place_batch(window, device_of(model))]
            if taps is not None:
                parts = [device_resize_frames(x, *self._device_taps(taps, x.device))
                         for x in parts]
            flow = (gather_rows(model(parts), model.device, sizes, model.mesh) if mesh
                    else model(parts[0]))
            return HostCopy(padder.unpad(flow)[:n_pairs].permute(0, 3, 1, 2))

    def _stream(self, model: torch.nn.Module, entry, source=None) -> Dict[str, np.ndarray]:
        """A video over the prefetch cap, or under ``--show_pred``: decode
        interleaved with its windows' forwards, so it is never held whole.
        ``source`` is prepare's resolved decode source, if it made one.
        Under ``--show_pred`` each window is fetched at once and every
        pair's flow drawn over the pair's first frame (the host chain's:
        ``sanity_check`` refuses the flag with ``--preprocess device``)."""
        path = video_path_of(entry)
        source = source or self._fps_source(path)
        timestamps_ms: List[float] = []
        flows = []
        for w, n, (padder, taps) in self._windows(source, timestamps_ms, capped=False):
            flows.append(self._dispatch_window(model, w, n, padder, taps))
            if self.config.show_pred:
                flow, frames = flows[-1].numpy().transpose(0, 2, 3, 1), padder.unpad(w)
                for i in range(n):
                    flow_viz.show_flow_on_frame(flow[i], frames[i])
        return self._flow_dict([f.numpy() for f in flows], self._fps(path), timestamps_ms)

    def _flow_dict(self, flows: List[np.ndarray], fps, timestamps_ms) -> Dict[str, np.ndarray]:
        """Per-window (n, 2, H, W) flows -> the video's feature dict."""
        return {
            self.feature_type: np.array([f for w in flows for f in w]),
            "fps": np.array(fps),
            "timestamps_ms": np.array(timestamps_ms),
        }

    def dispatch_prepared(self, model: torch.nn.Module, payload):
        if isinstance(payload[0], str):  # ("stream", entry[, source])
            return ("done", self._stream(model, *payload[1:]))
        windows, n_pairs, padder, taps, fps, timestamps_ms = payload
        outs = [self._dispatch_window(model, w, n, padder, taps)
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
        windows, _, _, taps = payload[:4]
        # a 1-frame video makes no pairs, hence no windows: nothing to fuse
        if not windows or len(windows) * windows[0].nbytes > self.AGG_MAX_BYTES:
            return None
        if taps is None:
            return windows[0].shape  # (B+1, Hp, Wp, 3)
        if self.config.sharding == "mesh":
            # as in the JAX package, a mesh fuses host windows only: its
            # device payloads run the solo window's sequence parallelism
            return None
        # --preprocess device: (B+1, bh, bw, 3) uint8 and the grid and K of
        # the taps, so source resolutions sharing the contract fuse
        return ("dev", windows[0].shape, taps[0][0].shape, taps[1][0].shape)

    def dispatch_group(self, model: torch.nn.Module, payloads):
        """The windows of the group's videos, G at a time, as (G, B+1, Hp,
        Wp, 3) forwards; the last forward is not padded to G windows. Under
        ``--preprocess device`` each window resizes with its video's taps.
        On a mesh the G windows split over the data rows whole (data
        parallel: each window's pairs stay on one row)."""
        group = max(int(self.config.video_batch or 1), 1)
        device = device_of(model)
        flat_w = [w for p in payloads for w in p[0]]
        flat_taps = [p[3] and self._device_taps(p[3], device) for p in payloads for _ in p[0]]
        outs = []
        with torch.inference_mode():
            for i in range(0, len(flat_w), group):
                if isinstance(model, Replicas):  # host windows only (agg_key)
                    outs.append(HostCopy(model.run(stack_group(flat_w[i : i + group]))))
                    continue
                x = place_batch(stack_group(flat_w[i : i + group]), device)
                if flat_taps[i] is not None:
                    x = device_resize_frames(x, *stack_taps(flat_taps[i : i + group]))
                outs.append(HostCopy(model(x)))  # (g, B, Hp, Wp, 2)
        metas = [(p[1], p[2], p[4], p[5]) for p in payloads]
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
