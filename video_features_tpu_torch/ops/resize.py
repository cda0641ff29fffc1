"""Resizes: ``F.interpolate``-semantics bilinear (PWC's /64 stretch), and
the host-built taps of ``--preprocess device``.

Counterpart of ``video_features_tpu/ops/resize.py``.

- ``resize_bilinear`` (:54-89 there), which PWC bakes into its forward
  (the /64 stretch of its input and the resize of its flow back). With
  ``align_corners=False`` torch clamps negative source coordinates to 0
  and reads the last row for coordinates past it, which is the JAX
  version's clamp to ``[0, in-1]``.
- The PIL-semantics resample taps (:94-431 there), numpy, copied as they
  are: PIL's convolution resample (what torchvision's Resize and the pip
  ``clip`` package's bicubic preprocess bottom out in) is an antialiased
  separable filter with half-pixel centers, support scaled by the
  downsampling ratio and edge taps truncated and renormalized. For one
  (in, out) size pair it is a constant (out, in) matrix, and a center
  crop (or a placement on a padded output grid) composes into the same
  matrix. What ships to the device is its banded form: per output pixel
  the K contiguous nonzero (weight, index) taps, with K bounded from the
  spatial bucket's corner, so every source resolution of a bucket has
  taps of one shape. ``ops/preprocess.py::device_preprocess_frames``
  accumulates them in PIL's order and replays PIL's uint8 rounding
  between the passes; the residual against PIL is its 8-bit fixed-point
  coefficient table, about 1/255 a pixel. Each builder of taps is cached
  per size (``_cached``), under one lock, so decode workers preparing two
  videos of one resolution at once get the same arrays: the extractors
  place taps once per set of host arrays (``BaseExtractor._device_taps``).
"""

from __future__ import annotations

import functools
import math
import threading
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


_TAPS_LOCK = threading.RLock()


def _cached(maxsize: int):
    """``lru_cache(maxsize)`` whose calls run under one re-entrant lock:
    without it two threads missing on one key both build, and the second
    result replaces the first, so callers of one size hold different
    arrays."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def call(*args, **kwargs):
            with _TAPS_LOCK:
                return cached(*args, **kwargs)

        return call

    return wrap


def resize_bilinear(x: torch.Tensor, size, align_corners: bool = False) -> torch.Tensor:
    """Resize the last two axes of ``x`` (..., H, W) to ``size`` = (H', W')."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    lead = x.shape[:-2]
    y = F.interpolate(
        x.reshape(-1, 1, *x.shape[-2:]), size=tuple(size), mode="bilinear",
        align_corners=align_corners, antialias=False,
    )
    return y.reshape(*lead, *size)


# --- PIL-semantics resample matrices (--preprocess device) -----------------

def _pil_filter_weight(method: str, x: float) -> float:
    """PIL filter kernels: 'bilinear' = triangle (support 1), 'bicubic' =
    Keys cubic a=-0.5 (support 2) — the two kernels the reference's
    preprocess chains use (torchvision Resize / pip-clip preprocess)."""
    x = abs(x)
    if method == "bicubic":
        a = -0.5
        if x < 1.0:
            return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
        if x < 2.0:
            return (((x - 5.0) * x + 8.0) * x - 4.0) * a
        return 0.0
    return 1.0 - x if x < 1.0 else 0.0


_SUPPORT = {"bilinear": 1.0, "bicubic": 2.0}


def resample_matrix(
    in_size: int, out_size: int, method: str = "bicubic"
) -> np.ndarray:
    """Dense (out_size, in_size) float32 matrix of PIL's antialiased
    convolution resample along one axis: half-pixel centers, support
    scaled by the downsampling ratio, edge taps truncated + renormalized.
    ``matrix @ column`` == PIL's per-axis pass (minus its intermediate
    uint8 quantization). At scale 1 the interpolating kernels reduce to
    the identity."""
    if method not in _SUPPORT:
        raise ValueError(f"unknown resample method: {method!r}")
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = _SUPPORT[method] * fscale
    m = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(math.floor(center - support + 0.5)), 0)
        hi = min(int(math.floor(center + support + 0.5)), in_size)
        w = np.array(
            [_pil_filter_weight(method, (j + 0.5 - center) / fscale)
             for j in range(lo, hi)],
            np.float64,
        )
        total = w.sum()
        if total != 0.0:
            w /= total
        m[i, lo:hi] = w
    return m.astype(np.float32)


def resized_hw(
    h: int, w: int, size: int, smaller_edge: bool = True
) -> Tuple[int, int]:
    """The (oh, ow) PIL's aspect-keeping resize produces, mirroring
    ops/preprocess.py::pil_resize exactly — including the early return
    when the smaller edge already equals ``size`` (no resize at all, even
    if the larger edge differs; the quirk fires in both edge modes).
    ``smaller_edge=False`` matches ``resize_to_smaller_edge=False`` (the
    flow extractors' ``--side_size`` larger-edge mode)."""
    if (w <= h and w == size) or (h <= w and h == size):
        return h, w
    if (w < h) == smaller_edge:
        return int(size * h / w), size
    return size, int(size * w / h)


@_cached(maxsize=128)
def fused_resize_crop_matrices(
    h: int,
    w: int,
    resize_to: int,
    crop: int,
    method: str = "bicubic",
    pad_h: Optional[int] = None,
    pad_w: Optional[int] = None,
    crop_offset: str = "round",
) -> Tuple[np.ndarray, np.ndarray]:
    """(Wy (crop, pad_h or h), Wx (crop, pad_w or w)) float32 matrices
    composing PIL smaller-edge resize to ``resize_to`` with torchvision
    CenterCrop(``crop``) — the whole spatial half of the CLIP/ResNet
    preprocess chains as two matmuls: ``out = Wy @ frame @ Wx.T``.

    Crop rows/cols outside the resized image carry zero weight (matching
    ``pil_center_crop``'s zero padding), and source columns beyond
    (h, w) — the ``spatial_bucket`` padding — carry zero weight too, so
    bucket pad pixels cannot bleed into the output. Cached per source
    resolution: a corpus re-uses each (h, w)'s matrices across videos.

    ``crop_offset`` picks the center-offset convention: ``"round"`` is
    torchvision CenterCrop (round half to even), ``"floor"`` is the I3D
    chain's tensor crop (``(size - crop) // 2``,
    models/i3d/extract_i3d.py::center_crop) — they differ by one source
    row/col whenever the resized edge parity is odd."""
    oh, ow = resized_hw(h, w, resize_to)
    ry = resample_matrix(h, oh, method)
    rx = resample_matrix(w, ow, method)
    # torchvision CenterCrop offsets (round half to even) or the I3D
    # tensor-crop floor; when the resized image is smaller than the crop,
    # pil_center_crop zero-pads with a floor-divided top/left margin
    # BEFORE cropping — mirror that as a negative offset so the zero rows
    # land where PIL's pad does
    if crop_offset not in ("round", "floor"):
        raise ValueError(f"unknown crop_offset policy: {crop_offset!r}")

    def _offset(size_: int) -> int:
        if size_ < crop:
            return -((crop - size_) // 2)
        if crop_offset == "floor":
            return (size_ - crop) // 2
        return int(round((size_ - crop) / 2.0))

    top = _offset(oh)
    left = _offset(ow)
    wy = np.zeros((crop, pad_h or h), np.float32)
    wx = np.zeros((crop, pad_w or w), np.float32)
    for out_r in range(crop):
        r = top + out_r
        if 0 <= r < oh:
            wy[out_r, :h] = ry[r]
    for out_c in range(crop):
        c = left + out_c
        if 0 <= c < ow:
            wx[out_c, :w] = rx[c]
    wy.setflags(write=False)
    wx.setflags(write=False)
    return wy, wx


def banded(matrix: np.ndarray, k: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Compress a resample matrix to banded form: (weights (out, K),
    indices (out, K)) with K the widest row band (PIL taps are contiguous,
    so per-row nonzeros always fit one band). Rows narrower than K repeat
    their last index under zero weight; all-zero rows (crop padding) point
    at column 0 under zero weight. Dense matmul over a bucket-padded axis
    pays the full axis length per output pixel where PIL's separable loop
    pays ~2*support*scale taps (a ~50x FLOP tax), and its reduction
    order loses the parity with PIL, so the extractors ship THIS form and
    ops/preprocess.py::device_preprocess_frames accumulates the K gathered
    slices instead (also PIL's own tap order, keeping the <=1/255 parity)."""
    widths = (matrix != 0).sum(axis=1)
    k_actual = int(widths.max()) if matrix.size else 0
    k = max(k or 0, k_actual, 1)
    wt = np.zeros((matrix.shape[0], k), np.float32)
    idx = np.zeros((matrix.shape[0], k), np.int32)
    for q, row in enumerate(matrix):
        nz = np.nonzero(row)[0]
        if len(nz):
            n = len(nz)
            idx[q, :n] = nz
            idx[q, n:] = nz[-1]
            wt[q, :n] = row[nz]
    wt.setflags(write=False)
    idx.setflags(write=False)
    return wt, idx


@_cached(maxsize=128)
def fused_resize_crop_banded(
    h: int,
    w: int,
    resize_to: int,
    crop: int,
    method: str = "bicubic",
    pad_h: Optional[int] = None,
    pad_w: Optional[int] = None,
    crop_offset: str = "round",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``fused_resize_crop_matrices`` in banded form: (wt_y, idx_y, wt_x,
    idx_x). K is computed at the BUCKET resolution (pad_h, pad_w), not the
    source (h, w): band width grows with the resample scale, and the scale
    (min-edge/resize_to) is maximal at the bucket corner, so every source
    resolution sharing a bucket pads up to one static K — mixed-resolution
    ``--video_batch`` groups can stack their taps."""
    wy, wx = fused_resize_crop_matrices(
        h, w, resize_to, crop, method, pad_h, pad_w, crop_offset
    )
    bh, bw = pad_h or h, pad_w or w
    # analytic K bound from the bucket's worst-case scale: a resample row
    # holds hi-lo taps with hi-lo <= floor(2*support*fscale)+1, and within
    # a bucket fscale (= min-edge/resize_to when downsampling, 1 when
    # upsampling) is maximal at the bucket corner. +1 absorbs resized_hw's
    # int() rounding nudging a member's scale past the corner's. Derived
    # from the bucket alone — NOT the source — so every resolution in a
    # bucket pads to one K and their tap arrays stack for --video_batch.
    # (The corner's own matrices can't serve as the bound: a corner whose
    # min-edge lands exactly on resize_to takes pil_resize's no-op early
    # return, K=1, while its neighbors still resize.)
    smax = max(min(bh, bw) / float(resize_to), 1.0)
    k = int(2 * _SUPPORT[method] * smax) + 2
    wt_y, idx_y = banded(wy, k)
    wt_x, idx_x = banded(wx, k)
    if wt_y.shape[1] != k or wt_x.shape[1] != k:
        raise AssertionError(
            f"band width escaped its bucket bound: {wt_y.shape[1]}/"
            f"{wt_x.shape[1]} vs {k} for {(h, w)} in {(bh, bw)}"
        )
    return wt_y, idx_y, wt_x, idx_x


# --- shape-contracted outputs (flow + I3D device preprocess) ---------------

@_cached(maxsize=256)
def shape_contract_matrices(
    h: int,
    w: int,
    resize_to: int,
    out_h: int,
    out_w: int,
    top: int = 0,
    left: int = 0,
    method: str = "bilinear",
    pad_h: Optional[int] = None,
    pad_w: Optional[int] = None,
    pad_mode: str = "edge",
    smaller_edge: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """The crop-free generalization of ``fused_resize_crop_matrices``:
    (Wy (out_h, pad_h or h), Wx (out_w, pad_w or w)) matrices that resize
    a source frame onto an agreed **output contract** — a fixed
    (out_h, out_w) grid with the resized (oh, ow) image placed at
    (top, left). That is exactly the geometry the flow models and I3D
    need: their host chains resize to a shape that VARIES with the source
    (min-edge-256 for I3D, ``--side_size`` or no resize for RAFT/PWC) and
    then replicate-pad to the model's /8 or /64 grid; here pad and resize
    collapse into one tap set per source resolution.

    ``resize_to`` = 0 skips the resize (identity taps — the no
    ``--side_size`` flow case); otherwise it is PIL's aspect-keeping edge
    resize (``smaller_edge`` as in ``pil_resize``). ``pad_mode`` places
    the out-of-image rows/cols: ``"edge"`` repeats the nearest image
    row/col's taps — composing the resize with ``np.pad(mode="edge")``
    (InputPadder's replicate pad) into the same matrix, exact because the
    pad copies already-quantized pixels; ``"zero"`` leaves them at zero
    weight. Source columns beyond (h, w) — input ``spatial_bucket``
    padding — always carry zero weight."""
    if pad_mode not in ("edge", "zero"):
        raise ValueError(f"unknown pad_mode: {pad_mode!r}")
    oh, ow = resized_hw(h, w, resize_to, smaller_edge) if resize_to else (h, w)
    if not (0 <= top and top + oh <= out_h and 0 <= left and left + ow <= out_w):
        raise ValueError(
            f"resized image {(oh, ow)} at offset {(top, left)} does not fit "
            f"the {(out_h, out_w)} output contract"
        )
    ry = resample_matrix(h, oh, method)
    rx = resample_matrix(w, ow, method)
    wy = np.zeros((out_h, pad_h or h), np.float32)
    wx = np.zeros((out_w, pad_w or w), np.float32)
    for out_r in range(out_h):
        r = out_r - top
        if pad_mode == "edge":
            r = min(max(r, 0), oh - 1)
        if 0 <= r < oh:
            wy[out_r, :h] = ry[r]
    for out_c in range(out_w):
        c = out_c - left
        if pad_mode == "edge":
            c = min(max(c, 0), ow - 1)
        if 0 <= c < ow:
            wx[out_c, :w] = rx[c]
    wy.setflags(write=False)
    wx.setflags(write=False)
    return wy, wx


@_cached(maxsize=256)
def shape_contract_banded(
    h: int,
    w: int,
    resize_to: int,
    out_h: int,
    out_w: int,
    top: int = 0,
    left: int = 0,
    method: str = "bilinear",
    pad_h: Optional[int] = None,
    pad_w: Optional[int] = None,
    pad_mode: str = "edge",
    smaller_edge: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``shape_contract_matrices`` in banded form (wt_y, idx_y, wt_x,
    idx_x), with K bounded analytically from the input bucket exactly as
    ``fused_resize_crop_banded`` does — every source resolution sharing
    an (input bucket, output contract) pair pads to one K, so taps stack
    across a ``--video_batch`` group.
    With ``resize_to`` = 0 the taps are the identity band (K covers it
    trivially), which makes the no-resize flow contract a pure gather —
    bit-exact against host ``np.pad(mode="edge")``."""
    wy, wx = shape_contract_matrices(
        h, w, resize_to, out_h, out_w, top, left,
        method, pad_h, pad_w, pad_mode, smaller_edge,
    )
    bh, bw = pad_h or h, pad_w or w
    if resize_to:
        edge = min(bh, bw) if smaller_edge else max(bh, bw)
        smax = max(edge / float(resize_to), 1.0)
    else:
        smax = 1.0
    k = int(2 * _SUPPORT[method] * smax) + 2
    wt_y, idx_y = banded(wy, k)
    wt_x, idx_x = banded(wx, k)
    if wt_y.shape[1] != k or wt_x.shape[1] != k:
        raise AssertionError(
            f"band width escaped its bucket bound: {wt_y.shape[1]}/"
            f"{wt_x.shape[1]} vs {k} for {(h, w)} in {(bh, bw)}"
        )
    return wt_y, idx_y, wt_x, idx_x
