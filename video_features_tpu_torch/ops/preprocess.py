"""Preprocessing: the host PIL resize / center-crop / normalise chain
(``imagenet_preprocess`` for ResNet), its device half under
``--preprocess device`` (``device_resize_frames``,
``device_preprocess_frames``), and the I3D input maps (``scale_to_1_1``,
``flow_to_uint8``, ``dynamic_center_crop``).

Counterpart of ``video_features_tpu/ops/preprocess.py``; the PIL chain's
output is byte-identical (both bottom out in the same PIL calls). The
device half is plain torch ops, as the JAX package leaves it to XLA: no
matmul, so TF32 cannot enter, and the taps accumulate in the JAX
package's order.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
from PIL import Image

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# R(2+1)D's Kinetics-400 statistics
KINETICS_MEAN = (0.43216, 0.394666, 0.37645)
KINETICS_STD = (0.22803, 0.22145, 0.216989)


def pil_resize(
    img: np.ndarray,
    size,
    resize_to_smaller_edge: bool = True,
    interpolation=Image.BILINEAR,
) -> np.ndarray:
    """torchvision-style resize of an RGB uint8 HWC array via PIL: an int
    size matches the smaller (or larger) edge keeping aspect; (h, w) is
    exact."""
    pim = Image.fromarray(img)
    if isinstance(size, int):
        w, h = pim.size
        if (w <= h and w == size) or (h <= w and h == size):
            return img
        if (w < h) == resize_to_smaller_edge:
            ow, oh = size, int(size * h / w)
        else:
            oh, ow = size, int(size * w / h)
        pim = pim.resize((ow, oh), interpolation)
    else:
        h, w = size
        pim = pim.resize((w, h), interpolation)
    return np.asarray(pim)


def pil_center_crop(img: np.ndarray, crop: int) -> np.ndarray:
    """torchvision CenterCrop on HWC (zero-pads a smaller image)."""
    h, w = img.shape[:2]
    if h < crop or w < crop:
        pt = max((crop - h) // 2, 0)
        pl = max((crop - w) // 2, 0)
        img = np.pad(
            img, ((pt, max(crop - h - pt, 0)), (pl, max(crop - w - pl, 0)), (0, 0))
        )
        h, w = img.shape[:2]
    top = int(round((h - crop) / 2.0))
    left = int(round((w - crop) / 2.0))
    return img[top : top + crop, left : left + crop]


# graftcheck: fp32-island — torchvision ToTensor parity reference: the
# production wire ships uint8 and casts on the device (--preprocess device
# and the dispatch's cast after the H2D); this host float path pins the
# reference chain the device graph is held to.
def to_float_chw(img: np.ndarray) -> np.ndarray:
    """HWC uint8 -> CHW float32 in [0, 1] (torchvision ToTensor)."""
    return np.transpose(img, (2, 0, 1)).astype(np.float32) / 255.0


def normalize_chw(img: np.ndarray, mean: Sequence[float], std: Sequence[float]) -> np.ndarray:
    mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
    std = np.asarray(std, np.float32).reshape(-1, 1, 1)
    return (img - mean) / std


def imagenet_preprocess(
    img: np.ndarray,
    resize_size: int = 256,
    crop_size: int = 224,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
) -> np.ndarray:
    """torchvision's Resize -> CenterCrop -> ToTensor -> Normalize on an
    RGB uint8 HWC frame -> CHW float32."""
    img = pil_center_crop(pil_resize(img, resize_size), crop_size)
    return normalize_chw(to_float_chw(img), mean, std)


def scale_to_1_1(x):
    """[0, 255] -> [-1, 1] (tensor or array)."""
    return 2.0 * x / 255.0 - 1.0


def flow_to_uint8(flow: torch.Tensor, bound: float = 20.0) -> torch.Tensor:
    """Clamp flow to [-bound, bound] and quantise it to the uint8 grid,
    kept as float (the reference's Clamp -> ToUInt8). ``torch.round``
    rounds half to even, as ``jnp.round`` does; exactly +bound maps to
    256.0, as in the reference."""
    return torch.round(128.0 + 255.0 / (2 * bound) * flow.clamp(-bound, bound))


def flow_quantize_uint8_np(flow: np.ndarray, bound: float = 20.0) -> np.ndarray:
    """The ``save_jpg`` sink's storage form of :func:`flow_to_uint8`, in
    numpy: the same map, then clipped to 0..255 BEFORE the uint8 cast — at
    exactly +bound the map gives 256.0, which a bare ``astype(uint8)``
    would wrap to 0 (max-positive flow read back as max-negative)."""
    q = np.round(128.0 + 255.0 / (2 * bound) * np.clip(flow, -bound, bound))
    return np.clip(q, 0.0, 255.0).astype(np.uint8)


# --- device half of --preprocess device -------------------------------------

def _banded_resample(x: torch.Tensor, wt: torch.Tensor, idx: torch.Tensor,
                     axis: int) -> torch.Tensor:
    """One separable resample pass as a K-tap banded accumulation,
    ``sum_k x[..., idx[..., k], ...] * wt[..., k]`` along ``axis``, in
    fp32, one gathered slice at a time in ascending ``k`` (PIL's own tap
    order, which keeps the <=1/255 parity a dense matmul's reduction
    order loses). ``idx`` is int64 on ``x``'s device. Taps of shape (P, K)
    serve every frame; (N, P, K) taps give axis 0's entry i its own (a
    video of a fused group, or a row of ResNet's re-chunked rows): the
    gather then indexes axis 0 with an ``arange`` beside the taps, so no
    index of the output's full shape is built."""
    shared = wt.dim() == 2
    bshape = [1] * x.dim()
    if shared:
        bshape[axis] = -1
    else:
        bshape[0], bshape[axis] = idx.shape[0], idx.shape[1]
        moved = x.movedim(axis, 1)  # (N, in, ...): both indexed axes lead
        rows = torch.arange(idx.shape[0], device=x.device).unsqueeze(1)
    y = None
    for k in range(wt.shape[-1]):
        if shared:
            g = x.index_select(axis, idx[:, k])
        else:
            g = moved[rows, idx[:, :, k]].movedim(1, axis)
        term = g.float() * wt[..., k].reshape(bshape)
        y = term if y is None else y + term
    return y


def quant8(v: torch.Tensor) -> torch.Tensor:
    """PIL's uint8 round and clamp, kept as float (``torch.round`` rounds
    half to even, as ``jnp.round`` does)."""
    return torch.clamp(torch.round(v), 0.0, 255.0)


def device_resize_frames(
    frames: torch.Tensor,
    wy: Tuple[torch.Tensor, torch.Tensor],
    wx: Tuple[torch.Tensor, torch.Tensor],
) -> torch.Tensor:
    """Raw uint8 (..., H, W, C) frames -> two banded separable passes
    against the host-built PIL-semantics taps -> float32 (..., P, Q, C)
    in [0, 255]. Horizontal first, then vertical, with PIL's uint8
    rounding after each pass (the identity on the integer outputs of
    identity taps, so a no-resize contract is exact). ``wy``/``wx`` are
    (weights, int64 indices) pairs in the layouts of
    ``device_preprocess_frames``."""
    w_axis = frames.dim() - 2
    y = quant8(_banded_resample(frames, wx[0], wx[1], axis=w_axis))
    return quant8(_banded_resample(y, wy[0], wy[1], axis=w_axis - 1))


def device_preprocess_frames(
    frames: torch.Tensor,
    wy: Tuple[torch.Tensor, torch.Tensor],
    wx: Tuple[torch.Tensor, torch.Tensor],
    mean: Sequence[float],
    std: Sequence[float],
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``device_resize_frames``, then /255, mean/std normalize and CHW, in
    fp32, returned in ``out_dtype`` (bf16 for a ``--dtype bfloat16``
    model): the whole CLIP or ResNet host chain on the card. Tap layouts:

    - frames (T, H, W, C) + wt (P, K) -> (T, C, P, Q): one video;
    - frames (N, T, H, W, C) + wt (N, P, K) -> (N, T, C, P, Q): a fused
      ``--video_batch`` group, each video with its own source
      resolution's taps inside the shared bucket;
    - frames (R, H, W, C) + wt (R, P, K) -> (R, C, P, Q): rows of several
      videos (ResNet's re-chunked groups), each with its video's taps.
    """
    y = device_resize_frames(frames, wy, wx)
    y = y.movedim(-1, -3)  # (..., P, Q, C) -> (..., C, P, Q)
    mean_t, std_t = _channel_stats(tuple(mean), tuple(std), y.device)
    return ((y / 255.0 - mean_t) / std_t).to(out_dtype).contiguous()


@functools.lru_cache(maxsize=16)
def _channel_stats(mean: tuple, std: tuple, device: torch.device):
    """(C, 1, 1) fp32 mean and std on ``device``, made once: a tensor built
    from a list copies from pageable memory, which would hold the host
    until the device's queue drains."""
    # graftcheck: host-sync — lru_cached per (mean, std, device): the one
    # blocking upload happens at a device's first dispatch, not per video
    return tuple(torch.tensor(v, dtype=torch.float32, device=device).reshape(-1, 1, 1)
                 for v in (mean, std))


def dynamic_center_crop(x: torch.Tensor, top: int, left: int, crop: int) -> torch.Tensor:
    """Crop ``crop`` x ``crop`` out of the (..., H, W, C) axes at
    (``top``, ``left``): I3D's flow crop, measured from where the flow
    grid places the image (a plain slice; eager PyTorch compiles no
    shape, so the offsets need not be inputs)."""
    return x[..., top : top + crop, left : left + crop, :]
