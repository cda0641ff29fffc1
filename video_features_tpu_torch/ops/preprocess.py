"""Preprocessing: the host PIL resize / center-crop / normalise chain
(``imagenet_preprocess`` for ResNet), and the I3D input maps
(``scale_to_1_1``, ``flow_to_uint8``).

Counterpart of ``video_features_tpu/ops/preprocess.py``; the PIL chain's
output is byte-identical (both bottom out in the same PIL calls).
"""

from __future__ import annotations

from typing import Sequence

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
