"""The plain reference of one I3D two-stream video, as
v-iashin/video_features computes it, written from the published pipeline
and not from the program under test:

- every frame decoded with cv2 and turned to RGB; a clip of at least 65
  frames keeps all of them (a shorter one, which the reference upsamples
  to 65, is refused here: no traffic sends one);
- each frame resized with PIL so that its smaller side is ``min_side``
  (torchvision's ``Resize(int)``: the other side ``int(size * long /
  short)``, bilinear, untouched when the smaller side already is
  ``min_side``);
- windows of ``stack_size + 1`` frames every ``step_size``, the ragged
  tail dropped;
- rgb: the first ``stack_size`` frames, a ``crop`` center crop at floor
  offsets, ``2x/255 - 1``, I3D-rgb;
- flow: the flow net over the ``stack_size`` consecutive pairs (RAFT on
  the frames replicate-padded to multiples of 8, 'sintel' mode, its flow
  kept at the padded size; PWC at the frames' size), a ``crop`` center
  crop at floor offsets, clamped to [-bound, bound], mapped to ``round(128
  + 255 / (2 bound) * f)``, ``2x/255 - 1``, I3D-flow.

Every model is the plain version beside this file, fp32. The caller sets
the precision (``precision``); the models load the same weight files the
program reads. Imports neither the program nor JAX.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.i3d import I3D
from port_bench.reference.pwc import PWCNet
from port_bench.reference.raft import RAFT


@contextlib.contextmanager
def precision(tf32: bool):
    """cuBLAS and cuDNN fp32 with TF32 off (the reference), or on (the
    control); the previous settings come back on exit."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def decode(path: str) -> np.ndarray:
    """Every frame of ``path`` as (T, H, W, 3) RGB uint8."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    finally:
        cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames)


def resize_min_side(frames: np.ndarray, size: int) -> np.ndarray:
    from PIL import Image

    h, w = frames.shape[1:3]
    if min(h, w) == size:
        return frames
    oh, ow = (size, int(size * w / h)) if h < w else (int(size * h / w), size)
    return np.stack([np.asarray(Image.fromarray(f).resize((ow, oh), Image.BILINEAR))
                     for f in frames])


def windows(n: int, stack: int, step: int) -> List[Tuple[int, int]]:
    return [(s, s + stack + 1) for s in range(0, n - stack, step)]


def center_crop(x: torch.Tensor, crop: int) -> torch.Tensor:
    """(..., H, W) at floor offsets."""
    h, w = x.shape[-2:]
    top, left = (h - crop) // 2, (w - crop) // 2
    return x[..., top:top + crop, left:left + crop]


def to_uint8_levels(flow: torch.Tensor, bound: float) -> torch.Tensor:
    return torch.round(128 + 255 / (2 * bound) * torch.clamp(flow, -bound, bound))


def replicate_pad8(x: torch.Tensor) -> torch.Tensor:
    """princeton-vl's ``InputPadder`` in 'sintel' mode on (N, C, H, W)."""
    h, w = x.shape[-2:]
    ph, pw = (-h) % 8, (-w) % 8
    return F.pad(x, [pw // 2, pw - pw // 2, ph // 2, ph - ph // 2], mode="replicate")


def load_models(config: dict, weights_dir: str, device, width_div: int = 1) -> Dict[str, torch.nn.Module]:
    """The reference's I3D streams and flow net, built from the
    configuration's sizes and loaded from the weight files."""
    sizes = config["sizes"]
    flow_type = config["flow_type"]
    models = {"rgb": I3D(3, sizes["i3d"], width_div), "flow": I3D(2, sizes["i3d"], width_div),
              flow_type: RAFT(sizes["raft"]) if flow_type == "raft" else PWCNet(sizes["pwc"])}
    out = {}
    for kind, model in models.items():
        path = os.path.join(weights_dir, config["weight_files"][kind])
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = {k.removeprefix("module."): v for k, v in sd.items()}
        missing, unexpected = model.load_state_dict(sd, strict=False)
        missing = [k for k in missing if not k.endswith("num_batches_tracked")]
        if missing or unexpected:
            raise ValueError(f"{path} does not fit the reference {kind}: "
                             f"{(missing + unexpected)[:5]}")
        out[kind] = model.to(device).eval()
    return out


@torch.no_grad()
def video_features(path: str, models: Dict[str, torch.nn.Module], config: dict,
                   device) -> Dict[str, np.ndarray]:
    """{'rgb': (S, 1024), 'flow': (S, 1024)} of one video."""
    pipe = config["pipeline"]
    crop, bound = pipe["crop"], pipe["flow_bound"]
    frames = decode(path)
    if len(frames) < 65:
        raise ValueError(f"{path}: {len(frames)} frames; the reference here takes 65 or more")
    frames = resize_min_side(frames, pipe["min_side"])
    feats: Dict[str, list] = {"rgb": [], "flow": []}
    for s, e in windows(len(frames), pipe["stack_size"], pipe["step_size"]):
        x = torch.from_numpy(frames[s:e]).to(device).float().permute(0, 3, 1, 2)  # (S+1, 3, H, W)
        rgb = 2.0 * center_crop(x[:-1], crop) / 255.0 - 1.0
        feats["rgb"].append(models["rgb"](rgb.permute(1, 0, 2, 3)[None]))
        if config["flow_type"] == "raft":
            flow = models["raft"](replicate_pad8(x))
        else:
            flow = models["pwc"].estimate(x)
        levels = to_uint8_levels(center_crop(flow, crop), bound)
        feats["flow"].append(models["flow"]((2.0 * levels / 255.0 - 1.0).permute(1, 0, 2, 3)[None]))
    return {k: torch.cat(v).cpu().numpy() for k, v in feats.items()}
