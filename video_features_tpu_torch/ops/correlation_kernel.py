"""PWC's cost volume on the card: the Hopper kernel
``csrc/local_correlation.cu`` (K2) and its binding.

Counterpart of ``video_features_tpu/ops/pallas/correlation_kernel.py``,
with the same (N, C, H, W) x2 -> (N, 81, H, W) contract. This wrapper
takes CUDA tensors only: ``ops/correlation.py::local_correlation`` sends a
CPU tensor to the plain version and a CUDA tensor here.
``local_correlation_kernel.launches`` counts kernel launches, so a run
can show that its cost volumes went through the kernel. ``launch_shape``
chooses the kernel's tile, channel groups and staging chunk from the
shape, in Python, so that the CPU tests can check them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from video_features_tpu_torch.ops import kernels

# the kernel's displacement, output pixels per thread and threads per CTA
# (csrc/local_correlation.cu kDisp, kSeg, kMaxThreads)
MAX_DISPLACEMENT = 4
SEGMENT = 4
MAX_THREADS = 512
_SIDE = 2 * MAX_DISPLACEMENT + 1
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1
_N_MAX = 65535  # pairs the C entry point takes
# the kernel's ring of staging buffers (csrc/local_correlation.cu kStages)
STAGES = 3
# what the shape helper aims for on an H100 (tuned by timing PWC's five
# levels): tiles of at most 16 segments, ~32 K threads' worth of tiles,
# the staging ring within 96 KB so two CTAs can share an SM, chunks of at
# most 12 channels, at most 16 channel groups of at least 8 channels each,
# whole-plane tiles for planes of at most 32 pixels
_TILE_SEGMENTS = 16
_TARGET_THREADS = 32 * 1024
_STAGING_BYTES = 96 * 1024
_MAX_CHUNK = 12
_MAX_SPLITS = 16
_MIN_SPLIT_CHANNELS = 8
_MAX_STAGE_CHANNELS = 256  # a TMA box's depth
_SMALL_PLANE = 32
SMEM_MAX = 227 * 1024  # dynamic shared memory a CTA may use


class LaunchShape(NamedTuple):
    """One K2 launch: the CTA tile, its channel groups (``splits``) and the
    channels each group stages at a time (``chunk``); the tiles they make
    (persistent CTAs walk them), the staging the kernel takes for 16-byte
    aligned inputs (``tensor``, ``planes`` or ``copies``), threads and
    shared memory."""

    tile_h: int
    tile_w: int
    splits: int
    chunk: int
    tiles: tuple  # (tiles of a plane, pairs)
    staging: str
    threads: int
    smem_bytes: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def staged_layout(h: int, w: int, tile_h: int, tile_w: int, itemsize: int, staging: str):
    """(f1 elements, f2 elements) one channel takes in a stage, as the
    kernel lays them out: whole compact planes, or f1's tile and f2's tile
    plus its border (4 pixels, 16 bytes on the left) in rows rounded up to
    16 bytes."""
    if staging == "planes":
        return h * w, h * w
    unit = 16 // itemsize
    left = max(unit, MAX_DISPLACEMENT)
    f1_row = _cdiv(tile_w, unit) * unit
    f2_row = _cdiv(left + tile_w + MAX_DISPLACEMENT, unit) * unit
    return tile_h * f1_row, (tile_h + 2 * MAX_DISPLACEMENT) * f2_row


@functools.lru_cache(maxsize=256)
def launch_shape(n: int, c: int, h: int, w: int, itemsize: int) -> LaunchShape:
    """K2's launch for (n, c, h, w) inputs of ``itemsize`` bytes.

    Tiles split W into near-equal widths of at most 32 (a multiple of 4),
    so few lanes fall outside the plane; a thread owns 4 pixels of a row
    for one dy, so a row of the tile is ``tile_w / 4`` threads per dy. A
    plane of at most 32 pixels is one tile; otherwise the tile is as many
    rows (a power of two) as keep it within 16 segments. Then the channel
    loop is split across up to 16 groups of the CTA's threads while the
    tiles hold too few threads (a whole-plane tile: as many groups as 512
    threads allow). The chunk is the largest even cut of a group's
    channels of at most 12 whose ring of staging buffers fits in 96 KB."""
    tiles_w = _cdiv(w, 32)
    tile_w = SEGMENT * _cdiv(_cdiv(w, tiles_w), SEGMENT)
    seg_row = tile_w // SEGMENT
    whole = tiles_w == 1 and h * w <= _SMALL_PLANE
    if whole:
        tile_h = h
    else:
        tile_h = 1
        while 2 * tile_h * seg_row <= _TILE_SEGMENTS and 2 * tile_h <= h:
            tile_h *= 2
    ctas = _cdiv(h, tile_h) * tiles_w
    per_split = _SIDE * tile_h * seg_row
    splits = 1
    while (2 * splits <= _MAX_SPLITS and 2 * splits * per_split <= MAX_THREADS
           and c >= 2 * splits * _MIN_SPLIT_CHANNELS
           and (whole or n * ctas * splits * per_split < _TARGET_THREADS)):
        splits *= 2
    if whole:  # as many groups as the threads allow
        splits = max(splits, min(_MAX_SPLITS, MAX_THREADS // per_split,
                                 max(1, c // _MIN_SPLIT_CHANNELS)))
    if ctas == 1 and (h * w * itemsize) % 16 == 0:
        staging = "planes"
    elif (w * itemsize) % 16 == 0 and (tile_w * itemsize) % 16 == 0:
        staging = "tensor"
    else:
        staging = "copies"
    f1_chan, f2_chan = staged_layout(h, w, tile_h, tile_w, itemsize, staging)
    block = 128 // itemsize
    per_group = _cdiv(c, splits)
    fits = max(1, min(_STAGING_BYTES // (STAGES * splits * (f1_chan + f2_chan + 2 * block)
                                         * itemsize),
                      _MAX_STAGE_CHANNELS // splits, _MAX_CHUNK))
    chunk = _cdiv(per_group, _cdiv(per_group, min(fits, per_group)))
    threads = splits * per_split
    # the staging ring (each block on 128 bytes), the sums groups 1.. hand
    # to group 0, a barrier per stage
    f2_off = _cdiv(splits * chunk * f1_chan, block) * block
    stage = _cdiv(f2_off + splits * chunk * f2_chan, block) * block
    smem = (STAGES * stage * itemsize + (splits - 1) * per_split * _SIDE * SEGMENT * 4
            + STAGES * 8)
    return LaunchShape(tile_h, tile_w, splits, chunk, (ctas, n), staging, threads, smem)


@functools.lru_cache(maxsize=None)
def _forward_fn():
    """The kernel's C entry point, built and bound on first use."""
    fn = kernels.load("local_correlation").vft_local_correlation_forward
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def load_kernel(device) -> None:
    """Build (``nvcc``, on a checkout's first use) and load the kernel now
    when ``device`` is a card; nothing elsewhere. The extractors call it as
    they build PWC, so the build is set-up's model build and not part of
    the net's first call (its ``compile`` span)."""
    if torch.device(device).type == "cuda":
        _forward_fn()


# graftcheck: cuda-kernel
def local_correlation_kernel(
    f1: torch.Tensor, f2: torch.Tensor, max_displacement: int = MAX_DISPLACEMENT
) -> torch.Tensor:
    """(N, C, H, W) f1 and f2 on one CUDA device -> (N, 81, H, W) in their
    dtype. Raises on anything the kernel does not take."""
    if not (f1.device == f2.device and f1.device.type == "cuda"):
        raise ValueError(
            f"local_correlation_kernel needs f1 and f2 on one CUDA device, got "
            f"{f1.device}, {f2.device}"
        )
    if not (f1.dtype == f2.dtype and f1.dtype in _DTYPES):
        raise ValueError(
            f"local_correlation_kernel takes float32 or bfloat16 f1/f2 of one "
            f"dtype, got {f1.dtype}, {f2.dtype}"
        )
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(
            f"local_correlation_kernel takes two (N, C, H, W) tensors of one "
            f"shape, got {tuple(f1.shape)} and {tuple(f2.shape)}"
        )
    if max_displacement != MAX_DISPLACEMENT:
        raise ValueError(
            f"the CUDA kernel's max displacement is {MAX_DISPLACEMENT}, got "
            f"{max_displacement}"
        )
    N, C, H, W = f1.shape
    if min(N, C, H, W) < 1 or N > _N_MAX or N * 81 * H * W > _INT_MAX:
        raise ValueError(f"local_correlation_kernel cannot take shape {tuple(f1.shape)}")
    f1, f2 = f1.contiguous(), f2.contiguous()
    out = torch.empty((N, 81, H, W), dtype=f1.dtype, device=f1.device)
    shape = launch_shape(N, C, H, W, f1.element_size())
    with kernels.on_device(f1.device):
        err = _forward_fn()(
            f1.data_ptr(), f2.data_ptr(), out.data_ptr(), N, C, H, W, shape.tile_h,
            shape.tile_w, shape.splits, shape.chunk, _DTYPES[f1.dtype],
            torch.cuda.current_stream(f1.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"local_correlation kernel launch failed: CUDA error {err}")
    kernels.count_launch(local_correlation_kernel)
    return out


local_correlation_kernel.launches = 0
