"""PWC's cost volume on the card: the Hopper kernel
``csrc/local_correlation.cu`` (K2) and its binding.

Counterpart of ``video_features_tpu/ops/pallas/correlation_kernel.py``,
with the same (N, C, H, W) x2 -> (N, 81, H, W) contract. This wrapper
takes CUDA tensors only: ``ops/correlation.py::local_correlation`` sends a
CPU tensor to the plain version and a CUDA tensor here.
``local_correlation_kernel.launches`` counts kernel launches, so a run
can show that its cost volumes went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from video_features_tpu_torch.ops import kernels

# the kernel's displacement (csrc/local_correlation.cu kDisp)
MAX_DISPLACEMENT = 4
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1
_GRID_Z_MAX = 65535


@functools.lru_cache(maxsize=None)
def _forward_fn():
    """The kernel's C entry point, built and bound on first use."""
    fn = kernels.load("local_correlation").vft_local_correlation_forward
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    if min(N, C, H, W) < 1 or N > _GRID_Z_MAX or N * 81 * H * W > _INT_MAX:
        raise ValueError(f"local_correlation_kernel cannot take shape {tuple(f1.shape)}")
    f1, f2 = f1.contiguous(), f2.contiguous()
    out = torch.empty((N, 81, H, W), dtype=f1.dtype, device=f1.device)
    with torch.cuda.device(f1.device):
        err = _forward_fn()(
            f1.data_ptr(), f2.data_ptr(), out.data_ptr(), N, C, H, W, _DTYPES[f1.dtype],
            torch.cuda.current_stream(f1.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"local_correlation kernel launch failed: CUDA error {err}")
    local_correlation_kernel.launches += 1
    return out


local_correlation_kernel.launches = 0
