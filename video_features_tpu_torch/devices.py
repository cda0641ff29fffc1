"""The numerics every entry point pins, and the one device of a run
that drives one.

``--device_ids`` and ``--cpu`` resolve in ``parallel/devices.py``
(``resolve_devices``): a run without ``--cpu`` on a host without CUDA is
an error, never a silent fallback to the CPU.
"""

from __future__ import annotations

import torch

from video_features_tpu_torch.parallel.devices import resolve_devices


def pin_fp32() -> None:
    """fp32 means fp32: cuBLAS matmuls and cuDNN convolutions off TF32
    (cuDNN's default is TF32, which the JAX reference's fp32 patch conv
    does not use). That holds inside a ``--dtype bfloat16`` graph too: its
    fp32-pinned parts (PWC's cost volumes, RAFT's volume and GRU gates,
    the heads) stay true fp32. And bf16 GEMMs accumulate in fp32, as
    XLA's do: cuBLAS may not reduce in bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(cfg) -> torch.device:
    """The first of ``parallel.devices.resolve_devices(cfg)``: the device
    of a run that drives one (an extractor called without a device, the
    serve daemon)."""
    return resolve_devices(cfg)[0]
