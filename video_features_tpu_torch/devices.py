"""Device selection and the numerics every entry point pins.

Counterpart of ``video_features_tpu/parallel/devices.py``: ``--device_ids``
names one visible CUDA device (more is refused until multi-GPU queue mode
is ported) and ``--cpu`` selects the CPU. A run
without ``--cpu`` on a host without CUDA is an error, never a silent
fallback to the CPU.
"""

from __future__ import annotations

import torch


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


def check_one_device(device_ids) -> None:
    """Refuse more than one ``--device_ids``: the port runs on one CUDA
    device until multi-GPU queue mode is ported."""
    if device_ids is not None and len(device_ids) > 1:
        raise ValueError(
            f"--device_ids {' '.join(map(str, device_ids))}: this package runs "
            "on one CUDA device so far; more than one is multi-GPU queue "
            "mode (ROADMAP.md queue 1, item 12). Pass one id."
        )


def resolve_device(cfg) -> torch.device:
    """``cuda:<device_ids[0]>`` (one id at most), or the CPU when
    ``cfg.cpu``."""
    check_one_device(cfg.device_ids)
    if cfg.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass --cpu to run on the CPU"
        )
    ids = list(cfg.device_ids or [0])
    count = torch.cuda.device_count()
    bad = [i for i in ids if i < 0 or i >= count]
    if bad:
        raise ValueError(
            f"device_ids {bad} out of range: only {count} CUDA devices visible"
        )
    return torch.device("cuda", ids[0])
