"""Device addressing: ``--device_ids`` index the visible CUDA devices.

Counterpart of ``video_features_tpu/parallel/devices.py``. ``--cpu``
gives the CPU and ignores the ids; without it a host with no CUDA device
is an error, never a fallback to the CPU. Repeated ids are kept as given,
as the JAX package keeps them: ``--device_ids 0 0`` is two queue workers
on one card, or a mesh of two shards on it. Under a launcher each
process drives its own share of the host's devices (``local_share``).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch


def world_size() -> int:
    """The process count a launcher declares (torchrun's ``WORLD_SIZE``),
    1 without one."""
    return max(int(os.environ.get("WORLD_SIZE", "1") or 1), 1)


def _env_int(*names: str, default: int) -> int:
    for name in names:
        value = os.environ.get(name)
        if value:
            return int(value)
    return default


def local_share(devices: Sequence[torch.device]) -> List[torch.device]:
    """This process's own devices under a launcher, the counterpart of the
    JAX package's ``jax.local_devices()``: local process ``r`` of ``L``
    (torchrun's ``LOCAL_RANK``/``LOCAL_WORLD_SIZE``, else ``RANK``/
    ``WORLD_SIZE``) takes every ``L``-th visible device from ``r``. With
    fewer visible devices than local processes (one card each made
    visible by the launcher, or several processes to a card) it takes
    device ``r mod count``. Each card thus runs one model per process
    that owns it, never one per process on the host."""
    world = _env_int("LOCAL_WORLD_SIZE", "WORLD_SIZE", default=1)
    rank = _env_int("LOCAL_RANK", "RANK", default=0)
    return list(devices[rank::world]) or [devices[rank % len(devices)]]


def resolve_devices(cfg=None, *, cpu: Optional[bool] = None,
                    device_ids: Optional[Sequence[int]] = None) -> List[torch.device]:
    """The devices a run drives, in the order of ``device_ids`` (every
    visible CUDA device when there are none). Under a launcher (several
    processes, ``WORLD_SIZE`` > 1) each process drives its own share of
    the host's devices (``local_share``), and ``device_ids`` index into
    that share, as the JAX package's index its local devices: queue
    mode's workers, or under ``--sharding mesh`` this process's data rows
    of the global mesh (``parallel/distributed.py``)."""
    if cfg is not None:
        cpu = cfg.cpu if cpu is None else cpu
        device_ids = cfg.device_ids if device_ids is None else device_ids
    if cpu:
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass --cpu to run on the CPU")
    devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if world_size() > 1:
        devices = local_share(devices)
    if device_ids:
        bad = [i for i in device_ids if i < 0 or i >= len(devices)]
        if bad:
            raise ValueError(
                f"device_ids {bad} out of range: only {len(devices)} devices "
                f"visible ({[str(d) for d in devices]})"
            )
        return [devices[i] for i in device_ids]
    return devices
