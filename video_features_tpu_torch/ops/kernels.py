"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled at first
use by ``nvcc`` into its own shared library under ``_build/`` (listed in
.gitignore), then loaded with ``ctypes``. A library's file name carries a
hash of its source and flags, so an edited source is rebuilt and a
current one is reused. Nothing here includes PyTorch's headers: a source
builds in seconds, where ``torch.utils.cpp_extension.load`` takes minutes.

The wrappers (e.g. ``ops/flash_attention.py``) pass pointers from
``Tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream().cuda_stream`` as ``ctypes.c_void_p``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import torch

PACKAGE_ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = PACKAGE_ROOT / "csrc"
BUILD_DIR = PACKAGE_ROOT / "_build"
# -Xptxas=-v writes each kernel's registers, shared memory and spills to
# the build log beside the library
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """One more launch on ``wrapper.launches``, under a lock: queue mode's
    workers launch from several threads, and an unlocked ``+= 1`` can lose
    a count."""
    with _count_lock:
        wrapper.launches += 1


def sources():
    """The kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built at first use; set "
            "CUDA_HOME to the CUDA toolkit"
        )
    return found


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its library is current; returns
    the library's path. The compiler's output goes to ``<library>.log``."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}-{threading.get_ident()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stdout}{proc.stderr}")
    out.with_name(out.name + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # readers see a whole library or none
    return out


def build_all() -> Dict[str, float]:
    """Build every kernel, one ``nvcc`` per source, all started together.
    Returns each source's build seconds (0 when it was already current)."""

    def timed(name):
        t0 = time.perf_counter()
        build(name)
        return time.perf_counter() - t0

    names = sources()
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(timed, names)))


def on_device(device):
    """The context that makes ``device`` current: none when it already is,
    which saves a device switch per launch."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build(name)
            try:
                lib = _libs[name] = ctypes.CDLL(str(path))
            except OSError as exc:  # not an I/O flake: a retry loads the same file
                raise RuntimeError(f"kernel library {path} does not load: {exc}") from exc
        return lib
