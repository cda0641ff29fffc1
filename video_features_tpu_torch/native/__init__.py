"""Native (C++) host components: the preprocess chains and the libav
decoder, built at first use and bound with ctypes.

Counterpart of ``video_features_tpu/native/__init__.py``, with its own
copies of the sources beside this file:

- ``preprocess.cpp``: the threaded ImageNet (bilinear) and CLIP
  (bicubic) resize, center crop and normalize chains of
  ``--host_preprocess native``, within ~1/255 per pixel of PIL;
- ``decoder.cpp``: libavformat demux, libavcodec decode and libswscale
  RGB24 of ``--decoder native``, with grab (decode only) apart from
  retrieve (convert). It converts into a buffer of its own, aligned and
  padded, and copies the rows out: swscale's SIMD paths store past the
  last pixel of a row (a heap overrun in an exact-size destination) and
  convert the last ``w mod 16`` columns of an unaligned one differently
  from cv2.

Each library is built with ``g++ -O3 -shared -fPIC -std=c++17 -pthread``
into ``video_features_tpu_torch/_build/`` (git-ignored), its file name
carrying a hash of its source and flags, so an edited source is rebuilt
and a current one reused; a build goes to a per-process temp file and is
renamed into place. The decoder links ``-lavformat -lavcodec -lswscale
-lavutil``, so it needs the libav headers; the preprocess library needs
only ``g++``. ``available()`` / ``decoder_available()`` say whether each
built, and ``build_error()`` / ``decoder_build_error()`` why not.

``readers_opened`` counts the readers ``io/video.py`` opened, by backend
(``native`` or ``cv2``), as the kernels' ``launches`` count launches, so
a run can show which decoder it used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Dict, Optional, Sequence

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
DECODER_LIBS = ("-lavformat", "-lavcodec", "-lswscale", "-lavutil")

_lock = threading.Lock()
# name -> the loaded library, or the build error that stopped it
_libs: Dict[str, ctypes.CDLL] = {}
_errors: Dict[str, str] = {}

# readers opened by io/video.py, by backend
readers_opened: Dict[str, int] = {"native": 0, "cv2": 0}


def reset_reader_counts() -> None:
    for k in readers_opened:
        readers_opened[k] = 0


def library_path(name: str, libs: Sequence[str] = ()) -> pathlib.Path:
    """``_build/lib<name>-<hash>.so``: the hash covers the source and the
    flags, so a changed source or flag names a new library."""
    src = (_DIR / f"{name}.cpp").read_bytes()
    flags = " ".join((*CXX_FLAGS, *libs)).encode()
    digest = hashlib.sha256(src + flags).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str, libs: Sequence[str] = (), force: bool = False) -> pathlib.Path:
    """Compile ``<name>.cpp`` unless its library is current (or ``force``);
    returns the library's path. Raises RuntimeError with the compiler's
    message."""
    out = library_path(name, libs)
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a per-process temp and a rename: processes building at once never
    # load a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}-{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(_DIR / f"{name}.cpp"), "-o", str(tmp), *libs]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{type(exc).__name__}: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {name}.cpp:\n{proc.stderr[-2000:]}")
    os.replace(tmp, out)
    return out


def _bind_preprocess(lib: ctypes.CDLL) -> None:
    u8p, f32p, i = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float), ctypes.c_int
    lib.imagenet_preprocess_batch.argtypes = [u8p, i, i, i, i, i, f32p, f32p, f32p, i]
    lib.imagenet_preprocess_batch.restype = None
    lib.clip_preprocess_batch.argtypes = [u8p, i, i, i, i, f32p, f32p, f32p, i]
    lib.clip_preprocess_batch.restype = None


def _bind_decoder(lib: ctypes.CDLL) -> None:
    vp = ctypes.c_void_p
    lib.vfdec_open.argtypes = [ctypes.c_char_p]
    lib.vfdec_open.restype = vp
    lib.vfdec_probe.argtypes = [
        vp, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.vfdec_probe.restype = None
    lib.vfdec_grab.argtypes = [vp]
    lib.vfdec_grab.restype = ctypes.c_int64
    lib.vfdec_retrieve.argtypes = [vp, ctypes.POINTER(ctypes.c_uint8)]
    lib.vfdec_retrieve.restype = ctypes.c_int
    lib.vfdec_close.argtypes = [vp]
    lib.vfdec_close.restype = None


_SPECS = {
    "preprocess": ((), _bind_preprocess),
    "decoder": (DECODER_LIBS, _bind_decoder),
}


def _load(name: str) -> Optional[ctypes.CDLL]:
    """The library ``name`` (built and bound on first use), or None with
    its error kept: one attempt per process."""
    with _lock:
        if name in _libs or name in _errors:
            return _libs.get(name)
        libs, bind = _SPECS[name]
        try:
            existed = library_path(name, libs).exists()
            try:
                lib = ctypes.CDLL(str(build(name, libs)))
            except OSError:
                if not existed:
                    raise
                # a library built on another host (a tree copied with its
                # _build/) may link libraries this one lacks: rebuild here
                lib = ctypes.CDLL(str(build(name, libs, force=True)))
        except (RuntimeError, OSError) as exc:
            _errors[name] = str(exc)
            return None
        bind(lib)
        _libs[name] = lib
        return lib


def cpu_budget() -> int:
    """Cores this process may run on: the scheduler's affinity mask where
    there is one (containers often pin it below ``os.cpu_count()``), else
    ``os.cpu_count()``."""
    try:
        return len(os.sched_getaffinity(0)) or 1
    except (AttributeError, OSError):  # not Linux
        return max(os.cpu_count() or 1, 1)


def _resolve_threads(threads: int) -> int:
    """Threads of a C++ batch chain: <= 0 is every core the process may
    use (at most 16); a request is clamped to that count, as threads past
    the cores only switch context."""
    budget = cpu_budget()
    if threads <= 0:
        return min(budget, 16)
    return min(threads, budget)


def available() -> bool:
    return _load("preprocess") is not None


def build_error() -> Optional[str]:
    _load("preprocess")
    return _errors.get("preprocess")


def _frames_u8(frames) -> np.ndarray:
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected (N, H, W, 3) uint8, got {frames.shape}")
    return frames


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _preprocess_lib() -> ctypes.CDLL:
    lib = _load("preprocess")
    if lib is None:
        raise RuntimeError(f"native preprocess unavailable: {_errors['preprocess']}")
    return lib


def imagenet_preprocess_batch(
    frames: np.ndarray,
    resize_to: int = 256,
    crop: int = 224,
    mean: Sequence[float] = (0.485, 0.456, 0.406),
    std: Sequence[float] = (0.229, 0.224, 0.225),
    threads: int = 0,
) -> np.ndarray:
    """(N, H, W, 3) uint8 frames -> (N, 3, crop, crop) float32 through the
    threaded C++ chain: PIL-style antialiased bilinear resize of the
    smaller edge to ``resize_to``, center crop, normalize."""
    lib = _preprocess_lib()
    frames = _frames_u8(frames)
    n, h, w, _ = frames.shape
    if min(h, w) < 1 or crop < 1 or resize_to < crop:
        raise ValueError(f"bad sizes: frame {h}x{w}, resize {resize_to}, crop {crop}")
    out = np.empty((n, 3, crop, crop), np.float32)
    mean_a = np.ascontiguousarray(mean, np.float32)
    std_a = np.ascontiguousarray(std, np.float32)
    lib.imagenet_preprocess_batch(
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, h, w, resize_to, crop,
        _f32p(mean_a), _f32p(std_a), _f32p(out), _resolve_threads(threads),
    )
    return out


def clip_preprocess_batch(
    frames: np.ndarray,
    size: int = 224,
    mean: Sequence[float] = (0.48145466, 0.4578275, 0.40821073),
    std: Sequence[float] = (0.26862954, 0.26130258, 0.27577711),
    threads: int = 0,
) -> np.ndarray:
    """(N, H, W, 3) uint8 frames -> (N, 3, size, size) float32 through the
    CLIP chain: bicubic resize of the smaller edge to ``size``, center
    crop, CLIP normalize."""
    lib = _preprocess_lib()
    frames = _frames_u8(frames)
    n, h, w, _ = frames.shape
    if min(h, w) < 1 or size < 1:
        raise ValueError(f"bad sizes: frame {h}x{w}, size {size}")
    out = np.empty((n, 3, size, size), np.float32)
    mean_a = np.ascontiguousarray(mean, np.float32)
    std_a = np.ascontiguousarray(std, np.float32)
    lib.clip_preprocess_batch(
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, h, w, size,
        _f32p(mean_a), _f32p(std_a), _f32p(out), _resolve_threads(threads),
    )
    return out


# --- the libav decoder (decoder.cpp): a library of its own, as libav may
# be absent where g++ (and so the preprocess library) is fine


def load_decoder() -> Optional[ctypes.CDLL]:
    """The bound decoder library, or None when it does not build."""
    return _load("decoder")


def decoder_available() -> bool:
    return load_decoder() is not None


def decoder_build_error() -> Optional[str]:
    load_decoder()
    return _errors.get("decoder")


class NativeVideoReader:
    """Sequential RGB frame reader over the C decoder.

    ``grab()`` decodes the next frame without converting it (returns its
    index, or -1 at the end); ``retrieve()`` converts the held frame to an
    (H, W, 3) RGB uint8 array. A sampler pays decode only for the frames
    it drops. Raises IOError on a file the decoder will not open
    (including a rotated stream: cv2 rotates those, this decoder does not)."""

    def __init__(self, path: str) -> None:
        lib = load_decoder()
        if lib is None:
            raise RuntimeError(f"native decoder unavailable: {_errors['decoder']}")
        self._lib = lib
        self._h = lib.vfdec_open(os.fsencode(path))
        if not self._h:
            raise IOError(f"native decoder could not open {path}")
        w, h = ctypes.c_int(), ctypes.c_int()
        fps, n = ctypes.c_double(), ctypes.c_int64()
        lib.vfdec_probe(self._h, ctypes.byref(w), ctypes.byref(h), ctypes.byref(fps),
                        ctypes.byref(n))
        self.width, self.height = w.value, h.value
        self.fps = fps.value or None
        self.frame_count = n.value or None  # the container's estimate

    def grab(self) -> int:
        return int(self._lib.vfdec_grab(self._h))

    def retrieve_into(self, out: np.ndarray) -> None:
        """Convert the held frame into ``out``, a C-contiguous uint8 buffer
        of at least height * width * 3 bytes."""
        if out.dtype != np.uint8 or not out.flags.c_contiguous \
                or out.size < self.height * self.width * 3:
            raise ValueError("retrieve_into needs a contiguous uint8 buffer of h * w * 3")
        if self._lib.vfdec_retrieve(self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))):
            raise IOError("native decoder retrieve failed")

    def retrieve(self) -> np.ndarray:
        out = np.empty((self.height, self.width, 3), np.uint8)
        self.retrieve_into(out)
        return out

    def read(self) -> Optional[np.ndarray]:
        """cv2-style: the next frame as RGB, or None at the end."""
        if self.grab() < 0:
            return None
        return self.retrieve()

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.vfdec_close(self._h)
            self._h = None

    def __enter__(self) -> "NativeVideoReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # close() is the contract; this is a last resort
        try:
            self.close()
        except Exception:
            pass
