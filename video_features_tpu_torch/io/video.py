"""Video decode and the frame samplers, on the native decoder or cv2.

Counterpart of ``video_features_tpu/io/video.py`` (``probe``,
``read_frames_at_indices``, ``extract_frames``, ``stream_frames``) with
its two backends behind one reader:

- ``native``: the port's own libav decoder (``native/decoder.cpp``:
  libavformat, libavcodec and libswscale through ctypes), which converts
  straight to RGB24;
- ``cv2``: OpenCV's ``VideoCapture`` (BGR, flipped to RGB per frame).

``--decoder`` picks: ``auto`` (the default) opens the native decoder
when its library builds and the file opens in it, else cv2, per file (the
native decoder refuses rotated streams, which cv2 rotates); ``native``
and ``cv2`` force one. An explicit ``native`` raises RuntimeError with
the build error when the library is absent, and CorruptVideoError on a
file it cannot open. Both give the same frames, byte for byte, where the
sweep of ``tests/test_torch_native.py`` checks them (synthetic mp4v clips
240 high, 320 to 432 wide). Each reader opened counts into
``native.readers_opened`` under the backend that opened it. The same
frame-exact sequential decode as the JAX package, so both packages sample
the same bytes from the same file. Each reader that opens is one call of
the ``decode`` fault-injection stage, as in the JAX package.

Decode notes: a source without a usable fps (timestamps then assume
25.0, ``fps_defaulted``) and a stream that ends more than 5% short of its
declared frame count (``partial_decode``) are noted on the decoding
thread; ``extract/base.py`` drains them (``pop_decode_warnings``) into
the run manifest as warnings, which ``--strict`` counts.

Each reader is one ``decode`` telemetry span (open to close) and counts
the frames it converts (``frames_decoded``), through the module hooks of
``runtime/telemetry.py``. ``--decode_timeout`` (``set_decode_timeout``)
bounds a reader's lifetime, and the input caps (``set_resource_caps``)
bound what it decodes: ``--max_pixels`` per frame, ``--max_duration_s``
in grabbed frames at the declared fps, ``--max_decode_bytes`` over the
RGB bytes it returns.

The shared-decode frame cache (``extract/plan.py``, ``set_frame_cache``)
is consulted by ``probe``, ``read_frames_at_indices``, ``extract_frames``
and ``stream_frames`` before they open a reader: a cached clip replays
its frames, with the direct decode's selection arithmetic, and nothing
is decoded again.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import cv2
import numpy as np

from video_features_tpu_torch import native
from video_features_tpu_torch.io.probe import MIN_SANE_FPS, NO_CAPS, ResourceCaps
from video_features_tpu_torch.runtime import faults, telemetry
from video_features_tpu_torch.runtime.faults import (
    CorruptVideoError,
    DecodeTimeout,
    ResourceCapExceeded,
)

DEFAULT_FPS = 25.0
DECODERS = ("auto", "cv2", "native")
# the backend of a reader opened without one (set_decoder)
_DECODER = "auto"
# --decode_timeout and the input caps, installed from the config by
# BaseExtractor; readers open deep inside the samplers, which take no
# config, so these are module state, rebound under _CONFIG_LOCK
_DECODE_TIMEOUT: Optional[float] = None
_RESOURCE_CAPS: ResourceCaps = NO_CAPS
# the shared-decode frame cache (extract/plan.py::SharedFrameCache), or None
_FRAME_CACHE = None
_CONFIG_LOCK = threading.Lock()

# decode notes accumulate per THREAD: readers open deep inside the
# samplers with no manifest in reach, and prepare runs one video at a time
# on each decode thread, so the thread maps a note to its video
_NOTES = threading.local()


def _note(kind: str, message: str, **fields: object) -> None:
    items = getattr(_NOTES, "items", None)
    if items is None:
        items = _NOTES.items = []
    note: Dict[str, object] = {"kind": kind, "message": message, **fields}
    if note not in items:  # one fps note per video, not one per reader
        items.append(note)


def pop_decode_warnings() -> List[Dict[str, object]]:
    """This thread's decode notes since the last call, each ``{'kind',
    'message', ...}`` (``partial_decode`` notes also carry ``decoded`` and
    ``declared``)."""
    items = getattr(_NOTES, "items", None) or []
    _NOTES.items = []
    return items


def set_decoder(name: str) -> None:
    """The backend of readers opened without one: ``auto``, ``cv2`` or
    ``native``."""
    global _DECODER
    _DECODER = _resolve(name)


def _resolve(decoder: Optional[str]) -> str:
    d = decoder or _DECODER
    if d not in DECODERS:
        raise ValueError(f"unknown decoder backend: {d!r}")
    return d


def set_decode_timeout(seconds: Optional[float]) -> None:
    """Wall-clock budget of a reader's lifetime (``--decode_timeout``): a
    reader open longer raises :class:`DecodeTimeout` from its next
    ``grab``. None disables."""
    global _DECODE_TIMEOUT
    with _CONFIG_LOCK:
        _DECODE_TIMEOUT = float(seconds) if seconds else None


def set_resource_caps(caps: Optional[ResourceCaps]) -> None:
    """Install the ``--max_pixels`` / ``--max_duration_s`` /
    ``--max_decode_bytes`` running budget: every reader opened later
    takes a snapshot and raises :class:`ResourceCapExceeded` the moment
    the actual decode crosses a cap."""
    global _RESOURCE_CAPS
    with _CONFIG_LOCK:
        _RESOURCE_CAPS = caps or NO_CAPS


def set_frame_cache(cache) -> None:
    """Install (or, with None, remove) the shared-decode frame cache.
    Scoped by the caller — extract/plan.py's fan-out context manager,
    the serve daemon's lifetime — and module-global like the decode
    timeout, because the samplers that benefit are constructed deep
    inside extractors that don't thread config through."""
    global _FRAME_CACHE
    with _CONFIG_LOCK:
        _FRAME_CACHE = cache


def _cached_clip(path: str, decoder: Optional[str]):
    """The cached decoded clip for ``path`` when a frame cache is
    installed and admits it, else None (open a reader). Decode errors
    from a cache population propagate unchanged — same failure
    surface as a direct open."""
    with _CONFIG_LOCK:
        cache = _FRAME_CACHE
    if cache is None:
        return None
    return cache.acquire(str(path), decoder)


def _stream_from_cached(
    clip, extraction_fps: Optional[float], path: str
) -> Iterator[Tuple[np.ndarray, float]]:
    """:func:`stream_frames`' exact selection arithmetic replayed over a
    cached frame list — same grid formula, same duplicate-on-upsample
    behavior, same stop-at-decodable-end — so cached and direct streams
    are bit-identical."""
    src_fps = fps_or_default(clip.fps, path)
    frames = clip.frames
    if extraction_fps is None:
        for i, frame in enumerate(frames):
            yield frame, i * 1000.0 / src_fps
    else:
        out_k = 0
        while True:
            target = int(round(out_k * src_fps / extraction_fps))
            if target >= len(frames):
                return
            yield frames[target], out_k * 1000.0 / extraction_fps
            out_k += 1


def fps_or_default(fps: float, path: str) -> float:
    """``fps``, or the 25.0 fallback for an absent fps, noted so that it
    reaches the manifest instead of becoming a silent default."""
    if fps:
        return fps
    _note(
        "fps_defaulted",
        f"fps metadata absent or ~zero; timestamps assume 25.0 fps: {path}",
    )
    return DEFAULT_FPS


class _Reader:
    """A grab/retrieve reader over either backend, always yielding RGB, with
    the JAX reader's bookkeeping: sanitised fps and declared count, frames
    grabbed, and whether the stream ended; ``close`` notes a
    ``partial_decode`` when the stream ended more than 5% (at least 2
    frames) short of its declared count. A sampler that stops early notes
    nothing.

    ``decoder`` is this reader's backend (extractors pass their config's),
    None the module's (``set_decoder``); ``auto`` falls back to cv2 per
    file. Its lifetime is one ``decode`` span. A reader past its
    ``--decode_timeout`` deadline raises :class:`DecodeTimeout` at the
    next ``grab``; past a cap, :class:`ResourceCapExceeded`."""

    def __init__(self, path: str, decoder: Optional[str] = None) -> None:
        self._span = telemetry.begin("decode", video=str(path))
        self._path = str(path)
        self._nat = self._cap = None
        d = _resolve(decoder)
        if d != "cv2":
            if native.decoder_available():
                try:
                    self._nat = native.NativeVideoReader(self._path)
                except IOError as e:
                    if d == "native":  # bad bytes, not a flake: no retry
                        raise CorruptVideoError(str(e)) from e
            elif d == "native":
                raise RuntimeError(
                    "--decoder native requested but the decode library is "
                    f"unavailable: {native.decoder_build_error()}"
                )
        if self._nat is not None:
            fps = self._nat.fps or 0.0
            count = int(self._nat.frame_count or 0)
            self.width, self.height = self._nat.width, self._nat.height
        else:
            self._cap = cv2.VideoCapture(self._path)
            if not self._cap.isOpened():
                self._cap.release()
                raise CorruptVideoError(f"cannot open video: {path}")
            fps = self._cap.get(cv2.CAP_PROP_FPS) or 0.0
            count = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
            self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        native.readers_opened["native" if self._nat is not None else "cv2"] += 1
        self.fps = float(fps) if math.isfinite(fps) and fps >= MIN_SANE_FPS else 0.0
        self.frame_count = count if 0 <= count <= 10 ** 9 else 0
        # a snapshot: a rebind mid-read does not change this reader's budget
        with _CONFIG_LOCK:
            timeout, self._caps = _DECODE_TIMEOUT, _RESOURCE_CAPS
        self._timeout = timeout
        self._deadline = time.monotonic() + timeout if timeout else None
        self._grabs = 0
        self._retrieved_bytes = 0
        self._eof = False
        self._closed = False
        caps = self._caps
        if caps.max_pixels is not None and self.width * self.height > caps.max_pixels:
            self._release()
            raise ResourceCapExceeded(
                f"declared frame size {self.width}x{self.height} exceeds "
                f"--max_pixels {caps.max_pixels}: {path}"
            )
        self._max_frames = (
            int(caps.max_duration_s * (self.fps or DEFAULT_FPS)) + 1
            if caps.max_duration_s is not None
            else None
        )
        try:
            # an injected 'decode' fault lands after the open: a hang eats
            # into this reader's deadline as a stalled demuxer would
            faults.fire("decode")
        except BaseException:
            self._release()
            raise

    def _release(self) -> None:
        if self._nat is not None:
            self._nat.close()
        else:
            self._cap.release()

    def grab(self) -> bool:
        if self._deadline is not None and time.monotonic() > self._deadline:
            raise DecodeTimeout(
                f"decode exceeded --decode_timeout {self._timeout:g}s: {self._path}"
            )
        ok = self._nat.grab() >= 0 if self._nat is not None else self._cap.grab()
        if not ok:
            self._eof = True
            return False
        self._grabs += 1
        if self._max_frames is not None and self._grabs > self._max_frames:
            raise ResourceCapExceeded(
                f"decoded past --max_duration_s {self._caps.max_duration_s:g} "
                f"(~{self._max_frames} frames at {self.fps or DEFAULT_FPS:g} fps) — "
                f"declared metadata lied: {self._path}"
            )
        return True

    def retrieve(self) -> Optional[np.ndarray]:
        """The grabbed frame as RGB uint8 HWC, or None."""
        if self._nat is not None:
            frame = self._nat.retrieve()
        else:
            ok, frame = self._cap.retrieve()
            if not ok:
                return None
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        caps = self._caps
        if caps.max_pixels is not None:
            px = int(frame.shape[0]) * int(frame.shape[1])
            if px > caps.max_pixels:
                raise ResourceCapExceeded(
                    f"decoded frame {frame.shape[1]}x{frame.shape[0]} ({px} pixels) "
                    f"exceeds --max_pixels {caps.max_pixels}: {self._path}"
                )
        if caps.max_decode_bytes is not None:
            self._retrieved_bytes += int(frame.nbytes)
            if self._retrieved_bytes > caps.max_decode_bytes:
                raise ResourceCapExceeded(
                    f"decoded {self._retrieved_bytes} bytes, over --max_decode_bytes "
                    f"{caps.max_decode_bytes}: {self._path}"
                )
        telemetry.frame_decoded()
        return frame

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._release()
        declared = self.frame_count
        if (self._eof and declared > 0 and self._grabs < declared
                and declared - self._grabs > max(1, declared // 20)):
            _note(
                "partial_decode",
                f"partial decode: {self._grabs} of {declared} "
                f"declared frames decodable: {self._path}",
                decoded=self._grabs,
                declared=declared,
            )
        telemetry.end(self._span)

    def __enter__(self) -> "_Reader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def probe(path: str, decoder: Optional[str] = None) -> Tuple[float, int]:
    """(fps, frame_count) from the container's metadata; fps is 0.0 and
    the count 0 where they are absent or insane."""
    clip = _cached_clip(path, decoder)
    if clip is not None:
        return clip.fps, clip.frame_count
    with _Reader(path, decoder) as r:  # metadata only: no stream read, nothing to note
        return r.fps, r.frame_count


def frame_size(path: str, decoder: Optional[str] = None) -> Tuple[int, int]:
    """(height, width) from the container's metadata, (0, 0) where absent;
    reads no frame (the prefetch caps of ``--preprocess device`` count
    source-resolution bytes before any decode). Opens no ``_Reader``: no
    span, no fault stage, no count."""
    if _resolve(decoder) != "cv2" and native.decoder_available():
        try:
            with native.NativeVideoReader(str(path)) as r:
                return max(r.height, 0), max(r.width, 0)
        except IOError:
            pass  # cv2 reads what the native decoder will not open
    cap = cv2.VideoCapture(str(path))
    try:
        return (max(int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)), 0),
                max(int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)), 0))
    finally:
        cap.release()


def read_frames_at_indices(
    path: str, indices, decoder: Optional[str] = None
) -> Dict[int, np.ndarray]:
    """{index: RGB uint8 HWC frame} for the wanted indices, by sequential
    decode up to the largest (seeks can land off by frames); indices past
    the decodable end are absent."""
    need = sorted(set(int(i) for i in indices))
    got: Dict[int, np.ndarray] = {}
    if not need:
        return got
    clip = _cached_clip(path, decoder)
    if clip is not None:
        # the cached list is the sequential decode's output: indices
        # past its end are absent, exactly like a grab() miss below
        return {i: clip.frames[i] for i in need if i < len(clip.frames)}
    wanted = set(need)
    with _Reader(path, decoder) as r:
        for i in range(need[-1] + 1):
            if not r.grab():
                break
            if i in wanted:
                frame = r.retrieve()
                if frame is not None:
                    got[i] = frame
    return got


def extract_frames(
    path: str, method: str, decoder: Optional[str] = None
) -> Tuple[List[np.ndarray], float, List[float]]:
    """``fix_<fps>`` / ``uni_<N>``: frames at ``linspace(1, n - 2, k)``
    (first and last frames skipped, as the reference does). Returns (RGB
    frames, source fps, timestamps_ms)."""
    ext, *params = method.split("_")
    fps, frame_cnt = probe(path, decoder)
    fps = fps_or_default(fps, path)
    if frame_cnt < 3:
        raise CorruptVideoError(
            f"video too short for sampling: {frame_cnt} of {frame_cnt} "
            f"declared frames, sampler needs 3: {path}"
        )
    if ext == "fix":
        samples_num = int(frame_cnt / fps * int(params[0]))
    elif ext == "uni":
        samples_num = int(params[0])
    else:
        raise NotImplementedError(f"extract method {ext!r} is not supported")
    samples_ix = np.linspace(1, frame_cnt - 2, max(samples_num, 1)).astype(int)
    got = read_frames_at_indices(path, samples_ix, decoder)
    if not got:
        raise CorruptVideoError(
            f"no frames decoded (0 of {frame_cnt} declared frames): {path}"
        )
    # duplicate indices (short videos) reuse one frame; indices past the
    # decodable end repeat the last decoded one
    last_seen = None
    frames = []
    for ix in samples_ix:
        if ix in got:
            last_seen = got[ix]
        frames.append(last_seen if last_seen is not None else next(iter(got.values())))
    mspf = 1000.0 / fps
    return frames, fps, [float(ix) * mspf for ix in samples_ix]


def stream_frames(
    path: str, extraction_fps: Optional[float] = None, decoder: Optional[str] = None
) -> Iterator[Tuple[np.ndarray, float]]:
    """Yield (RGB uint8 HWC frame, timestamp_ms) by sequential decode.

    With ``extraction_fps``, output frame k is source frame
    ``round(k * src_fps / extraction_fps)``: a source frame repeats when
    upsampling and is grabbed but never converted when skipped. The
    source fps is the container's, or 25.0 (noted) where it is absent."""
    clip = _cached_clip(path, decoder)
    if clip is not None:
        yield from _stream_from_cached(clip, extraction_fps, str(path))
        return
    with _Reader(path, decoder) as r:
        src_fps = fps_or_default(r.fps, path)
        if extraction_fps is None:
            i = 0
            while r.grab():
                frame = r.retrieve()
                if frame is None:
                    return
                yield frame, i * 1000.0 / src_fps
                i += 1
            return
        out_k, src_i, frame = 0, -1, None
        while True:
            target = int(round(out_k * src_fps / extraction_fps))
            fresh = False
            while src_i < target:
                if not r.grab():
                    return
                fresh, src_i = True, src_i + 1
            if fresh:
                frame = r.retrieve()
                if frame is None:
                    return
            yield frame, out_k * 1000.0 / extraction_fps
            out_k += 1
