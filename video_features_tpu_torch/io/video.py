"""Video decode and the frame samplers, with cv2.

Counterpart of ``video_features_tpu/io/video.py`` (``probe``,
``read_frames_at_indices``, ``extract_frames``, ``stream_frames``) on its
cv2 backend: the same frame-exact sequential decode, so both packages
sample the same bytes from the same file. Each reader that opens is one
call of the ``decode`` fault-injection stage, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Tuple

import cv2
import numpy as np

from video_features_tpu_torch.runtime import faults
from video_features_tpu_torch.runtime.faults import CorruptVideoError

# declared fps below this is absent fps (hostile headers declare ~1e-10)
MIN_SANE_FPS = 1e-3
DEFAULT_FPS = 25.0


def probe(path: str) -> Tuple[float, int]:
    """(fps, frame_count) from the container's metadata; fps is 0.0 and
    the count 0 where they are absent or insane."""
    cap = cv2.VideoCapture(str(path))
    try:
        if not cap.isOpened():
            raise CorruptVideoError(f"cannot open video: {path}")
        faults.fire("decode")
        fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
        count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()
    fps = float(fps) if math.isfinite(fps) and fps >= MIN_SANE_FPS else 0.0
    if count < 0 or count > 10 ** 9:
        count = 0
    return fps, count


def read_frames_at_indices(path: str, indices) -> Dict[int, np.ndarray]:
    """{index: RGB uint8 HWC frame} for the wanted indices, by sequential
    decode up to the largest (seeks can land off by frames); indices past
    the decodable end are absent."""
    need = sorted(set(int(i) for i in indices))
    got: Dict[int, np.ndarray] = {}
    if not need:
        return got
    wanted = set(need)
    cap = cv2.VideoCapture(str(path))
    try:
        if not cap.isOpened():
            raise CorruptVideoError(f"cannot open video: {path}")
        faults.fire("decode")
        for i in range(need[-1] + 1):
            if not cap.grab():
                break
            if i in wanted:
                ok, frame = cap.retrieve()
                if ok:
                    got[i] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
    finally:
        cap.release()
    return got


def extract_frames(path: str, method: str) -> Tuple[List[np.ndarray], float, List[float]]:
    """``fix_<fps>`` / ``uni_<N>``: frames at ``linspace(1, n - 2, k)``
    (first and last frames skipped, as the reference does). Returns (RGB
    frames, source fps, timestamps_ms)."""
    ext, *params = method.split("_")
    fps, frame_cnt = probe(path)
    fps = fps or DEFAULT_FPS
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
    got = read_frames_at_indices(path, samples_ix)
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
    path: str, extraction_fps: Optional[float] = None
) -> Iterator[Tuple[np.ndarray, float]]:
    """Yield (RGB uint8 HWC frame, timestamp_ms) by sequential decode.

    With ``extraction_fps``, output frame k is source frame
    ``round(k * src_fps / extraction_fps)``: a source frame repeats when
    upsampling and is grabbed but never converted when skipped. The
    source fps is the container's, or 25.0 where it is absent."""
    cap = cv2.VideoCapture(str(path))
    try:
        if not cap.isOpened():
            raise CorruptVideoError(f"cannot open video: {path}")
        faults.fire("decode")
        fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
        src_fps = float(fps) if math.isfinite(fps) and fps >= MIN_SANE_FPS else DEFAULT_FPS
        if extraction_fps is None:
            i = 0
            while True:
                ok, frame = cap.read()
                if not ok:
                    return
                yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB), i * 1000.0 / src_fps
                i += 1
        out_k, src_i, frame = 0, -1, None
        while True:
            target = int(round(out_k * src_fps / extraction_fps))
            fresh = False
            while src_i < target:
                if not cap.grab():
                    return
                fresh, src_i = True, src_i + 1
            if fresh:
                ok, bgr = cap.retrieve()
                if not ok:
                    return
                frame = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
            yield frame, out_k * 1000.0 / extraction_fps
            out_k += 1
    finally:
        cap.release()
