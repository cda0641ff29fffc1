"""Preflight media probe: the vouching stage in front of every decode.

Counterpart of ``video_features_tpu/io/probe.py``. :func:`preflight`
answers three questions without real decode work:

- does the container open at all, and does it carry a stream of the
  kind the consumer needs (``need='video'`` or ``'audio'``)?
- is the declared metadata sane (dimensions, fps, frame count), and
  does it fit inside the resource caps (``--max_pixels``,
  ``--max_duration_s``, ``--max_decode_bytes``)?
- does ONE frame actually decode (the cheapest proof that the bitstream
  is not garbage behind a healthy-looking header)?

and folds the answers into a :class:`MediaReport` with a three-way
verdict: ``ok`` (admit), ``caution`` (admit, and record the warnings:
absent fps, insane declared frame count) or ``reject`` (a manifest
``failed`` record at stage ``preflight``, permanent, zero retries).

Deliberately not built on ``io/video.py``'s ``_Reader``: the probe must
not open a telemetry ``decode`` span or advance the ``--fault_inject
decode:*`` counters (one reader open per attempt), and must not start a
decode deadline. It opens cv2 directly, reads the header, optionally
grabs one frame, and releases. The declared-metadata caps here are the
first line; the reader enforces the same caps again as a running budget
over the actual decode, so a header that lies past the probe still
cannot blow host RAM.
"""

from __future__ import annotations

import dataclasses
import math
import os
import struct
from typing import Any, Dict, List, Optional, Tuple

from video_features_tpu_torch.runtime.faults import MediaRejected, ResourceCapExceeded

# extensions the probe knows how to open; anything else (directories of
# pre-extracted flow frames, exotic containers) skips probing with a
# warning rather than rejecting what the decoder might still handle
VIDEO_EXTENSIONS = (
    ".mp4", ".avi", ".mkv", ".mov", ".webm", ".m4v",
    ".mpg", ".mpeg", ".wmv", ".flv", ".3gp",
)
AUDIO_EXTENSIONS = (".wav",)

# below this, declared fps is treated as ABSENT (hostile AVIs can declare
# dwScale ~2^32 -> fps ~1e-10; near-zero must trip the same recorded
# 25.0-default warning as exactly zero); above MAX_SANE_FPS it is a lie
MIN_SANE_FPS = 1e-3
MAX_SANE_FPS = 1000.0
# a declared frame count past this is header garbage, not a long video
MAX_SANE_FRAMES = 10 ** 9


@dataclasses.dataclass(frozen=True)
class ResourceCaps:
    """The three input resource caps, all optional (None = uncapped).

    ``max_pixels`` bounds one frame's width*height; ``max_duration_s``
    bounds the clip length; ``max_decode_bytes`` bounds the total RGB
    bytes a single reader may materialize (frames * w * h * 3)."""

    max_pixels: Optional[int] = None
    max_duration_s: Optional[float] = None
    max_decode_bytes: Optional[int] = None

    @classmethod
    def from_config(cls, cfg: Any) -> "ResourceCaps":
        return cls(
            max_pixels=getattr(cfg, "max_pixels", None),
            max_duration_s=getattr(cfg, "max_duration_s", None),
            max_decode_bytes=getattr(cfg, "max_decode_bytes", None),
        )

    def enabled(self) -> bool:
        return any(
            v is not None
            for v in (self.max_pixels, self.max_duration_s, self.max_decode_bytes)
        )


NO_CAPS = ResourceCaps()


@dataclasses.dataclass
class MediaReport:
    """One probed input, classified. ``verdict`` is 'ok' | 'caution' |
    'reject'; ``reason`` is set only on reject; ``warnings`` carry the
    caution findings (recorded in the manifest, never fatal).
    ``cap_exceeded`` distinguishes a resource-cap reject (raises
    :class:`ResourceCapExceeded`) from a bad-media reject (raises
    :class:`MediaRejected`)."""

    path: str
    need: str = "video"
    verdict: str = "ok"
    reason: Optional[str] = None
    warnings: List[str] = dataclasses.field(default_factory=list)
    container: Optional[str] = None  # 'video' | 'wav' | None (unprobed)
    width: int = 0
    height: int = 0
    fps: float = 0.0
    frame_count: int = 0
    duration_s: Optional[float] = None
    size_bytes: int = 0
    first_frame_ok: Optional[bool] = None  # None = check not performed
    cap_exceeded: bool = False

    def _reject(self, reason: str, cap: bool = False) -> "MediaReport":
        self.verdict = "reject"
        self.reason = reason
        self.cap_exceeded = cap
        return self

    def _finish(self) -> "MediaReport":
        if self.verdict != "reject":
            self.verdict = "caution" if self.warnings else "ok"
        return self

    def to_error(self) -> Exception:
        """The taxonomy exception for a reject verdict (permanent,
        input-classified either way); raises nothing itself."""
        cls = ResourceCapExceeded if self.cap_exceeded else MediaRejected
        exc = cls(f"preflight rejected {self.path}: {self.reason}")
        exc.stage = "preflight"
        return exc

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _sniff_riff_wave(path: str) -> bool:
    """True when the file's magic says RIFF/WAVE — an audio container no
    matter what its extension claims (.avi is RIFF too, but tags 'AVI ')."""
    try:
        with open(path, "rb") as fh:
            head = fh.read(12)
    except OSError:
        return False
    return len(head) == 12 and head[:4] == b"RIFF" and head[8:12] == b"WAVE"


def _probe_wav(report: MediaReport, caps: ResourceCaps) -> MediaReport:
    """Walk the RIFF chunks of a wav: fmt gives sample rate/byte rate,
    data gives payload size — enough for duration and byte caps without
    reading the samples (scipy's reader would load everything)."""
    report.container = "wav"
    sample_rate = byte_rate = data_bytes = 0
    try:
        with open(report.path, "rb") as fh:
            fh.seek(12)  # past RIFF<size>WAVE
            while True:
                hdr = fh.read(8)
                if len(hdr) < 8:
                    break
                tag, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
                if tag == b"fmt " and size >= 16:
                    fmt = fh.read(size)
                    _, channels, sample_rate, byte_rate = struct.unpack(
                        "<HHII", fmt[:12]
                    )
                elif tag == b"data":
                    data_bytes = size
                    break
                else:
                    fh.seek(size + (size & 1), os.SEEK_CUR)
    except (OSError, struct.error) as exc:
        return report._reject(f"unparseable wav header ({exc})")
    if sample_rate <= 0 or data_bytes <= 0:
        return report._reject(
            f"wav has no decodable audio (sample_rate={sample_rate}, "
            f"data_bytes={data_bytes})"
        )
    report.fps = float(sample_rate)
    if byte_rate > 0:
        report.duration_s = data_bytes / byte_rate
    if caps.max_duration_s is not None and report.duration_s is not None \
            and report.duration_s > caps.max_duration_s:
        return report._reject(
            f"declared audio duration {report.duration_s:.1f}s exceeds "
            f"--max_duration_s {caps.max_duration_s:g}", cap=True,
        )
    if caps.max_decode_bytes is not None and data_bytes > caps.max_decode_bytes:
        return report._reject(
            f"declared audio payload {data_bytes} bytes exceeds "
            f"--max_decode_bytes {caps.max_decode_bytes}", cap=True,
        )
    report.first_frame_ok = True
    return report._finish()


def _read_video_header(path: str) -> Tuple[Any, Dict[str, float]]:
    import cv2

    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        cap.release()
        return None, {}
    meta = {
        "fps": cap.get(cv2.CAP_PROP_FPS) or 0.0,
        "frame_count": cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0.0,
        "width": cap.get(cv2.CAP_PROP_FRAME_WIDTH) or 0.0,
        "height": cap.get(cv2.CAP_PROP_FRAME_HEIGHT) or 0.0,
    }
    return cap, meta


def _probe_video(
    report: MediaReport, caps: ResourceCaps, first_frame: bool
) -> MediaReport:
    cap, meta = _read_video_header(report.path)
    if cap is None:
        return report._reject("container does not open (no decodable video stream)")
    try:
        report.container = "video"
        fps = float(meta["fps"])
        if not math.isfinite(fps) or fps < MIN_SANE_FPS:
            fps = 0.0
        report.width = int(meta["width"])
        report.height = int(meta["height"])
        raw_count = meta["frame_count"]
        if not math.isfinite(raw_count) or not (0 <= raw_count <= MAX_SANE_FRAMES):
            report.warnings.append(
                f"declared frame count is insane ({raw_count:g}); treating as unknown"
            )
            report.frame_count = 0
        else:
            report.frame_count = int(raw_count)
        if fps == 0.0:
            report.warnings.append(
                "fps metadata absent or ~zero; decode will assume 25.0"
            )
        elif fps > MAX_SANE_FPS:
            report.warnings.append(f"declared fps is insane ({fps:g})")
        report.fps = fps
        if report.width <= 0 or report.height <= 0:
            report.warnings.append("declared frame dimensions missing from header")
        eff_fps = fps if 0.0 < fps <= MAX_SANE_FPS else 25.0
        if report.frame_count > 0:
            report.duration_s = report.frame_count / eff_fps

        # declared-metadata caps: the cheap half of the resource guard
        # (io/video.py re-enforces over actual decode)
        pixels = report.width * report.height
        if caps.max_pixels is not None and pixels > caps.max_pixels:
            return report._reject(
                f"declared frame size {report.width}x{report.height} "
                f"({pixels} pixels) exceeds --max_pixels {caps.max_pixels}",
                cap=True,
            )
        if caps.max_duration_s is not None and report.duration_s is not None \
                and report.duration_s > caps.max_duration_s:
            return report._reject(
                f"declared duration {report.duration_s:.1f}s "
                f"({report.frame_count} frames at {eff_fps:g} fps) exceeds "
                f"--max_duration_s {caps.max_duration_s:g}", cap=True,
            )
        if caps.max_decode_bytes is not None and report.frame_count > 0 and pixels > 0:
            declared_bytes = report.frame_count * pixels * 3
            if declared_bytes > caps.max_decode_bytes:
                return report._reject(
                    f"declared decode size {declared_bytes} bytes "
                    f"({report.frame_count} frames x {report.width}x"
                    f"{report.height}x3) exceeds --max_decode_bytes "
                    f"{caps.max_decode_bytes}", cap=True,
                )

        if first_frame:
            ok = bool(cap.grab())
            report.first_frame_ok = ok
            if not ok:
                return report._reject(
                    "no decodable frames (first frame does not decode)"
                )
    finally:
        cap.release()
    return report._finish()


def preflight(
    path: str,
    need: str = "video",
    caps: Optional[ResourceCaps] = None,
    first_frame: bool = True,
) -> MediaReport:
    """Probe one input and classify it. Never raises for bad media —
    the verdict IS the answer (use :func:`preflight_or_raise` for the
    exception-shaped form the extract pipeline wants)."""
    caps = caps or NO_CAPS
    report = MediaReport(path=str(path), need=need)
    if not os.path.exists(path):
        return report._reject("file does not exist")
    if os.path.isdir(path):
        # pre-extracted flow-frame directories and the like: nothing to
        # probe, and rejecting them would break legitimate inputs
        report.warnings.append("directory input; media preflight skipped")
        return report._finish()
    report.size_bytes = os.path.getsize(path)
    if report.size_bytes == 0:
        return report._reject("empty file (0 bytes)")

    ext = os.path.splitext(path)[1].lower()
    is_wave = ext in AUDIO_EXTENSIONS or _sniff_riff_wave(path)
    if need == "audio":
        if is_wave:
            return _probe_wav(report, caps)
        # a video container bound for the audio path: the container must
        # at least open; audio-stream presence is only provable with an
        # ffmpeg probe, so decode-time classification (io/audio.py)
        # carries that part of the contract
        report.warnings.append(
            "audio stream presence not verifiable without decode; "
            "container checked as video only"
        )
        return _probe_video(report, caps, first_frame)
    if is_wave:
        return report._reject("audio-only container (RIFF/WAVE): no video stream")
    if ext not in VIDEO_EXTENSIONS:
        report.warnings.append(
            f"unrecognized extension {ext or '(none)'}; media preflight skipped"
        )
        return report._finish()
    return _probe_video(report, caps, first_frame)


def preflight_or_raise(
    path: str,
    need: str = "video",
    caps: Optional[ResourceCaps] = None,
    first_frame: bool = True,
) -> MediaReport:
    """:func:`preflight`, raising the taxonomy exception on reject —
    :class:`ResourceCapExceeded` for cap busts, :class:`MediaRejected`
    otherwise (both permanent, both input-classified; the manifest gets
    the probe's precise reason and zero retries are burned)."""
    report = preflight(path, need=need, caps=caps, first_frame=first_frame)
    if report.verdict == "reject":
        raise report.to_error()
    return report
