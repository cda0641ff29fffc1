"""The ffmpeg boundary, for the audio rip of a video container.

Counterpart of ``video_features_tpu/io/ffmpeg.py`` (``which_ffmpeg``,
``require_ffmpeg``, ``_run``, ``extract_wav_from_video``). The binary may
be absent: ``.wav`` inputs never need it, and a container without it
fails with a clear message instead of mid-pipeline.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Optional, Tuple

from video_features_tpu_torch.runtime.faults import DecodeTimeout


def which_ffmpeg() -> str:
    """Path to ffmpeg, or '' when it is not installed."""
    return shutil.which("ffmpeg") or ""


def require_ffmpeg() -> str:
    path = which_ffmpeg()
    if not path:
        raise RuntimeError(
            "ffmpeg binary not found. Audio extraction from video containers "
            "requires ffmpeg; pass a .wav file directly instead, or install ffmpeg."
        )
    return path


def _run(cmd, timeout_s: Optional[float] = None) -> None:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired as e:
        # subprocess.run has killed the child already
        raise DecodeTimeout(
            f"ffmpeg exceeded --decode_timeout {timeout_s:g}s: {' '.join(cmd)}"
        ) from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"ffmpeg failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stderr.strip()}"
        )


def extract_wav_from_video(video_path: str, tmp_path: str) -> Tuple[str, str]:
    """Container -> .aac -> .wav, the reference's two-stage rip, into
    ``tmp_path``. Returns (wav path, aac path).

    The names carry a hash of the absolute source path, as the JAX
    package's ``reencode_video_with_diff_fps`` names its output: the bare
    ``<stem>.aac|.wav`` of the reference collides when two inputs share a
    stem (``a/x.mp4`` and ``b/x.mp4``), and two decode workers would then
    overwrite (``-y``) or delete each other's rip."""
    ffmpeg = require_ffmpeg()
    os.makedirs(tmp_path, exist_ok=True)
    tag = hashlib.sha1(os.path.abspath(video_path).encode()).hexdigest()[:10]
    stem = pathlib.Path(video_path).stem
    aac_path = os.path.join(tmp_path, f"{stem}_{tag}.aac")
    wav_path = os.path.join(tmp_path, f"{stem}_{tag}.wav")
    _run([ffmpeg, "-hide_banner", "-loglevel", "error", "-y",
          "-i", video_path, "-acodec", "copy", aac_path])
    _run([ffmpeg, "-hide_banner", "-loglevel", "error", "-y",
          "-i", aac_path, wav_path])
    return wav_path, aac_path
