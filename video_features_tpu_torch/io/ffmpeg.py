"""The ffmpeg boundary: the audio rip of a video container, and the
reference's fps re-encode (``--fps_retarget reencode``).

Counterpart of ``video_features_tpu/io/ffmpeg.py`` (``which_ffmpeg``,
``require_ffmpeg``, ``reencode_video_with_diff_fps``, ``_run``,
``extract_wav_from_video``). The binary may be absent: ``.wav`` inputs and
the default ``--fps_retarget nearest`` never need it, and the rest fails
with a clear message instead of mid-pipeline.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
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


def reencode_video_with_diff_fps(
    video_path: str,
    tmp_path: str,
    extraction_fps: float,
    timeout_s: Optional[float] = None,
) -> str:
    """Re-encode ``video_path`` at ``extraction_fps`` into ``tmp_path``
    (the reference's ffmpeg ``fps`` filter); returns the new file's path.

    The output name carries a hash of the absolute source path: the
    reference's bare ``{stem}_new_fps.mp4`` collides when two inputs share
    a stem (``a/clip.mp4`` and ``b/clip.mp4``), and two decode workers
    would race ffmpeg's ``-y`` overwrite against each other's decode. The
    file is written under a name of this process and thread, then renamed
    atomically, so a concurrent reader of the same source never sees a
    truncated file. ``timeout_s`` (``--decode_timeout``) bounds ffmpeg."""
    ffmpeg = require_ffmpeg()
    os.makedirs(tmp_path, exist_ok=True)
    tag = hashlib.sha1(os.path.abspath(video_path).encode()).hexdigest()[:10]
    stem = pathlib.Path(video_path).stem
    new_path = os.path.join(tmp_path, f"{stem}_{tag}_new_fps_{extraction_fps:g}.mp4")
    part = new_path + f".part{os.getpid()}-{threading.get_ident()}.mp4"
    _run([ffmpeg, "-hide_banner", "-loglevel", "error", "-y", "-i", video_path,
          "-filter:v", f"fps=fps={extraction_fps}", part], timeout_s=timeout_s)
    os.replace(part, new_path)
    return new_path


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
