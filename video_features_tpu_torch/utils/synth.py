"""Synthetic media for tests and ``chip_smoke.py``.

``synth_video``: a moving gradient plus a seeded random box, written with
cv2 (the generator of ``video_features_tpu/utils/synth.py``, so one seed
gives both packages the same file). ``synth_wav``: a seeded chirp plus
noise, written as an int16 wav with scipy.
"""

from __future__ import annotations

import numpy as np


def synth_video(
    path: str,
    n_frames: int = 60,
    width: int = 320,
    height: int = 240,
    fps: float = 25.0,
    seed: int = 0,
) -> str:
    import cv2

    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height))
    if not writer.isOpened():
        raise RuntimeError(f"cv2.VideoWriter could not open an mp4 writer for {path}")
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    try:
        for t in range(n_frames):
            frame = np.stack(
                [(xx + 2 * t) % 256, (yy + t) % 256, np.full((height, width), (t * 4) % 256)],
                axis=-1,
            ).astype(np.uint8)
            x0 = (10 + 3 * t) % (width - 40)
            y0 = (20 + 2 * t) % (height - 40)
            frame[y0 : y0 + 30, x0 : x0 + 30] = rng.randint(0, 255, 3)
            writer.write(frame)
    finally:
        writer.release()
    return path


def synth_wav(
    path: str,
    seconds: float = 3.0,
    sample_rate: int = 44100,
    channels: int = 2,
    seed: int = 0,
) -> str:
    """An int16 wav: a 200 Hz -> 4 kHz linear chirp (each channel's phase
    offset by the seed's draw) at amplitude 0.5, plus Gaussian noise at
    0.05, clipped to [-1, 1]."""
    from scipy.io import wavfile

    rng = np.random.RandomState(seed)
    n = int(round(seconds * sample_rate))
    t = np.arange(n) / sample_rate
    f0, f1 = 200.0, 4000.0
    phase = 2 * np.pi * (f0 * t + 0.5 * (f1 - f0) / max(seconds, 1e-9) * t * t)
    offsets = rng.uniform(0, 2 * np.pi, channels)
    x = 0.5 * np.sin(phase[:, None] + offsets[None, :])
    x = x + 0.05 * rng.standard_normal((n, channels))
    data = (np.clip(x, -1.0, 1.0) * 32767).astype(np.int16)
    wavfile.write(path, sample_rate, data[:, 0] if channels == 1 else data)
    return path
