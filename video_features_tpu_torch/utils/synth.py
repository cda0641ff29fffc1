"""Synthetic clips for tests and ``chip_smoke.py``: a moving gradient
plus a seeded random box, written with cv2 (the generator of
``video_features_tpu/utils/synth.py``, so one seed gives both packages
the same file)."""

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
