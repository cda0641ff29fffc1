"""The one traffic generator: reads a mix's parameters
(``traffic/<name>.json``) and makes, from the run's seed, the clips and the
ordered list of video names a run drives.

The clips are the moving-gradient scenes of the program's test generator
(``synth_video``: three ramps that move with the frame index and a 30-px
box whose colour is drawn every frame), with a phase and a speed drawn per
clip, so each clip is distinct content. They are written with cv2 in the
mix's codec, size, frame rate and length. The names are hard links to the
clips, in a seeded order that cycles through all of them, so every video of
a run is opened and decoded anew while every seed gives the same sizes.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np


# the independent streams a run draws from its seed
CLIPS, ORDER, WEIGHTS, SAMPLE = range(4)


def sub_seeds(seed: int, n: int, stream: int) -> List[int]:
    """``n`` 32-bit seeds of ``stream``, drawn from any whole ``seed`` (it
    may exceed 32 bits)."""
    seq = np.random.SeedSequence(entropy=int(seed), spawn_key=(stream,))
    return [int(x) for x in seq.generate_state(n)]


def synth_clip(path: str, frames: int, width: int, height: int, fps: float, codec: str,
               seed: int) -> str:
    import cv2

    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*codec), fps, (width, height))
    if not writer.isOpened():
        raise RuntimeError(f"cv2.VideoWriter could not open {path} with codec {codec}")
    rng = np.random.RandomState(seed)
    phase, speed = int(rng.randint(0, 256)), int(rng.randint(1, 4))
    yy, xx = np.mgrid[0:height, 0:width]
    try:
        for i in range(frames):
            t = phase + speed * i
            frame = np.stack(
                [(xx + 2 * t) % 256, (yy + t) % 256, np.full((height, width), (t * 4) % 256)],
                axis=-1,
            ).astype(np.uint8)
            x0 = (10 + 3 * t) % (width - 40)
            y0 = (20 + 2 * t) % (height - 40)
            frame[y0:y0 + 30, x0:x0 + 30] = rng.randint(0, 255, 3)
            writer.write(frame)
    finally:
        writer.release()
    return path


def make_clips(mix: dict, seed: int, out_dir: str) -> List[str]:
    os.makedirs(out_dir, exist_ok=True)
    seeds = sub_seeds(seed, mix["clips"], CLIPS)
    return [synth_clip(os.path.join(out_dir, f"clip{i:02d}.mp4"), mix["frames"], mix["width"],
                       mix["height"], mix["fps"], mix["codec"], s)
            for i, s in enumerate(seeds)]


def link_videos(clips: List[str], count: int, seed: int, out_dir: str) -> List[str]:
    """``count`` hard links named ``v<index>.mp4``: each pass over the
    clips in a seeded order, every clip once a pass."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(sub_seeds(seed, 1, ORDER)[0])
    order: List[int] = []
    while len(order) < count:
        order += list(rng.permutation(len(clips)))
    names = []
    for i, c in enumerate(order[:count]):
        name = os.path.join(out_dir, f"v{i:04d}.mp4")
        os.link(clips[c], name)
        names.append(name)
    return names
