"""Optical-flow -> RGB visualization (Middlebury color wheel).

Counterpart of ``video_features_tpu/utils/flow_viz.py``, copied as it is:
the debug rail the flow extractors expose through ``--show_pred`` (the
reference's RAFT/PWC ``flow_viz``). Pure NumPy; colors follow the
standard Baker et al. wheel (55 hue bins: RY/YG/GC/CB/BM/MR arcs). The
display (``cv2.imshow``/``waitKey``) stays inside
:func:`show_flow_on_frame`, the one function a test replaces.
"""

from __future__ import annotations

import numpy as np


def _make_colorwheel() -> np.ndarray:
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((RY + YG + GC + CB + BM + MR, 3))
    col = 0
    for n, (a, b, flip) in (
        (RY, (0, 1, False)),
        (YG, (1, 0, True)),
        (GC, (1, 2, False)),
        (CB, (2, 1, True)),
        (BM, (2, 0, False)),
        (MR, (0, 2, True)),
    ):
        ramp = np.floor(255 * np.arange(n) / n)
        wheel[col : col + n, a] = 255 - ramp if flip else 255
        wheel[col : col + n, b] = ramp if not flip else 255
        col += n
    return wheel


_COLORWHEEL = _make_colorwheel()


def flow_uv_to_colors(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Map normalized (|uv| <= 1) flow components to RGB uint8."""
    ncols = _COLORWHEEL.shape[0]
    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = (fk - k0)[..., None]
    col = (1 - f) * _COLORWHEEL[k0] / 255.0 + f * _COLORWHEEL[k1] / 255.0
    small = rad[..., None] <= 1
    col = np.where(small, 1 - rad[..., None] * (1 - col), col * 0.75)
    return np.floor(255 * col).astype(np.uint8)


def flow_to_image(flow_uv: np.ndarray, clip_flow: float = None) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) RGB uint8, magnitude-normalized."""
    assert flow_uv.ndim == 3 and flow_uv.shape[2] == 2, "expected (H, W, 2) flow"
    if clip_flow is not None:
        flow_uv = np.clip(flow_uv, 0, clip_flow)
    u, v = flow_uv[..., 0], flow_uv[..., 1]
    rad_max = np.max(np.sqrt(u ** 2 + v ** 2))
    eps = 1e-5
    return flow_uv_to_colors(u / (rad_max + eps), v / (rad_max + eps))


def show_flow_on_frame(flow: np.ndarray, frame: np.ndarray) -> None:
    """cv2.imshow the frame stacked over its flow rendering, waiting for a
    key. Off-display it prints the flow's range instead."""
    import cv2

    img_flow = np.concatenate([frame.astype(np.uint8), flow_to_image(flow)], axis=0)
    try:
        cv2.imshow("Press any key to see the next frame...", img_flow[:, :, ::-1] / 255.0)
        cv2.waitKey()
    except cv2.error as e:  # headless host: report instead of crashing the job
        print(f"(show_pred) display unavailable ({e}); flow stats: "
              f"min={flow.min():.3f} max={flow.max():.3f}")
