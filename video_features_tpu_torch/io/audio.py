"""Audio input on the host: wav reading, mono mix and resampling.

Counterpart of ``video_features_tpu/io/audio.py``, host numpy as there.
A wav is read with scipy.io.wavfile (int16 / 2^15, int32 / 2^31, uint8
centred on 128), mixed to mono, and resampled to 16 kHz by a native copy
of resampy's ``kaiser_best`` windowed sinc (resampy 0.2.x's filter
parameters), vectorised as one strided matmul per polyphase phase. A
video container is ripped to wav through ffmpeg (``io/ffmpeg.py``); a
``.wav`` is read directly.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Dict, Tuple

import numpy as np
from scipy.io import wavfile

from video_features_tpu_torch.runtime.faults import AudioDecodeError, MissingStreamError

# resampy.filters.sinc_window('kaiser_best') parameters: 64 zero
# crossings sampled at 2**9 points each, Kaiser beta tuned for ~-96 dB
# stopband, cutoff rolled off to 0.9476 of Nyquist
_NUM_ZEROS = 64
_PRECISION = 9
_ROLLOFF = 0.9475937167399596
_BETA = 14.769656459379492

# ffmpeg stderr fragments that mean "this container has no audio track"
# — the one rip failure that deserves its own precise reason instead of
# the generic corrupt-audio classification
_NO_AUDIO_MARKERS = (
    "does not contain any stream",
    "Stream map 'a' matches no streams",
    "matches no streams",
)


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """-> (float32 samples in [-1, 1], shape (n,) or (n, ch); sample rate).

    Parse failures raise :class:`AudioDecodeError` (permanent,
    input-classified) rather than letting scipy's bare ValueError escape
    into the retry machinery as a maybe-transient unknown."""
    try:
        sr, data = wavfile.read(path)
    except (ValueError, EOFError) as exc:
        # scipy raises bare ValueError for bad bytes; OSErrors (missing
        # file, I/O flake) pass through and stay transient-classifiable
        raise AudioDecodeError(
            f"unparseable wav ({type(exc).__name__}: {exc}): {path}"
        ) from exc
    if data.dtype == np.int16:
        data = data / 32768.0
    elif data.dtype == np.int32:
        data = data / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    data = np.asarray(data, dtype=np.float32)
    return data, int(sr)


def to_mono(data: np.ndarray) -> np.ndarray:
    return data.mean(axis=1) if data.ndim > 1 else data


def _sinc_window() -> np.ndarray:
    """Right half of the kaiser_best sinc table (resampy.filters)."""
    num_bits = 2 ** _PRECISION
    n = num_bits * _NUM_ZEROS
    taps = np.arange(n + 1) / num_bits  # 0 .. num_zeros inclusive
    sinc = _ROLLOFF * np.sinc(_ROLLOFF * taps)
    window = np.kaiser(2 * n + 1, _BETA)[n:]
    return sinc * window


# (src_sr, dst_sr) -> (per-phase weight matrix, left extents, L, M).
# VGGish's prepare runs on --decode_workers threads, so the cache insert
# is lock-guarded; a racing miss at worst recomputes the same taps.
_PHASE_CACHE: Dict[Tuple[int, int], tuple] = {}
_PHASE_LOCK = threading.Lock()


def _phase_filters(src_sr: int, dst_sr: int):
    """Precompute kaiser_best tap weights per output phase.

    With rational ratio L/M (L = dst/g, M = src/g) the fractional
    position of output sample t against the input grid repeats every L
    outputs, so the interpolated-table weights resampy computes per
    sample (resampy.interpn) collapse to L fixed FIR vectors — the
    windowed-sinc equivalent of a polyphase bank. Output t (phase
    p = t mod L, block j = t // L) reads the contiguous input window
    ``x[n - left_p : n - left_p + width_p]`` with ``n = (p*M)//L + j*M``;
    each phase's outputs are then one strided-gather matmul.
    """
    key = (int(src_sr), int(dst_sr))
    if key in _PHASE_CACHE:
        return _PHASE_CACHE[key]
    g = math.gcd(*key)
    L, M = key[1] // g, key[0] // g
    ratio = L / M
    win = _sinc_window()
    if ratio < 1:
        win = win * ratio
    delta = np.diff(win, append=0.0)
    num_bits = 2 ** _PRECISION
    scale = min(1.0, ratio)
    index_step = int(scale * num_bits)

    weights = []  # per phase: (left_taps_reversed ++ right_taps)
    lefts = []
    for p in range(L):
        time = p * M / L
        n = (p * M) // L
        # left wing: taps for x[n], x[n-1], ...
        frac = scale * (time - n)
        index_frac = frac * num_bits
        offset = int(index_frac)
        eta = index_frac - offset
        i_max = (len(win) - offset) // index_step
        idx = offset + index_step * np.arange(i_max)
        w_left = win[idx] + eta * delta[idx]
        # right wing: taps for x[n+1], x[n+2], ...
        frac = scale - frac
        index_frac = frac * num_bits
        offset = int(index_frac)
        eta = index_frac - offset
        k_max = (len(win) - offset) // index_step
        idx = offset + index_step * np.arange(k_max)
        w_right = win[idx] + eta * delta[idx]
        weights.append(np.concatenate([w_left[::-1], w_right]))
        lefts.append(i_max - 1)  # window starts at x[n - (i_max-1)]

    width = max(len(w) for w in weights)
    wmat = np.zeros((L, width))
    for p, w in enumerate(weights):
        wmat[p, : len(w)] = w
    out = (wmat, np.asarray(lefts), L, M)
    with _PHASE_LOCK:
        _PHASE_CACHE[key] = out
    return out


def resample(data: np.ndarray, src_sr: int, dst_sr: int) -> np.ndarray:
    """resampy-kaiser_best-exact resampling along axis 0 (1-D or (n, ch)).

    Boundary truncation matches resampy: taps that fall outside the
    signal contribute zero (the zero-padded gather reproduces interpn's
    wing clipping exactly).
    """
    if src_sr == dst_sr:
        return data
    x = np.asarray(data, dtype=np.float64)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    wmat, lefts, L, M = _phase_filters(src_sr, dst_sr)
    n_in = x.shape[0]
    # resampy 0.2.x sizes the output as int(n * sample_ratio) — i.e.
    # FLOOR, not ceil (resampy.core.resample); one extra trailing sample
    # would shift VGGish's 0.96 s frame count on boundary-length clips.
    # Integer arithmetic = the exact floor, immune to float rounding.
    n_out = (n_in * int(dst_sr)) // int(src_sr)
    width = wmat.shape[1]
    pad_lo = int(lefts.max())
    xp = np.pad(x, ((pad_lo, width + M), (0, 0)))

    out = np.empty((n_out, x.shape[1]), dtype=np.float64)
    # one matmul per phase: rows are the strided windows of x this
    # phase's outputs read; all windows share the phase's FIR vector.
    # Window starts advance by exactly M per output within a phase, so
    # windows[base::M] is a strided VIEW (no per-row gather copy) and
    # the einsum runs straight off it.
    windows = np.lib.stride_tricks.sliding_window_view(xp, width, axis=0)
    for p in range(L):
        count = len(range(p, n_out, L))
        if not count:
            continue
        base = (p * M) // L - lefts[p] + pad_lo
        # sliding_window_view appends the window axis last: (t, ch, w)
        out[p::L] = np.einsum(
            "tsw,w->ts", windows[base::M][:count], wmat[p]
        )
    out = out.astype(np.float32)
    return out[:, 0] if squeeze else out


def load_audio_for_model(
    path: str,
    target_sr: int,
    tmp_path: str = "./tmp",
    keep_tmp_files: bool = False,
) -> np.ndarray:
    """Full audio front door: wav/video path -> mono float32 at target_sr.

    Video containers are ripped to wav via ffmpeg into ``tmp_path``; the
    temp wav/aac are deleted afterwards unless ``keep_tmp_files``.
    """
    tmp_files = []
    if not path.lower().endswith(".wav"):
        from video_features_tpu_torch.io.ffmpeg import extract_wav_from_video

        src = path
        try:
            path, aac = extract_wav_from_video(path, tmp_path)
        except RuntimeError as exc:
            msg = str(exc)
            if "ffmpeg binary" in msg or "binary not found" in msg:
                raise  # missing tool is an environment problem, not bad media
            # the rip subprocess died on the bitstream: classify it
            if any(m in msg for m in _NO_AUDIO_MARKERS):
                raise MissingStreamError(
                    f"no audio stream in container: {src}"
                ) from exc
            raise AudioDecodeError(
                f"audio rip failed on the bitstream: {src}: {msg[:300]}"
            ) from exc
        tmp_files = [path, aac]
    try:
        data, sr = read_wav(path)
    finally:
        if not keep_tmp_files:
            for f in tmp_files:
                try:
                    os.remove(f)
                except OSError:
                    pass
    return resample(to_mono(data), sr, target_sr)
