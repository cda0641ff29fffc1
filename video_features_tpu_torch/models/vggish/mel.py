"""VGGish log-mel frontend (numpy, on the host).

Counterpart of ``video_features_tpu/models/vggish/mel.py``: the AudioSet
feature pipeline. 25 ms periodic-Hann windows hopped 10 ms, 512-point
rFFT magnitudes, an HTK-formula 64-band mel filterbank over 125-7500 Hz
with a zeroed DC bin, log with a +0.01 offset, framed into
non-overlapping 0.96 s examples of shape (96, 64). Resampling to 16 kHz
is ``io/audio.py``'s kaiser_best copy.
"""

from __future__ import annotations

import numpy as np

from video_features_tpu_torch.io.audio import resample, to_mono

SAMPLE_RATE = 16000
STFT_WINDOW_SECONDS = 0.025
STFT_HOP_SECONDS = 0.010
NUM_MEL_BINS = 64
MEL_MIN_HZ = 125.0
MEL_MAX_HZ = 7500.0
LOG_OFFSET = 0.01
EXAMPLE_WINDOW_SECONDS = 0.96
EXAMPLE_HOP_SECONDS = 0.96

_MEL_BREAK_HZ = 700.0
_MEL_HIGH_Q = 1127.0


def frame(data: np.ndarray, window_length: int, hop_length: int) -> np.ndarray:
    """(num_samples, ...) -> (num_frames, window_length, ...); ragged tail
    dropped, no padding."""
    n = 1 + int(np.floor((data.shape[0] - window_length) / hop_length))
    if n < 1:
        return np.zeros((0, window_length) + data.shape[1:], data.dtype)
    idx = np.arange(window_length)[None, :] + hop_length * np.arange(n)[:, None]
    return data[idx]


def periodic_hann(window_length: int) -> np.ndarray:
    """Full-cycle raised cosine (matlab 'periodic'), not np.hanning's
    symmetric window."""
    return 0.5 - 0.5 * np.cos(2 * np.pi / window_length * np.arange(window_length))


def stft_magnitude(
    signal: np.ndarray, fft_length: int, hop_length: int, window_length: int
) -> np.ndarray:
    frames = frame(signal, window_length, hop_length)
    return np.abs(np.fft.rfft(frames * periodic_hann(window_length), int(fft_length)))


def hertz_to_mel(frequencies_hertz):
    """HTK mel scale."""
    return _MEL_HIGH_Q * np.log(1.0 + np.asarray(frequencies_hertz) / _MEL_BREAK_HZ)


def spectrogram_to_mel_matrix(
    num_mel_bins: int = NUM_MEL_BINS,
    num_spectrogram_bins: int = 257,
    audio_sample_rate: int = SAMPLE_RATE,
    lower_edge_hertz: float = MEL_MIN_HZ,
    upper_edge_hertz: float = MEL_MAX_HZ,
) -> np.ndarray:
    """(num_spectrogram_bins, num_mel_bins) triangular filterbank, linear
    in mel; DC bin zeroed."""
    nyquist = audio_sample_rate / 2.0
    if not 0.0 <= lower_edge_hertz < upper_edge_hertz <= nyquist:
        raise ValueError(
            f"bad mel range [{lower_edge_hertz}, {upper_edge_hertz}] for nyquist {nyquist}"
        )
    bins_mel = hertz_to_mel(np.linspace(0.0, nyquist, num_spectrogram_bins))
    edges_mel = np.linspace(
        hertz_to_mel(lower_edge_hertz), hertz_to_mel(upper_edge_hertz), num_mel_bins + 2
    )
    lower = edges_mel[:-2][None, :]
    center = edges_mel[1:-1][None, :]
    upper = edges_mel[2:][None, :]
    lower_slope = (bins_mel[:, None] - lower) / (center - lower)
    upper_slope = (upper - bins_mel[:, None]) / (upper - center)
    weights = np.maximum(0.0, np.minimum(lower_slope, upper_slope))
    weights[0, :] = 0.0
    return weights


def log_mel_spectrogram(data: np.ndarray, audio_sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """waveform -> (num_frames, 64) log mel magnitudes."""
    window_length = int(round(audio_sample_rate * STFT_WINDOW_SECONDS))
    hop_length = int(round(audio_sample_rate * STFT_HOP_SECONDS))
    fft_length = 2 ** int(np.ceil(np.log2(window_length)))
    spec = stft_magnitude(data, fft_length, hop_length, window_length)
    mel = spec @ spectrogram_to_mel_matrix(
        num_spectrogram_bins=spec.shape[1], audio_sample_rate=audio_sample_rate
    )
    return np.log(mel + LOG_OFFSET)


def waveform_to_examples(data: np.ndarray, sample_rate: int) -> np.ndarray:
    """mono/multichannel waveform -> (num_examples, 96, 64) float32."""
    data = to_mono(np.asarray(data))
    data = resample(data, sample_rate, SAMPLE_RATE)
    log_mel = log_mel_spectrogram(data, SAMPLE_RATE)
    features_rate = 1.0 / STFT_HOP_SECONDS
    window = int(round(EXAMPLE_WINDOW_SECONDS * features_rate))
    hop = int(round(EXAMPLE_HOP_SECONDS * features_rate))
    return frame(log_mel, window, hop).astype(np.float32)
