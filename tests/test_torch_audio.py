"""The port's audio frontend against the JAX package's.

Both are host numpy with the same arithmetic, so wav reads, the
kaiser_best resampler and the log-mel examples are held to exact or
near-exact equality (tolerance beside each case).
"""

import sys
import threading

import numpy as np
import pytest
from scipy.io import wavfile

from video_features_tpu.io import audio as jax_audio
from video_features_tpu.models.vggish import mel as jax_mel
from video_features_tpu.runtime import faults as jax_faults
from video_features_tpu_torch.io import audio as port_audio
from video_features_tpu_torch.models.vggish import mel as port_mel
from video_features_tpu_torch.runtime import faults as port_faults
from video_features_tpu_torch.utils.synth import synth_wav


def _signal(n, channels, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (n, channels)).squeeze()


@pytest.mark.parametrize("dtype,channels", [
    (np.int16, 1), (np.int32, 1), (np.uint8, 1), (np.int16, 2),
], ids=["int16", "int32", "uint8", "stereo"])
def test_read_wav_matches_jax(tmp_path, dtype, channels):
    x = _signal(800, channels, seed=1)
    if dtype == np.uint8:
        data = (x * 127 + 128).astype(np.uint8)
    else:
        data = (x * np.iinfo(dtype).max).astype(dtype)
    path = str(tmp_path / "x.wav")
    wavfile.write(path, 22050, data)
    ours, sr = port_audio.read_wav(path)
    ref, ref_sr = jax_audio.read_wav(path)
    assert sr == ref_sr == 22050 and ours.dtype == ref.dtype == np.float32
    assert ours.shape == data.shape and np.array_equal(ours, ref)  # exact
    assert np.abs(ours).max() <= 1.0
    assert np.array_equal(port_audio.to_mono(ours), jax_audio.to_mono(ref))


def test_read_wav_bad_bytes_is_permanent(tmp_path):
    path = tmp_path / "bad.wav"
    path.write_bytes(b"RIFF not really a wav")
    with pytest.raises(port_faults.AudioDecodeError, match="unparseable wav") as info:
        port_audio.read_wav(str(path))
    with pytest.raises(jax_faults.AudioDecodeError):
        jax_audio.read_wav(str(path))
    assert port_faults.classify_error(info.value) == "permanent"


@pytest.mark.parametrize("src_sr", [44100, 48000, 22050, 16000])
def test_resample_matches_jax(src_sr):
    x = _signal(src_sr // 4, 2, seed=2).astype(np.float32)  # 0.25 s stereo
    ours = port_audio.resample(x, src_sr, 16000)
    ref = jax_audio.resample(x, src_sr, 16000)
    assert ours.shape == ref.shape == ((x.shape[0] * 16000) // src_sr, 2)
    assert np.array_equal(ours, ref)  # exact: the same float64 arithmetic
    if src_sr == 16000:
        assert ours is x  # unchanged


def test_resample_cache_is_thread_safe(monkeypatch):
    """Eight threads resample at once with an empty phase cache: every
    result equals the single-thread one and the cache holds one entry."""
    monkeypatch.setattr(port_audio, "_PHASE_CACHE", {})
    x = _signal(4410, 1, seed=3).astype(np.float32)
    want = jax_audio.resample(x, 44100, 16000)
    out, errors = [None] * 8, []

    def run(i):
        try:
            out[i] = port_audio.resample(x, 44100, 16000)
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert all(np.array_equal(o, want) for o in out)
    assert list(port_audio._PHASE_CACHE) == [(44100, 16000)]


def test_waveform_to_examples_matches_jax(tmp_path):
    path = synth_wav(str(tmp_path / "chirp.wav"), seconds=2.0, sample_rate=44100, seed=6)
    data, sr = port_audio.read_wav(path)
    ours = port_mel.waveform_to_examples(data, sr)
    ref = jax_mel.waveform_to_examples(jax_audio.read_wav(path)[0], sr)
    assert ours.shape == ref.shape == (2, 96, 64) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_load_audio_for_model_matches_jax(tmp_path):
    path = synth_wav(str(tmp_path / "mono.wav"), seconds=1.0, sample_rate=48000,
                     channels=1, seed=7)
    ours = port_audio.load_audio_for_model(path, 16000, str(tmp_path / "tmp"))
    ref = jax_audio.load_audio_for_model(path, 16000, str(tmp_path / "tmp"))
    assert ours.shape == (16000,) and np.array_equal(ours, ref)


def test_synth_wav_is_seeded(tmp_path):
    a = synth_wav(str(tmp_path / "a.wav"), seconds=0.5, seed=1)
    b = synth_wav(str(tmp_path / "b.wav"), seconds=0.5, seed=1)
    c = synth_wav(str(tmp_path / "c.wav"), seconds=0.5, seed=2)
    (sr, da), (_, db), (_, dc) = (wavfile.read(p) for p in (a, b, c))
    assert sr == 44100 and da.dtype == np.int16 and da.shape == (22050, 2)
    assert np.array_equal(da, db) and not np.array_equal(da, dc)
