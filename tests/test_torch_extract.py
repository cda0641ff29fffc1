"""The port's CLIP extraction path against the JAX package's.

Decode and the PIL chain must be byte-identical (the JAX package on its
cv2 decoder). The slice as a whole: both packages extract one clip with
one seeded checkpoint and a small tower (2 layers, 64 wide; 224 px and
patch 32 as at full width), and their .npy files agree within 1e-4.
"""

import dataclasses
import os
import pathlib

import numpy as np
import pytest
from PIL import Image

from video_features_tpu.config import ExtractionConfig as JaxConfig
from video_features_tpu.io.video import extract_frames as jax_extract_frames
from video_features_tpu.models.clip import model as jax_model
from video_features_tpu.models.clip.extract_clip import ExtractCLIP as JaxExtractCLIP
from video_features_tpu.ops import preprocess as jax_pre
from video_features_tpu.ops import window as jax_window
from video_features_tpu_torch import cli
from video_features_tpu_torch.config import ExtractionConfig, sanity_check
from video_features_tpu_torch.io.sink import expected_output_files
from video_features_tpu_torch.io.video import CorruptVideoError, extract_frames
from video_features_tpu_torch.models.clip import model as port_model
from video_features_tpu_torch.models.clip.extract_clip import ExtractCLIP
from video_features_tpu_torch.ops import preprocess as port_pre
from video_features_tpu_torch.ops.window import bucket_size, pad_batch

from test_torch_clip import SMALL, openai_state_dict

FT = "CLIP-ViT-B/32"
ATOL = 1e-4


@pytest.fixture
def small_tower(monkeypatch):
    """Both packages' CLIP-ViT-B/32 become the small tower."""
    monkeypatch.setitem(port_model.CONFIGS, FT, port_model.CLIPVisionConfig(**SMALL))
    monkeypatch.setitem(jax_model.CONFIGS, FT, jax_model.CLIPVisionConfig(**SMALL))


@pytest.fixture
def weights(tmp_path):
    path = str(tmp_path / "clip_small.npz")
    np.savez(path, **openai_state_dict())
    return path


def _npys(root):
    return {p.name: np.load(p) for p in pathlib.Path(root).rglob("*.npy")}


@pytest.mark.parametrize("method", ["uni_12", "uni_3", "fix_2"])
def test_decode_and_sampling_byte_identical(sample_video, method):
    frames, fps, stamps = extract_frames(sample_video, method)
    ref_frames, ref_fps, ref_stamps = jax_extract_frames(sample_video, method, "cv2")
    assert fps == ref_fps and stamps == ref_stamps
    assert len(frames) == len(ref_frames)
    assert all(np.array_equal(a, b) for a, b in zip(frames, ref_frames))


def test_pil_chain_byte_identical(sample_video):
    frames, _, _ = extract_frames(sample_video, "uni_3")
    for frame in frames:
        ours = port_pre.pil_center_crop(port_pre.pil_resize(frame, 224, interpolation=Image.BICUBIC), 224)
        ref = jax_pre.pil_center_crop(jax_pre.pil_resize(frame, 224, interpolation=Image.BICUBIC), 224)
        assert np.array_equal(ours, ref)
        x = port_pre.normalize_chw(port_pre.to_float_chw(ours), port_pre.CLIP_MEAN, port_pre.CLIP_STD)
        y = jax_pre.normalize_chw(jax_pre.to_float_chw(ref), jax_pre.CLIP_MEAN, jax_pre.CLIP_STD)
        assert x.dtype == y.dtype == np.float32 and np.array_equal(x, y)


@pytest.mark.parametrize("n,buckets", [(12, None), (3, None), (17, None), (12, [10, 20])])
def test_padding_buckets_match_jax(n, buckets):
    assert bucket_size(n, buckets=buckets) == jax_window.bucket_size(n, buckets=buckets)
    x = np.ones((n, 2), np.float32)
    to = bucket_size(n, buckets=buckets)
    assert np.array_equal(pad_batch(x, to), jax_window.pad_batch(x, to))
    assert bucket_size(12) == 16  # uni_12 runs a 16-frame batch


@pytest.mark.parametrize("attn", ["fused", "flash"])
def test_slice_parity_with_jax(sample_video, tmp_path, small_tower, weights, attn):
    """The port's CLI and the JAX extractor write the same features."""
    cli.main([
        "--feature_type", FT, "--cpu", "--video_paths", sample_video,
        "--extract_method", "uni_12", "--attn", attn, "--weights_path", weights,
        "--on_extraction", "save_numpy", "--output_path", str(tmp_path / "port"),
        "--tmp_path", str(tmp_path / "tmp"),
    ])
    JaxExtractCLIP(JaxConfig(
        feature_type=FT, video_paths=[sample_video], extract_method="uni_12",
        attn=attn, weights_path=weights, on_extraction="save_numpy", cpu=True,
        decoder="cv2", output_path=str(tmp_path / "jax"), tmp_path=str(tmp_path / "tmp"),
    ))([0])
    ours, ref = _npys(tmp_path / "port"), _npys(tmp_path / "jax")
    assert sorted(ours) == sorted(ref) == ["synth_CLIP-ViT-B-32.npy"]
    name = "synth_CLIP-ViT-B-32.npy"
    assert ours[name].shape == (12, SMALL["embed_dim"])
    np.testing.assert_allclose(ours[name], ref[name], atol=ATOL)


def test_full_width_cli_on_cpu(sample_video, tmp_path):
    cli.main([
        "--feature_type", FT, "--cpu", "--allow_random_init", "--video_paths", sample_video,
        "--extract_method", "uni_3", "--on_extraction", "save_numpy",
        "--output_path", str(tmp_path / "out"), "--tmp_path", str(tmp_path / "tmp"),
    ])
    (feats,) = _npys(tmp_path / "out").values()
    assert feats.shape == (3, 512) and np.isfinite(feats).all()


def test_external_call_isolation_and_resume(sample_video, tmp_path, small_tower, capsys):
    bad = tmp_path / "broken.mp4"
    bad.write_bytes(b"not a video")
    cfg = ExtractionConfig(
        feature_type=FT, video_paths=[str(bad), sample_video], extract_method="uni_3",
        allow_random_init=True, cpu=True, on_extraction="save_numpy",
        output_path=str(tmp_path / "out"), tmp_path=str(tmp_path / "tmp"),
    )
    (res,) = ExtractCLIP(cfg, external_call=True)()  # the broken clip is skipped
    assert res[FT].shape == (3, SMALL["embed_dim"])
    assert float(res["fps"]) == 25.0 and len(res["timestamps_ms"]) == 3
    assert "An error occurred extracting" in capsys.readouterr().out

    ExtractCLIP(cfg)()
    (done,) = expected_output_files([FT], sample_video, str(tmp_path / "out" / FT), "save_numpy")
    mtime = os.stat(done).st_mtime_ns
    ExtractCLIP(dataclasses.replace(cfg, resume=True))()
    assert os.stat(done).st_mtime_ns == mtime
    assert "outputs exist (--resume)" in capsys.readouterr().out


def test_short_video_is_corrupt(tmp_path):
    from video_features_tpu_torch.utils.synth import synth_video

    path = synth_video(str(tmp_path / "two.mp4"), n_frames=2)
    with pytest.raises(CorruptVideoError, match="too short"):
        extract_frames(path, "uni_3")


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(feature_type="s3d"), "feature_type"),
        (dict(extract_method="uni_x"), "extract_method"),
        (dict(attn="ring"), "attn"),
        (dict(tmp_path="./output"), "same path"),
        (dict(shape_buckets=[0]), "shape_buckets"),
    ],
)
def test_sanity_check_rejects(kw, match):
    with pytest.raises((ValueError, AssertionError), match=match):
        sanity_check(ExtractionConfig(**kw))
