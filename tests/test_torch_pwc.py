"""The port's PWC-Net path against the JAX package's.

One set of weights reaches both packages: the port's seeded module gives
a sniklaus-layout state dict, which the JAX package's own converter
takes. Tolerances:

- ``resize_bilinear`` 1e-5 on values in [0, 1] (the same lerp, rounded
  in another order);
- ``backward_warp`` 1e-5 (the same bilinear taps, summed in another
  order; the > 0.999 mask agrees because its input does to ~1e-7);
- the full-width net at 64x96, T = 3: 1e-4 on flow of a few pixels (fp32
  on both sides; sums in other orders through 5 levels of convolutions,
  measured ~2e-6 on a CPU);
- ``ExtractPWC`` end to end: the same 1e-4 on the saved flow.
"""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_features_tpu.config import ExtractionConfig as JaxConfig
from video_features_tpu.io.video import stream_frames as jax_stream_frames
from video_features_tpu.models.pwc import convert as jax_convert
from video_features_tpu.models.pwc import model as jax_model
from video_features_tpu.models.pwc.extract_pwc import ExtractPWC as JaxExtractPWC
from video_features_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from video_features_tpu_torch import cli
from video_features_tpu_torch.io.video import stream_frames
from video_features_tpu_torch.models.pwc.convert import convert_state_dict, params_from_jax
from video_features_tpu_torch.models.pwc.model import (
    PWCNet,
    backward_warp,
    init_weights,
    internal_grid,
)
from video_features_tpu_torch.ops.resize import resize_bilinear

from torch_threads import one_torch_thread  # noqa: F401 - an autouse fixture

FLOW_ATOL = 1e-4


def _seeded_state_dict(seed=3):
    return {k: v.numpy() for k, v in init_weights(PWCNet(), seed=seed).state_dict().items()}


@pytest.mark.parametrize(
    "src,dst,align",
    [((16, 24), (64, 64), False), ((64, 96), (13, 17), False), ((5, 7), (5, 9), False),
     ((8, 8), (8, 8), False), ((6, 10), (12, 20), True)],
)
def test_resize_bilinear_matches_jax(src, dst, align):
    x = np.random.RandomState(0).rand(2, 3, *src).astype(np.float32)
    ours = resize_bilinear(torch.from_numpy(x), dst, align_corners=align).numpy()
    ref = np.asarray(jax_resize_bilinear(jnp.asarray(x), dst, align_corners=align))
    assert ours.shape == ref.shape == (2, 3, *dst)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


def test_backward_warp_matches_jax_off_the_image():
    rng = np.random.RandomState(1)
    feat = rng.randn(2, 5, 9, 13).astype(np.float32)
    # flows up to 12 px against a 13-px-wide map: many samples leave it
    flow = rng.uniform(-12, 12, (2, 2, 9, 13)).astype(np.float32)
    flow[0, :, :3] = 0.25  # sub-pixel shifts: partial bilinear support
    ours = backward_warp(torch.from_numpy(feat), torch.from_numpy(flow)).numpy()
    ref = np.asarray(jax_model.backward_warp(
        jnp.asarray(feat.transpose(0, 2, 3, 1)), jnp.asarray(flow.transpose(0, 2, 3, 1))
    )).transpose(0, 3, 1, 2)
    assert (ref == 0).all(axis=1).mean() > 0.2  # the mask did cut samples
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("fps", [None, 5.0, 40.0], ids=["all", "down", "up"])
def test_stream_frames_byte_identical(sample_video, fps):
    ours = list(stream_frames(sample_video, fps))
    ref = list(jax_stream_frames(sample_video, fps, "cv2"))
    assert len(ours) == len(ref) > 0
    assert [t for _, t in ours] == [t for _, t in ref]
    assert all(np.array_equal(a, b) for (a, _), (b, _) in zip(ours, ref))


def test_sniklaus_round_trip_is_exact():
    sd = _seeded_state_dict()
    back = params_from_jax(jax_convert.convert_state_dict(sd))
    assert sorted(back) == sorted(sd)
    for k, v in back.items():
        assert np.array_equal(v.numpy(), sd[k]), k
    # a DataParallel prefix is stripped; a stray tensor is refused
    native = convert_state_dict({f"module.{k}": v for k, v in sd.items()})
    assert all(np.array_equal(native[k].numpy(), sd[k]) for k in sd)
    with pytest.raises(ValueError, match="unconsumed"):
        convert_state_dict({**sd, "stray.weight": np.zeros(3, np.float32)})


def test_internal_grid():
    assert internal_grid(240, 320) == (256, 320)
    assert internal_grid(256, 341) == (256, 384)
    assert internal_grid(64, 96) == (64, 128)


def test_full_width_pwc_matches_jax():
    sd = _seeded_state_dict()
    frames = np.random.RandomState(2).uniform(0, 255, (3, 64, 96, 3)).astype(np.float32)
    model = PWCNet().eval()
    model.load_state_dict(convert_state_dict(sd))
    with torch.inference_mode():
        ours = model(torch.from_numpy(frames)).numpy()
        batched = model(torch.from_numpy(np.stack([frames, frames[::-1].copy()]))).numpy()
    ref = np.asarray(jax.jit(jax_model.build().apply)(
        {"params": jax_convert.convert_state_dict(sd)}, jnp.asarray(frames)))
    assert ours.shape == ref.shape == (2, 64, 96, 2)
    assert np.abs(ref).max() > 0.1  # the random net moves pixels
    np.testing.assert_allclose(ours, ref, atol=FLOW_ATOL, rtol=0)
    # a batch of sequences: each one's pairs stay inside it
    np.testing.assert_allclose(batched[0], ours, atol=1e-5, rtol=0)


def test_extract_pwc_matches_jax(sample_video, tmp_path):
    sd = _seeded_state_dict(seed=4)
    weights = tmp_path / "pwc_net_sintel.pt"
    torch.save({f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}, weights)
    common = ["--extraction_fps", "5", "--side_size", "64", "--batch_size", "4"]
    cli.main(["--feature_type", "pwc", "--cpu", "--video_paths", sample_video,
              "--weights_path", str(weights), "--on_extraction", "save_numpy",
              "--output_path", str(tmp_path / "port"), "--tmp_path", str(tmp_path / "tmp"),
              *common])
    jax_ex = JaxExtractPWC(JaxConfig(
        feature_type="pwc", video_paths=[sample_video], extraction_fps=5.0, side_size=64,
        batch_size=4, allow_random_init=True, cpu=True, decoder="cv2",
        on_extraction="save_numpy", output_path=str(tmp_path / "jax"),
        tmp_path=str(tmp_path / "tmp"),
    ))
    jax_ex._host_params = jax_convert.convert_state_dict(sd)
    jax_ex([0])
    (ours,) = pathlib.Path(tmp_path / "port").rglob("*.npy")
    (ref,) = pathlib.Path(tmp_path / "jax").rglob("*.npy")
    assert ours.name == ref.name == "synth_pwc.npy"
    ours, ref = np.load(ours), np.load(ref)
    # 60 frames at 25 fps -> 12 at 5 fps -> 11 pairs (windows of 4, 4, 3),
    # at the side_size-64 resolution of the 320x240 clip
    assert ours.shape == ref.shape == (11, 2, 64, 85)
    np.testing.assert_allclose(ours, ref, atol=FLOW_ATOL, rtol=0)
