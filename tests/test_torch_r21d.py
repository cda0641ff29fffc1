"""The port's R(2+1)D-18 path against the JAX package's.

One set of weights reaches both packages: the port's seeded module (with
BatchNorm statistics drawn away from identity) gives a torchvision
``r2plus1d_18``-layout state dict, which the JAX package's own converter
takes. Tolerances:

- ``kinetics_preprocess``: 1e-5 on normalised values of a few units (the
  same bilinear taps, summed in another order; measured 1.2e-6);
- the net at 1x3x8x32x32: 1e-4 on features and logits of unit scale
  (fp32 on both sides, sums in other orders through 37 convolutions;
  measured 4.8e-7 on a CPU);
- ``ExtractR21D`` end to end: the same 1e-4 (measured 4.8e-7), and the
  ``--show_pred`` lines equal to the JAX package's (3 decimals).
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_features_tpu.config import ExtractionConfig as JaxConfig
from video_features_tpu.models.r21d import convert as jax_convert
from video_features_tpu.models.r21d import model as jax_model
from video_features_tpu.models.r21d.extract_r21d import ExtractR21D as JaxExtractR21D
from video_features_tpu.models.r21d.extract_r21d import (
    kinetics_preprocess as jax_kinetics_preprocess,
)
from video_features_tpu_torch.config import ExtractionConfig, sanity_check
from video_features_tpu_torch.models.r21d.convert import convert_state_dict, params_from_jax
from video_features_tpu_torch.models.r21d.extract_r21d import ExtractR21D, kinetics_preprocess
from video_features_tpu_torch.models.r21d.model import R2Plus1D, init_weights, midplanes

ATOL = 1e-4
PRE_ATOL = 1e-5
PRED_LINE = re.compile(r"^-?\d+\.\d{3} \d\.\d{3} \S|.* @ frames \(\d+, \d+\)$")


def seeded_r21d(seed):
    model = init_weights(R2Plus1D(), seed=seed)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                n = m.num_features
                for t, lo, hi in ((m.weight, 0.5, 1.5), (m.bias, -0.1, 0.1),
                                  (m.running_mean, -0.1, 0.1), (m.running_var, 0.5, 1.5)):
                    t.copy_(torch.from_numpy(rng.uniform(lo, hi, n).astype(np.float32)))
        model.fc.bias.copy_(torch.from_numpy(rng.uniform(-0.1, 0.1, 400).astype(np.float32)))
    return model.eval()


def _numpy_sd(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def model():
    return seeded_r21d(seed=1)


def test_r21d_matches_jax_and_round_trips(model):
    assert [midplanes(i, o) for i, o in ((64, 64), (64, 128), (128, 128), (256, 512))] == [
        jax_model.midplanes(i, o) for i, o in ((64, 64), (64, 128), (128, 128), (256, 512))]
    sd = _numpy_sd(model)
    params = jax_convert.convert_state_dict(sd)
    back = params_from_jax(params)
    assert sorted(back) == sorted(k for k in sd if not k.endswith("num_batches_tracked"))
    assert all(np.array_equal(v.numpy(), sd[k]) for k, v in back.items())
    with pytest.raises(ValueError, match="unconsumed"):
        convert_state_dict({**sd, "stray.weight": np.zeros(3, np.float32)})

    x = np.random.RandomState(2).randn(1, 8, 32, 32, 3).astype(np.float32)
    with torch.inference_mode():
        feats, logits = (t.numpy() for t in model(torch.from_numpy(x).permute(0, 4, 1, 2, 3)))
    ref_feats, ref_logits = (np.asarray(t) for t in jax.jit(jax_model.build().apply)(
        {"params": params}, jnp.asarray(x)))
    assert feats.shape == ref_feats.shape == (1, 512)
    assert logits.shape == ref_logits.shape == (1, 400)
    np.testing.assert_allclose(feats, ref_feats, atol=ATOL, rtol=0)
    np.testing.assert_allclose(logits, ref_logits, atol=ATOL, rtol=0)


@pytest.mark.parametrize("hw", [(240, 320), (90, 61)])
def test_kinetics_preprocess_matches_jax(hw):
    x = np.random.RandomState(3).randint(0, 256, (2, 3, *hw, 3)).astype(np.uint8)
    ours = kinetics_preprocess(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.jit(jax_kinetics_preprocess)(jnp.asarray(x)))
    assert ours.shape == ref.shape == (2, 3, 112, 112, 3)
    np.testing.assert_allclose(ours, ref, atol=PRE_ATOL, rtol=0)


def test_extract_r21d_matches_jax(sample_video, tmp_path, capsys, model):
    """24 frames at 10 fps in 8-frame stacks every 8: 3 stacks, in groups
    of 2 (the second padded)."""
    weights = tmp_path / "r2plus1d_18.pth"
    torch.save(model.state_dict(), weights)
    cfg = ExtractionConfig(feature_type="r21d_rgb", video_paths=[sample_video], cpu=True,
                           weights_path=str(weights), extraction_fps=10.0, stack_size=8,
                           step_size=8, batch_size=2, show_pred=True)
    (ours,) = ExtractR21D(sanity_check(cfg), external_call=True)()
    ours_preds = [ln for ln in capsys.readouterr().out.splitlines() if PRED_LINE.match(ln)]

    jax_ex = JaxExtractR21D(JaxConfig(
        feature_type="r21d_rgb", video_paths=[sample_video], extraction_fps=10.0, stack_size=8,
        step_size=8, batch_size=2, show_pred=True, cpu=True, decoder="cv2",
        output_path=str(tmp_path / "jax"), tmp_path=str(tmp_path / "tmp"),
    ), external_call=True)
    jax_ex._host_params = jax_convert.convert_state_dict(_numpy_sd(model))
    (ref,) = jax_ex([0])
    ref_preds = [ln for ln in capsys.readouterr().out.splitlines() if PRED_LINE.match(ln)]
    assert ours["r21d_rgb"].shape == ref["r21d_rgb"].shape == (3, 512)
    np.testing.assert_allclose(ours["r21d_rgb"], ref["r21d_rgb"], atol=ATOL, rtol=0)
    assert len(ours_preds) == 3 * 6
    assert ours_preds == ref_preds
    assert float(ours["fps"]) == 10.0 and len(ours["timestamps_ms"]) == 24


def test_short_video_gives_no_stacks(sample_video):
    cfg = ExtractionConfig(feature_type="r21d_rgb", video_paths=[sample_video], cpu=True,
                           allow_random_init=True, extraction_fps=1.0)
    ex = ExtractR21D(cfg, external_call=True)
    payload = ex.prepare(sample_video)
    assert len(payload[0]) < 16 and payload[1] == []
    assert ex.forward(ex.warmup(torch.device("cpu")), payload)["r21d_rgb"].shape == (0, 512)
