"""The port's I3D path against the JAX package's.

One set of weights reaches both packages: the port's seeded modules (with
BatchNorm statistics drawn away from identity) give reference-layout
state dicts, which the JAX package's own converters take. Tolerances:

- the full network at 1x10x224x224, rgb and flow: 1e-5 on features and
  logits of scale ~0.5 (fp32 on both sides, sums in other orders through
  ~60 convolutions; measured ~2e-7 on a CPU);
- ``ExtractI3D`` two-stream end to end: rgb 1e-5 as above. The flow
  stream's input is rounded to uint8 levels, and PWC's flow agrees
  between the packages only to ~1e-6 px (measured at 64x96, test_torch_pwc),
  so a value that close to a rounding boundary can land on the
  neighbouring level (2/255 after scaling). The flow features are held
  to 1e-4 of their own scale, ten times the rgb bound, as room for such
  a flip; measured here 1.8e-7 of 0.4.
"""

import dataclasses
import os
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_features_tpu.config import ExtractionConfig as JaxConfig
from video_features_tpu.io import paths as jax_paths
from video_features_tpu.models.i3d import convert as jax_i3d_convert
from video_features_tpu.models.i3d import model as jax_i3d
from video_features_tpu.models.i3d.extract_i3d import ExtractI3D as JaxExtractI3D
from video_features_tpu.models.pwc import convert as jax_pwc_convert
from video_features_tpu.ops import preprocess as jax_pre
from video_features_tpu_torch import cli
from video_features_tpu_torch.config import ExtractionConfig, sanity_check
from video_features_tpu_torch.io.paths import form_slices
from video_features_tpu_torch.models.i3d.convert import convert_state_dict, params_from_jax
from video_features_tpu_torch.models.i3d.extract_i3d import ExtractI3D
from video_features_tpu_torch.models.i3d.model import I3D, init_weights, max_pool_tf, tf_same_pads
from video_features_tpu_torch.models.pwc.model import PWCNet
from video_features_tpu_torch.models.pwc.model import init_weights as pwc_init
from video_features_tpu_torch.ops.preprocess import flow_to_uint8, scale_to_1_1

ATOL = 1e-5
FLOW_FEATURE_RTOL = 1e-4


def seeded_i3d(in_channels, seed):
    model = init_weights(I3D(in_channels), seed=seed)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                n = m.num_features
                for t, lo, hi in ((m.weight, 0.5, 1.5), (m.bias, -0.1, 0.1),
                                  (m.running_mean, -0.1, 0.1), (m.running_var, 0.5, 1.5)):
                    t.copy_(torch.from_numpy(rng.uniform(lo, hi, n).astype(np.float32)))
    return model.eval()


def _numpy_sd(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("kernel,stride", [((7, 7, 7), (2, 2, 2)), ((1, 3, 3), (1, 2, 2)),
                                           ((3, 3, 3), (1, 1, 1)), ((2, 2, 2), (2, 2, 2))])
def test_tf_same_pads_and_max_pool_match_jax(kernel, stride):
    assert tf_same_pads(kernel, stride) == jax_i3d.tf_same_pads(kernel, stride)
    # odd sizes: the ceil-mode edge window is partly padding
    x = np.random.RandomState(0).rand(2, 3, 7, 11, 9).astype(np.float32)
    ours = max_pool_tf(torch.from_numpy(x), kernel, stride).numpy()
    ref = np.asarray(jax_i3d.max_pool_tf(jnp.asarray(x.transpose(0, 2, 3, 4, 1)), kernel,
                                         stride)).transpose(0, 4, 1, 2, 3)
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


def test_flow_to_uint8_and_scale_match_jax():
    step = 40.0 / 255.0  # one uint8 level of flow
    flow = np.array([-25.0, -20.0, -0.0, 20.0, 20.5, 0.3, -7.77,
                     0.5 * step, 1.5 * step, -0.5 * step, -2.5 * step], np.float32)
    ours = flow_to_uint8(torch.from_numpy(flow)).numpy()
    ref = np.asarray(jax_pre.flow_to_uint8(jnp.asarray(flow)))
    np.testing.assert_array_equal(ours, ref)
    assert ours[3] == ours[4] == 256.0 and ours[0] == ours[1] == 0.0  # the reference's +20
    x = np.linspace(0, 255, 7, dtype=np.float32)
    np.testing.assert_allclose(scale_to_1_1(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_pre.scale_to_1_1(jnp.asarray(x))), atol=0)


@pytest.mark.parametrize("size,stack,step", [(129, 65, 64), (65, 65, 64), (64, 65, 64),
                                             (12, 11, 10), (100, 17, 5), (3, 11, 10)])
def test_form_slices_matches_jax(size, stack, step):
    assert form_slices(size, stack, step) == jax_paths.form_slices(size, stack, step)


def test_i3d_round_trip_is_exact():
    sd = _numpy_sd(seeded_i3d(2, seed=5))
    back = params_from_jax(jax_i3d_convert.convert_state_dict(sd))
    assert sorted(back) == sorted(k for k in sd if not k.endswith("num_batches_tracked"))
    assert all(np.array_equal(v.numpy(), sd[k]) for k, v in back.items())
    native = convert_state_dict({f"module.{k}": v for k, v in sd.items()})
    assert sorted(native) == sorted(back)
    with pytest.raises(ValueError, match="unconsumed"):
        convert_state_dict({**sd, "stray.weight": np.zeros(3, np.float32)})


@pytest.mark.parametrize("modality,channels", [("rgb", 3), ("flow", 2)])
def test_full_i3d_matches_jax(modality, channels):
    model = seeded_i3d(channels, seed=channels)
    x = np.random.RandomState(channels).uniform(-1, 1, (1, 10, 224, 224, channels))
    x = x.astype(np.float32)
    with torch.inference_mode():
        feats, logits = (t.numpy() for t in model(torch.from_numpy(x)))
    params = jax_i3d_convert.convert_state_dict(_numpy_sd(model))
    ref_feats, ref_logits = (np.asarray(t) for t in jax_i3d.build().apply(
        {"params": params}, jnp.asarray(x)))
    assert feats.shape == ref_feats.shape == (1, 1024)
    assert logits.shape == ref_logits.shape == (1, 400)
    np.testing.assert_allclose(feats, ref_feats, atol=ATOL, rtol=0)
    np.testing.assert_allclose(logits, ref_logits, atol=ATOL, rtol=0)


def test_extract_i3d_two_stream_matches_jax(sample_video, tmp_path):
    """The slice as a whole: the port's CLI on a directory of reference-
    named checkpoints, against the JAX extractor on the same weights."""
    models = {"rgb": seeded_i3d(3, seed=6), "flow": seeded_i3d(2, seed=7),
              "pwc": pwc_init(PWCNet(), seed=8)}
    weights = tmp_path / "weights"
    weights.mkdir()
    for kind, name in (("rgb", "i3d_rgb.pt"), ("flow", "i3d_flow.pt"),
                       ("pwc", "pwc_net_sintel.pt")):
        torch.save(models[kind].state_dict(), weights / name)
    cli.main(["--feature_type", "i3d", "--flow_type", "pwc", "--cpu",
              "--video_paths", sample_video, "--weights_path", str(weights),
              "--extraction_fps", "5", "--stack_size", "10", "--step_size", "10",
              "--on_extraction", "save_numpy", "--output_path", str(tmp_path / "port"),
              "--tmp_path", str(tmp_path / "tmp")])
    ours = {p.name: np.load(p) for p in pathlib.Path(tmp_path / "port").rglob("*.npy")}
    assert sorted(ours) == ["synth_flow.npy", "synth_rgb.npy"]

    jax_ex = JaxExtractI3D(JaxConfig(
        feature_type="i3d", video_paths=[sample_video], flow_type="pwc", extraction_fps=5.0,
        stack_size=10, step_size=10, cpu=True, decoder="cv2", output_path=str(tmp_path / "jax"),
        tmp_path=str(tmp_path / "tmp"),
    ), external_call=True)
    jax_ex._host_params = {
        "rgb": jax_i3d_convert.convert_state_dict(_numpy_sd(models["rgb"])),
        "flow": jax_i3d_convert.convert_state_dict(_numpy_sd(models["flow"])),
        "pwc": jax_pwc_convert.convert_state_dict(_numpy_sd(models["pwc"])),
    }
    (ref,) = jax_ex([0])
    # 60 frames at 25 fps -> 12 sampled -> one 11-frame stack
    for stream in ("rgb", "flow"):
        assert ours[f"synth_{stream}.npy"].shape == ref[stream].shape == (1, 1024)
    np.testing.assert_allclose(ours["synth_rgb.npy"], ref["rgb"], atol=ATOL, rtol=0)
    flow_tol = FLOW_FEATURE_RTOL * np.abs(ref["flow"]).max()
    np.testing.assert_allclose(ours["synth_flow.npy"], ref["flow"], atol=flow_tol, rtol=0)

    # the same run in process: fps and timestamps as the JAX package gives them
    cfg = ExtractionConfig(feature_type="i3d", video_paths=[sample_video], cpu=True,
                           weights_path=str(weights), extraction_fps=5.0, stack_size=10,
                           step_size=10)
    (res,) = ExtractI3D(cfg, external_call=True)()
    assert float(res["fps"]) == float(ref["fps"]) == 25.0
    np.testing.assert_allclose(res["timestamps_ms"], ref["timestamps_ms"])


def test_resume_probes_both_streams(sample_video, tmp_path):
    cfg = ExtractionConfig(feature_type="i3d", video_paths=[sample_video], cpu=True,
                           allow_random_init=True, on_extraction="save_numpy",
                           output_path=str(tmp_path / "out"), resume=True)
    ex = ExtractI3D(cfg)
    assert ex.feature_keys() == ["rgb", "flow"]
    os.makedirs(ex.output_path)
    pathlib.Path(ex.output_path, "synth_rgb.npy").touch()
    assert not ex._already_done(sample_video)
    pathlib.Path(ex.output_path, "synth_flow.npy").touch()
    assert ex._already_done(sample_video)
    only_rgb = ExtractI3D(dataclasses.replace(cfg, streams=["rgb"]))
    assert only_rgb._already_done(sample_video)


def test_short_video_upsamples_to_65_frames(tmp_path):
    from video_features_tpu_torch.utils.synth import synth_video

    path = synth_video(str(tmp_path / "short.mp4"), n_frames=20)
    ex = ExtractI3D(ExtractionConfig(feature_type="i3d", video_paths=[path], cpu=True))
    frames, fps, stamps = ex._sample_frames(path)
    ref = JaxExtractI3D(JaxConfig(feature_type="i3d", video_paths=[path], cpu=True,
                                  decoder="cv2"))._sample_frames(path)
    assert len(frames) == len(ref[0]) == 65 and stamps == ref[2] and fps == ref[1]
    assert all(np.array_equal(a, b) for a, b in zip(frames, ref[0]))


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(flow_type="farneback"), "unknown flow_type"),
        (dict(flow_type="flow"), "from disk.*ROADMAP"),
        (dict(stack_size=9), "shorter than 10"),
        (dict(streams=["depth"]), "streams"),
        (dict(batch_size=0), "batch_size"),
        (dict(show_pred=True), "show_pred is not ported yet for i3d"),
    ],
)
def test_sanity_check_rejects(kw, match):
    with pytest.raises((ValueError, AssertionError), match=match):
        sanity_check(ExtractionConfig(feature_type="i3d", **kw))


def test_rgb_only_with_raft_is_allowed():
    """--flow_type names the flow model; without the flow stream it is unused."""
    sanity_check(ExtractionConfig(feature_type="i3d", flow_type="raft", streams=["rgb"]))
