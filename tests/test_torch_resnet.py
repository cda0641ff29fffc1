"""The port's ResNet path against the JAX package's.

One set of weights reaches both packages: the port's seeded modules (with
BatchNorm statistics drawn away from identity) give torchvision-layout
state dicts, which the JAX package's own converter takes. Tolerances:

- ``imagenet_preprocess``: byte-identical (both bottom out in the same
  PIL calls and the same float32 arithmetic);
- resnet18 and resnet50 at 2x3x64x64: 1e-4 on features and logits of
  a few units (fp32 on both sides, sums in other orders through 20 and 53
  convolutions; measured up to 6.9e-6 on values up to 17 on a CPU);
- ``ExtractResNet`` end to end: the same 1e-4 (measured 2.4e-6), and the
  ``--show_pred`` lines equal to the JAX package's (3 decimals).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_features_tpu.config import ExtractionConfig as JaxConfig
from video_features_tpu.io.video import stream_frames as jax_stream_frames
from video_features_tpu.models.resnet import convert as jax_convert
from video_features_tpu.models.resnet import model as jax_model
from video_features_tpu.models.resnet.extract_resnet import ExtractResNet as JaxExtractResNet
from video_features_tpu.ops import preprocess as jax_pre
from video_features_tpu.utils import labels as jax_labels
from video_features_tpu_torch import cli
from video_features_tpu_torch.config import ExtractionConfig
from video_features_tpu_torch.io.video import stream_frames
from video_features_tpu_torch.models.resnet.convert import convert_state_dict, params_from_jax
from video_features_tpu_torch.models.resnet.extract_resnet import ExtractResNet
from video_features_tpu_torch.models.resnet.model import ResNet, init_weights
from video_features_tpu_torch.ops.preprocess import imagenet_preprocess
from video_features_tpu_torch.utils import labels

from torch_threads import one_torch_thread  # noqa: F401 - an autouse fixture

ATOL = 1e-4
PRED_LINE = re.compile(r"^-?\d+\.\d{3} \d\.\d{3} \S")


def seeded_resnet(arch, seed):
    model = init_weights(ResNet(arch), seed=seed)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                for t, lo, hi in ((m.weight, 0.5, 1.5), (m.bias, -0.1, 0.1),
                                  (m.running_mean, -0.1, 0.1), (m.running_var, 0.5, 1.5)):
                    t.copy_(torch.from_numpy(rng.uniform(lo, hi, n).astype(np.float32)))
        model.fc.bias.copy_(torch.from_numpy(rng.uniform(-0.1, 0.1, 1000).astype(np.float32)))
    return model.eval()


def _numpy_sd(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("arch,dim", [("resnet18", 512), ("resnet50", 2048)])
def test_resnet_matches_jax_and_round_trips(arch, dim):
    model = seeded_resnet(arch, seed=1)
    sd = _numpy_sd(model)
    params = jax_convert.convert_state_dict(sd, arch)
    back = params_from_jax(params, arch)
    assert sorted(back) == sorted(k for k in sd if not k.endswith("num_batches_tracked"))
    assert all(np.array_equal(v.numpy(), sd[k]) for k, v in back.items())
    with pytest.raises(ValueError, match="unconsumed"):
        convert_state_dict({**sd, "stray.weight": np.zeros(3, np.float32)}, arch)

    x = np.random.RandomState(2).randn(2, 3, 64, 64).astype(np.float32)
    with torch.inference_mode():
        feats, logits = (t.numpy() for t in model(torch.from_numpy(x)))
    ref_feats, ref_logits = (np.asarray(t) for t in jax.jit(jax_model.build(arch).apply)(
        {"params": params}, jnp.asarray(x)))
    assert feats.shape == ref_feats.shape == (2, dim) and dim == jax_model.feature_dim(arch)
    assert logits.shape == ref_logits.shape == (2, 1000)
    np.testing.assert_allclose(feats, ref_feats, atol=ATOL, rtol=0)
    np.testing.assert_allclose(logits, ref_logits, atol=ATOL, rtol=0)


def test_imagenet_preprocess_byte_identical(sample_video):
    frame = next(iter(stream_frames(sample_video)))[0]
    (ref_frame, _), = [next(iter(jax_stream_frames(sample_video, None, "cv2")))]
    assert np.array_equal(frame, ref_frame)
    small = frame[:100, :60]  # a frame smaller than the crop: zero-padded
    for img in (frame, small):
        ours, ref = imagenet_preprocess(img), jax_pre.imagenet_preprocess(img)
        assert ours.shape == ref.shape == (3, 224, 224) and ours.dtype == np.float32
        assert np.array_equal(ours, ref)


def test_labels_are_the_ports_own_copies():
    for dataset, n in (("imagenet", 1000), ("kinetics", 400)):
        assert labels.load_classes(dataset) == jax_labels.load_classes(dataset)
        assert len(labels.load_classes(dataset)) == n
    assert pathlib.Path(labels._DATA_DIR).parent.name == "video_features_tpu_torch"


def test_extract_resnet_matches_jax(sample_video, tmp_path, capsys):
    """12 frames at 5 fps in batches of 5: the tail batch of 2 is padded."""
    model = seeded_resnet("resnet18", seed=3)
    weights = tmp_path / "resnet18.pth"
    torch.save(model.state_dict(), weights)
    cli.main(["--feature_type", "resnet18", "--cpu", "--video_paths", sample_video,
              "--weights_path", str(weights), "--extraction_fps", "5", "--batch_size", "5",
              "--show_pred", "--on_extraction", "save_numpy",
              "--output_path", str(tmp_path / "port"), "--tmp_path", str(tmp_path / "tmp")])
    ours_preds = [ln for ln in capsys.readouterr().out.splitlines() if PRED_LINE.match(ln)]
    (ours,) = pathlib.Path(tmp_path / "port").rglob("*.npy")
    assert ours.name == "synth_resnet18.npy"
    ours = np.load(ours)

    jax_ex = JaxExtractResNet(JaxConfig(
        feature_type="resnet18", video_paths=[sample_video], extraction_fps=5.0, batch_size=5,
        show_pred=True, cpu=True, decoder="cv2", output_path=str(tmp_path / "jax"),
        tmp_path=str(tmp_path / "tmp"),
    ), external_call=True)
    jax_ex._host_params = jax_convert.convert_state_dict(_numpy_sd(model), "resnet18")
    (ref,) = jax_ex([0])
    ref_preds = [ln for ln in capsys.readouterr().out.splitlines() if PRED_LINE.match(ln)]
    assert ours.shape == ref["resnet18"].shape == (12, 512)
    np.testing.assert_allclose(ours, ref["resnet18"], atol=ATOL, rtol=0)
    assert len(ours_preds) == 12 * 5
    assert ours_preds == ref_preds

    (res,) = ExtractResNet(ExtractionConfig(
        feature_type="resnet18", video_paths=[sample_video], cpu=True,
        weights_path=str(weights), extraction_fps=5.0, batch_size=5), external_call=True)()
    assert float(res["fps"]) == float(ref["fps"]) == 5.0
    np.testing.assert_allclose(res["timestamps_ms"], ref["timestamps_ms"])
