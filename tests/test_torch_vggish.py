"""The port's VGGish against the JAX package's.

Full width (VGGish has one): the same seeded weights reach both packages
through each converter, and the same log-mel examples give embeddings
within 1e-4 relative L2 (fp32 sums in other orders through 6 convs and
3 Linears). The extractor is held to the JAX extractor on a 3 s 44.1 kHz
chirp, the PCA postprocess to uint8 equality. The model is built once per
module.
"""

import pathlib

import numpy as np
import pytest
import torch

from video_features_tpu.config import ExtractionConfig as JaxConfig
from video_features_tpu.models.vggish import model as jax_model
from video_features_tpu.models.vggish.convert import convert_state_dict as jax_convert
from video_features_tpu.models.vggish.extract_vggish import ExtractVGGish as JaxExtractVGGish
from video_features_tpu_torch import cli
from video_features_tpu_torch.io import ffmpeg as port_ffmpeg
from video_features_tpu_torch.models.vggish import model as port_model
from video_features_tpu_torch.models.vggish.convert import (
    convert_pca_params,
    convert_state_dict,
    params_from_jax,
)
from video_features_tpu_torch.models.vggish.extract_vggish import ExtractVGGish
from video_features_tpu_torch.config import ExtractionConfig
from video_features_tpu_torch.runtime import faults
from video_features_tpu_torch.utils.synth import synth_wav

RTOL = 1e-4  # relative L2, fp32 CPU vs CPU
CARD_RTOL = 1e-3  # relative L2, the card vs the CPU (TF32 off)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def port_vggish():
    return port_model.init_weights(port_model.VGGish(), seed=3).eval()


@pytest.fixture(scope="module")
def port_sd(port_vggish):
    return {k: v.numpy() for k, v in port_vggish.state_dict().items()}


@pytest.fixture(scope="module")
def jax_apply():
    import jax

    net = jax_model.build()
    fn = jax.jit(lambda p, x: net.apply({"params": p}, x))
    return lambda params, x: np.asarray(fn(params, x))


@pytest.fixture(scope="module")
def examples():
    # log-mel-like values: log(mel + 0.01) spans about [-4.6, 3]
    return np.random.default_rng(0).uniform(-4.6, 3.0, (3, 96, 64)).astype(np.float32)


def _port_forward(model, x):
    with torch.inference_mode():
        return model(torch.from_numpy(x[:, None])).numpy()


def _jax_tree(seed: int):
    """A Flax VGGish param tree (HWIO conv kernels, (in, out) Dense
    kernels) of seeded LeCun-normal numpy leaves and small biases."""
    rng = np.random.default_rng(seed)
    tree, cin = {}, 1
    for idx, cout in jax_model._CONV_LAYOUT:
        tree[f"features_{idx}"] = {
            "kernel": (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32),
            "bias": (0.01 * rng.standard_normal(cout)).astype(np.float32)}
        cin = cout
    for idx, (din, dout) in zip((0, 2, 4), ((12288, 4096), (4096, 4096), (4096, 128))):
        tree[f"embeddings_{idx}"] = {
            "kernel": (rng.standard_normal((din, dout), np.float32) / np.sqrt(din)),
            "bias": (0.01 * rng.standard_normal(dout)).astype(np.float32)}
    return tree


def test_from_jax_tree_matches_jax(jax_apply, examples):
    params = _jax_tree(seed=1)
    model = port_model.VGGish()
    model.load_state_dict(params_from_jax(params))
    ours = _port_forward(model.eval(), examples)
    ref = jax_apply(params, examples[..., None])
    assert ours.shape == (3, 128) and (ours >= 0).all()  # the final ReLU
    assert rel_l2(ours, ref) <= RTOL


def test_from_torch_state_dict_matches_jax(port_vggish, port_sd, jax_apply, examples):
    ours = _port_forward(port_vggish, examples)
    ref = jax_apply(jax_convert(port_sd), examples[..., None])
    assert np.abs(ours).max() > 0
    assert rel_l2(ours, ref) <= RTOL


def test_postprocess_matches_jax():
    rng = np.random.default_rng(1)
    emb = rng.uniform(0, 2, (5, 128)).astype(np.float32)
    pca = {"pca_eigen_vectors": rng.standard_normal((128, 128)).astype(np.float32) * 0.1,
           "pca_means": rng.uniform(0, 1, (128, 1)).astype(np.float32)}
    ours = port_model.postprocess(torch.from_numpy(emb), convert_pca_params(pca))
    ref = np.asarray(jax_model.postprocess(
        emb, {k: np.asarray(v).reshape(-1) if k == "pca_means" else v for k, v in pca.items()}))
    assert ours.dtype == torch.uint8 and ref.dtype == np.uint8
    assert np.array_equal(ours.numpy(), ref)  # uint8 equal
    assert ours.numpy().min() == 0 and ours.numpy().max() == 255  # both clips are hit


def test_converter_strips_module_and_rejects_unconsumed(port_sd):
    sd = {f"module.{k}": v for k, v in port_sd.items()}
    assert sorted(convert_state_dict(sd)) == sorted(port_sd)
    with pytest.raises(ValueError, match="unconsumed"):
        convert_state_dict({**port_sd, "classifier.weight": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="lacks"):
        convert_state_dict({k: v for k, v in port_sd.items() if k != "embeddings.4.bias"})


def _npys(root):
    return {p.name: np.load(p) for p in pathlib.Path(root).rglob("*.npy")}


def test_extract_vggish_matches_jax(port_sd, tmp_path):
    """The port's CLI and the JAX extractor write the same file for a 3 s
    44.1 kHz stereo chirp, from one weight file."""
    wav = synth_wav(str(tmp_path / "chirp.wav"), seconds=3.0, sample_rate=44100, seed=4)
    weights = str(tmp_path / "vggish.npz")
    np.savez(weights, **port_sd)
    common = dict(video_paths=[wav], on_extraction="save_numpy",
                  tmp_path=str(tmp_path / "tmp"), weights_path=weights)
    cli.main(["--feature_type", "vggish", "--cpu", "--video_paths", wav,
              "--weights_path", weights, "--on_extraction", "save_numpy",
              "--output_path", str(tmp_path / "port"), "--tmp_path", str(tmp_path / "tmp")])
    JaxExtractVGGish(JaxConfig(feature_type="vggish", cpu=True,
                               output_path=str(tmp_path / "jax"), **common))([0])
    ours, ref = _npys(tmp_path / "port"), _npys(tmp_path / "jax")
    assert sorted(ours) == sorted(ref) == ["chirp_vggish.npy"]
    assert ours["chirp_vggish.npy"].shape == (3, 128)
    assert rel_l2(ours["chirp_vggish.npy"], ref["chirp_vggish.npy"]) <= RTOL


def test_short_clip_gives_no_examples(tmp_path):
    wav = synth_wav(str(tmp_path / "short.wav"), seconds=0.5, sample_rate=16000, seed=5)
    ex = ExtractVGGish(ExtractionConfig(feature_type="vggish_torch", video_paths=[wav],
                                        allow_random_init=True, cpu=True), external_call=True)
    payload = ex.prepare(wav)
    assert payload == (None, 0)
    feats = ex.forward(None, payload)  # the model is not reached
    assert feats["vggish_torch"].shape == (0, 128)
    assert feats["vggish_torch"].dtype == np.float32


def test_video_without_ffmpeg_fails_permanent(monkeypatch, sample_video, tmp_path):
    """A container needs ffmpeg for its audio; without the binary the video
    fails once, classified permanent, with no retry."""
    monkeypatch.setattr(port_ffmpeg.shutil, "which", lambda name: None)
    argv = ["--feature_type", "vggish", "--cpu", "--allow_random_init",
            "--video_paths", sample_video, "--on_extraction", "save_numpy",
            "--output_path", str(tmp_path / "out"), "--tmp_path", str(tmp_path / "tmp"),
            "--strict"]
    with pytest.raises(SystemExit, match="--strict"):
        cli.main(argv)
    summary = faults.merge_manifest(str(tmp_path / "out"))
    (rec,) = summary["videos"].values()
    assert summary["retries"] == 0 and rec["attempts"] == 1
    assert rec["status"] == "failed" and rec["error_class"] == "permanent"
    assert "ffmpeg binary not found" in rec["message"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_card_matches_cpu(cuda_device, port_vggish, examples):
    from video_features_tpu_torch.devices import pin_fp32

    pin_fp32()
    cpu = _port_forward(port_vggish, examples)
    model = port_model.init_weights(port_model.VGGish(), seed=3).to(cuda_device).eval()
    with torch.inference_mode():
        card = model(torch.from_numpy(examples[:, None]).to(cuda_device)).cpu().numpy()
    assert rel_l2(card, cpu) <= CARD_RTOL
