"""The port's RAFT, standalone and as I3D's flow, against the JAX package.

One set of weights reaches both packages: the port's seeded module (with
the cnet's BatchNorm statistics drawn away from identity) gives a
princeton-vl-layout state dict, which the JAX package's own converter
takes. Tolerances, on fp32 on both sides (sums in other orders):

- ``InputPadder``: exact (the same integer pads and ``np.pad``);
- ``build_corr_pyramid`` and ``upsample_flow``: 1e-5 on values of a few
  units (measured 0 and 1.9e-6 on a CPU);
- ``lookup_corr``: 1e-5 of the volume's largest magnitude (measured
  7.6e-6 on values up to 3.6, 2.1e-6 of it): ``grid_sample`` forms its
  bilinear weights from coordinates normalised to [-1, 1] and back, a
  few ulp of a coordinate, the JAX package from pixel coordinates;
- the encoders: 1e-4 on features of unit scale after up to 13
  convolutions (measured 1.2e-5 on values up to 6.7);
- the full net: relative to the flow's largest magnitude, 1e-5 at
  ``iters=3`` and 1e-4 at ``iters=20``, where the drift compounds
  through the GRU (measured 6.8e-7 of 31 px and 4.9e-7 of 188 px);
- ``ExtractRAFT`` end to end: the flow at 1e-4 of its largest magnitude
  (measured 5.4e-7 of 197 px);
- I3D's RAFT flow stream: the I3D-flow input is uint8 levels, and a flow
  that agrees to ~1e-6 px can still round to the neighbouring level, so
  the inputs may differ by one level (2/255) at a share of 1e-3 of their
  values, and the flow features by 1e-3 of their scale (measured 3.3e-5
  of it).
"""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_features_tpu.config import ExtractionConfig as JaxConfig
from video_features_tpu.models.i3d import convert as jax_i3d_convert
from video_features_tpu.models.i3d import model as jax_i3d
from video_features_tpu.models.i3d.extract_i3d import flow_chain as jax_flow_chain
from video_features_tpu.models.raft import convert as jax_convert
from video_features_tpu.models.raft import model as jax_model
from video_features_tpu.models.raft.extract_raft import ExtractRAFT as JaxExtractRAFT
from video_features_tpu.models.raft.extract_raft import InputPadder as JaxInputPadder
from video_features_tpu_torch import cli
from video_features_tpu_torch.config import ExtractionConfig, sanity_check
from video_features_tpu_torch.models.i3d.extract_i3d import ExtractI3D, flow_chain
from video_features_tpu_torch.models.i3d.model import I3D
from video_features_tpu_torch.models.i3d.model import init_weights as i3d_init
from video_features_tpu_torch.models.raft import model as raft
from video_features_tpu_torch.models.raft.convert import convert_state_dict, params_from_jax
from video_features_tpu_torch.models.raft.extract_raft import InputPadder

from torch_threads import one_torch_thread  # noqa: F401 - an autouse fixture

ATOL = 1e-5
LOOKUP_RTOL = 1e-5
ENCODER_ATOL = 1e-4
FLOW_RTOL = {3: 1e-5, 20: 1e-4}
EXTRACT_FLOW_RTOL = 1e-4
LEVEL_FLIP_SHARE = 1e-3
FLOW_FEATURE_RTOL = 1e-3


def seeded_raft(seed=1, iters=20):
    model = raft.init_weights(raft.RAFT(iters=iters), seed=seed)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                for t, lo, hi in ((m.weight, 0.5, 1.5), (m.bias, -0.1, 0.1),
                                  (m.running_mean, -0.1, 0.1), (m.running_var, 0.5, 1.5)):
                    t.copy_(torch.from_numpy(rng.uniform(lo, hi, n).astype(np.float32)))
    return model.eval()


def _numpy_sd(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def weights():
    """(port model at iters=20, the JAX param tree of the same weights)."""
    model = seeded_raft()
    return model, jax_convert.convert_state_dict(_numpy_sd(model))


@pytest.mark.parametrize("shape", [(256, 341), (240, 320), (100, 60), (129, 131), (7, 300),
                                   (128, 128)])
def test_input_padder_matches_jax(shape):
    ours, ref = InputPadder(shape), JaxInputPadder(shape)
    assert ours._pad == ref._pad
    x = np.random.RandomState(0).uniform(0, 255, (2, *shape, 3)).astype(np.float32)
    padded = ours.pad(x)
    np.testing.assert_array_equal(padded, ref.pad(x))
    assert padded.shape[1:3] == raft.input_grid(*shape)
    assert all(s % 8 == 0 and s >= 128 for s in padded.shape[1:3])
    np.testing.assert_array_equal(ours.unpad(padded), x)
    # the device pad is the host pad
    np.testing.assert_array_equal(ours.pad_tensor(torch.from_numpy(x)).numpy(), padded)
    assert ours.unpad(torch.from_numpy(padded)).shape == x.shape


def test_corr_pyramid_and_lookup_match_jax():
    rng = np.random.RandomState(2)
    # odd sizes: every pooled level floors
    f1, f2 = (rng.randn(2, 9, 13, 16).astype(np.float32) for _ in range(2))
    ours = raft.build_corr_pyramid(torch.from_numpy(f1.transpose(0, 3, 1, 2)),
                                   torch.from_numpy(f2.transpose(0, 3, 1, 2)))
    ref = jax.jit(jax_model.build_corr_pyramid)(jnp.asarray(f1), jnp.asarray(f2))
    assert [tuple(p.shape) for p in ours] == [(234, 1, 9, 13), (234, 1, 4, 6), (234, 1, 2, 3),
                                              (234, 1, 1, 1)]
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy()[:, 0], np.asarray(r)[..., 0], atol=ATOL, rtol=0)

    # the top three levels of a 16x20 map; centres off the map on every
    # side and fractional, so windows cross the border
    f1, f2 = (rng.randn(2, 16, 20, 8).astype(np.float32) for _ in range(2))
    pyr = raft.build_corr_pyramid(torch.from_numpy(f1.transpose(0, 3, 1, 2)),
                                  torch.from_numpy(f2.transpose(0, 3, 1, 2)), num_levels=3)
    jpyr = jax.jit(jax_model.build_corr_pyramid, static_argnums=2)(jnp.asarray(f1),
                                                                   jnp.asarray(f2), 3)
    coords = np.stack([rng.uniform(-7, 27, (2, 16, 20)), rng.uniform(-7, 23, (2, 16, 20))],
                      axis=-1).astype(np.float32)
    coords[0, 0, :4] = [[3.0, 5.0], [0.0, 0.0], [19.0, 15.0], [-4.5, 18.25]]  # whole pixels
    ours = raft.lookup_corr(pyr, torch.from_numpy(coords.transpose(0, 3, 1, 2))).numpy()
    ref = np.asarray(jax.jit(jax_model.lookup_corr)(jpyr, jnp.asarray(coords)))
    ref = ref.transpose(0, 3, 1, 2)
    assert ours.shape == ref.shape == (2, 3 * 81, 16, 20)
    assert (ref == 0).mean() > 0.05  # the windows do leave the maps
    np.testing.assert_allclose(ours, ref, atol=LOOKUP_RTOL * np.abs(ref).max(), rtol=0)


def test_lookup_window_is_transposed():
    """Channel i*9 + j samples (x + i - 4, y + j - 4)."""
    img = torch.arange(30 * 30, dtype=torch.float32).reshape(1, 1, 30, 30)  # value 30*y + x
    coords = torch.tensor([12.0, 17.0]).reshape(1, 2, 1, 1)  # x = 12, y = 17
    win = raft.lookup_corr([img], coords).reshape(9, 9)
    i, j = 1, 6
    assert win[i, j] == 30 * (17 + j - 4) + (12 + i - 4)


def test_upsample_flow_and_coords_grid_match_jax():
    rng = np.random.RandomState(3)
    flow = rng.randn(2, 5, 7, 2).astype(np.float32)
    mask = (3 * rng.randn(2, 5, 7, 576)).astype(np.float32)
    ours = raft.upsample_flow(torch.from_numpy(flow.transpose(0, 3, 1, 2)),
                              torch.from_numpy(mask.transpose(0, 3, 1, 2))).numpy()
    ref = np.asarray(jax.jit(jax_model.upsample_flow)(jnp.asarray(flow), jnp.asarray(mask)))
    assert ours.shape == (2, 2, 40, 56)
    np.testing.assert_allclose(ours.transpose(0, 2, 3, 1), ref, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(raft.coords_grid(2, 5, 7).numpy().transpose(0, 2, 3, 1),
                                  np.asarray(jax_model.coords_grid(2, 5, 7)))


@pytest.mark.parametrize("enc,norm,dim", [("fnet", "instance", 256), ("cnet", "batch", 256)])
def test_encoders_match_jax(weights, enc, norm, dim):
    model, params = weights
    x = np.random.RandomState(4).uniform(-1, 1, (2, 64, 96, 3)).astype(np.float32)
    with torch.inference_mode():
        ours = getattr(model, enc)(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    ref = np.asarray(jax.jit(jax_model.BasicEncoder(dim, norm).apply)({"params": params[enc]},
                                                                        jnp.asarray(x)))
    assert ours.shape == (2, dim, 8, 12)
    np.testing.assert_allclose(ours.transpose(0, 2, 3, 1), ref, atol=ENCODER_ATOL, rtol=0)


@pytest.mark.parametrize("iters", [3, 20])
def test_full_raft_matches_jax(weights, iters):
    model, params = weights
    frames = np.random.RandomState(5).uniform(0, 255, (3, 128, 128, 3)).astype(np.float32)
    model.iters = iters
    try:
        with torch.inference_mode():
            ours = model(torch.from_numpy(frames)).numpy()
            if iters == 3:
                batched = model(torch.from_numpy(np.stack([frames, frames[::-1].copy()])))
    finally:
        model.iters = 20
    ref = np.asarray(jax.jit(jax_model.build(iters=iters).apply)({"params": params},
                                                                 jnp.asarray(frames)))
    assert ours.shape == ref.shape == (2, 128, 128, 2)
    scale = np.abs(ref).max()
    assert scale > 1.0  # the random net moves pixels
    np.testing.assert_allclose(ours, ref, atol=FLOW_RTOL[iters] * scale, rtol=0)
    if iters == 3:  # a batch of sequences: each one's pairs stay inside it
        np.testing.assert_allclose(batched[0].numpy(), ours, atol=FLOW_RTOL[iters] * scale,
                                   rtol=0)


def test_round_trip_and_norm3_aliases(weights):
    model, params = weights
    sd = _numpy_sd(model)
    back = params_from_jax(params)
    assert sorted(back) == sorted(k for k in sd if not k.endswith("num_batches_tracked"))
    assert all(np.array_equal(v.numpy(), sd[k]) for k, v in back.items())
    # the reference registers each BatchNorm downsample norm twice
    aliases = {k.replace("downsample.1", "norm3"): v for k, v in sd.items()
               if k.startswith("cnet.") and ".downsample.1." in k}
    assert len(aliases) == 2 * 5  # layer2.0 and layer3.0, 5 tensors each
    native = convert_state_dict({f"module.{k}": v for k, v in {**sd, **aliases}.items()})
    assert sorted(native) == sorted(back)
    with pytest.raises(ValueError, match="unconsumed"):
        convert_state_dict({**sd, "stray.weight": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="lacks"):
        convert_state_dict({k: v for k, v in sd.items() if k != "update_block.mask.2.bias"})


def test_extract_raft_matches_jax(sample_video, tmp_path, weights):
    """``--side_size 100`` makes 100x133 frames: neither side is a
    multiple of 8 and one is below the 128 floor, so pad and unpad run."""
    model, params = weights
    path = tmp_path / "raft-sintel.pth"
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()}, path)
    common = ["--extraction_fps", "2.5", "--side_size", "100", "--batch_size", "4"]
    cli.main(["--feature_type", "raft", "--cpu", "--video_paths", sample_video,
              "--weights_path", str(path), "--on_extraction", "save_numpy",
              "--output_path", str(tmp_path / "port"), "--tmp_path", str(tmp_path / "tmp"),
              *common])
    jax_ex = JaxExtractRAFT(JaxConfig(
        feature_type="raft", video_paths=[sample_video], extraction_fps=2.5, side_size=100,
        batch_size=4, cpu=True, decoder="cv2", on_extraction="save_numpy",
        output_path=str(tmp_path / "jax"), tmp_path=str(tmp_path / "tmp"),
    ))
    jax_ex._host_params = params
    jax_ex([0])
    (ours,) = pathlib.Path(tmp_path / "port").rglob("*.npy")
    (ref,) = pathlib.Path(tmp_path / "jax").rglob("*.npy")
    assert ours.name == ref.name == "synth_raft.npy"
    ours, ref = np.load(ours), np.load(ref)
    # 60 frames at 25 fps -> 6 at 2.5 fps -> 5 pairs (windows of 4 and 1)
    assert ours.shape == ref.shape == (5, 2, 100, 133)
    np.testing.assert_allclose(ours, ref, atol=EXTRACT_FLOW_RTOL * np.abs(ref).max(), rtol=0)


def test_i3d_raft_flow_stream_matches_jax_pieces():
    """One 3-frame stack at 256x341 through I3D's RAFT flow stream against
    the JAX package's own pieces: the flow stays at the padded 256x344
    into the crop, whose column offset is 60 there (59 of the image).
    I3D's last pool needs 10 flow frames, so on both sides the stack's 2
    cropped flows are repeated 5 times before the I3D."""
    rng = np.random.RandomState(6)
    raft_model = seeded_raft(seed=7, iters=2)
    i3d_model = i3d_init(I3D(2), seed=8).eval()
    stack = rng.uniform(0, 255, (1, 3, 256, 341, 3)).astype(np.float32)

    ex = ExtractI3D(ExtractionConfig(feature_type="i3d", flow_type="raft", cpu=True,
                                     video_paths=[__file__]))
    with torch.inference_mode():
        flow = ex.flow({"raft": raft_model}, torch.from_numpy(stack))
        ours_in = flow_chain(flow)
        ours_feats, _ = i3d_model(ours_in.repeat(1, 5, 1, 1, 1))
    assert flow.shape == (1, 2, 256, 344, 2)

    (l, r, t, b) = JaxInputPadder((256, 341))._pad
    assert (l, r, t, b) == (1, 2, 0, 0)
    padded = jnp.pad(jnp.asarray(stack), ((0, 0), (0, 0), (t, b), (l, r), (0, 0)), mode="edge")
    jax_raft = jax_model.build(iters=2)
    raft_params = jax_convert.convert_state_dict(_numpy_sd(raft_model))
    ref_flow = jax.jit(jax.vmap(lambda s: jax_raft.apply({"params": raft_params}, s)))(padded)
    ref_in = np.asarray(jax_flow_chain(ref_flow))
    ref_feats, _ = jax.jit(jax_i3d.build().apply)(
        {"params": jax_i3d_convert.convert_state_dict(_numpy_sd(i3d_model))},
        jnp.asarray(np.tile(ref_in, (1, 5, 1, 1, 1))))

    ours_in = ours_in.numpy()
    assert np.abs(ours_in - ref_in).max() <= 2.0 / 255.0 + 1e-6
    assert (np.abs(ours_in - ref_in) > 1e-6).mean() <= LEVEL_FLIP_SHARE
    # a crop of the unpadded flow (one column to the left) would not pass
    wrong = flow_chain(flow[:, :, :, l : flow.shape[3] - r]).numpy()
    assert (np.abs(wrong - ref_in) > 1e-6).mean() > 100 * LEVEL_FLIP_SHARE
    ref_feats = np.asarray(ref_feats)
    tol = FLOW_FEATURE_RTOL * np.abs(ref_feats).max()
    np.testing.assert_allclose(ours_feats.numpy(), ref_feats, atol=tol, rtol=0)


@pytest.mark.parametrize("kw", [dict(flow_type="raft"), dict(flow_type="raft", streams=["flow"])])
def test_raft_flow_type_is_admitted(kw):
    assert sanity_check(ExtractionConfig(feature_type="i3d", **kw)).flow_type == "raft"
