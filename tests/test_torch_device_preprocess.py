"""``--preprocess device``'s ops in the port against the JAX package.

The taps and buckets are numpy in both packages and must be equal
(``np.array_equal``). The torch resample (``device_resize_frames``,
``device_preprocess_frames``) is held to the JAX functions on the same
seeded uint8 frames in its three tap layouts (one video, a fused group of
two source resolutions in one bucket, per-row taps): both accumulate the
taps in one order in fp32, so the tolerance is at most one uint8 level
(1/255/min(std) after the normalize) on at most 1e-3 of the values, and
identity taps match exactly. The frame-delta helpers and the flags'
checks give the JAX package's results.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_features_tpu import config as jax_config
from video_features_tpu.ops import preprocess as jax_pre
from video_features_tpu.ops import resize as jax_resize
from video_features_tpu.ops import sampler as jax_sampler
from video_features_tpu.ops import window as jax_window
from video_features_tpu_torch import config as port_config
from video_features_tpu_torch.ops import preprocess as port_pre
from video_features_tpu_torch.ops import resize as port_resize
from video_features_tpu_torch.ops import sampler as port_sampler
from video_features_tpu_torch.ops import window as port_window

RNG = np.random.RandomState(11)
# one uint8 level, in [0, 255] units and after each chain's normalize
LEVEL = 1.0
MAX_SHARE = 1e-3


@pytest.mark.parametrize("hw,multiple,buckets", [
    ((240, 320), 64, None), ((232, 420), 64, None), ((1, 1), 64, None),
    ((360, 640), 32, None), ((240, 426), 64, [(256, 448), (512, 512)]),
    ((600, 600), 64, [(256, 448)]),
])
def test_spatial_bucket_matches_jax(hw, multiple, buckets):
    assert (port_window.spatial_bucket(*hw, multiple, buckets)
            == jax_window.spatial_bucket(*hw, multiple, buckets))


@pytest.mark.parametrize("ohw,multiple", [((256, 341), 64), ((96, 100), 8), ((256, 455), 64),
                                           ((100, 60), 64)])
def test_flow_output_bucket_and_pad_hw_match_jax(ohw, multiple):
    assert (port_window.flow_output_bucket(*ohw, multiple=multiple)
            == jax_window.flow_output_bucket(*ohw, multiple=multiple))
    x = RNG.randint(0, 256, (2, 3) + ohw + (3,)).astype(np.uint8)
    bh, bw = port_window.spatial_bucket(*ohw)
    np.testing.assert_array_equal(port_window.pad_hw(x, bh, bw), jax_window.pad_hw(x, bh, bw))


# (h, w, resize_to, crop, method, crop_offset): a downscale, an upscale
# below the crop (zero-pad rows and columns), odd-parity resized edges
# (where the two crop offsets differ by one) and a square no-op resize
FUSED_CASES = [
    (360, 640, 224, 224, "bicubic", "round"),
    (240, 320, 256, 224, "bilinear", "round"),
    (240, 320, 256, 224, "bilinear", "floor"),
    (241, 319, 256, 224, "bilinear", "floor"),
    (241, 319, 256, 224, "bilinear", "round"),
    (100, 120, 64, 80, "bicubic", "round"),
    (90, 101, 64, 80, "bilinear", "floor"),
    (224, 224, 224, 224, "bicubic", "round"),
]


@pytest.mark.parametrize("case", FUSED_CASES, ids=lambda c: "-".join(map(str, c)))
def test_fused_resize_crop_banded_matches_jax(case):
    h, w, resize_to, crop, method, offset = case
    bh, bw = jax_window.spatial_bucket(h, w)
    args = (h, w, resize_to, crop, method, bh, bw, offset)
    got, want = port_resize.fused_resize_crop_banded(*args), jax_resize.fused_resize_crop_banded(*args)
    assert len(got) == len(want) == 4
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype and np.array_equal(g, w_)


# (h, w, resize_to, out_h, out_w, top, left, pad_mode, smaller_edge): the
# identity band (no --side_size) on RAFT's padder grid and on PWC's exact
# grid, a --side_size downscale and a larger-edge one, an upscale, both
# pad modes, and I3D's min-edge-256 onto an output bucket
CONTRACT_CASES = [
    (96, 100, 0, 128, 128, 16, 14, "edge", True),
    (250, 330, 0, 256, 336, 3, 3, "edge", True),
    (240, 320, 0, 240, 320, 0, 0, "edge", True),
    (240, 320, 48, 48, 64, 0, 0, "edge", True),
    (240, 320, 100, 128, 136, 26, 2, "edge", False),
    (240, 320, 100, 128, 136, 26, 2, "zero", False),
    (60, 80, 100, 104, 136, 2, 1, "zero", True),
    (241, 319, 256, 256, 384, 0, 21, "edge", True),
]


@pytest.mark.parametrize("case", CONTRACT_CASES, ids=lambda c: "-".join(map(str, c)))
def test_shape_contract_banded_matches_jax(case):
    h, w, resize_to, out_h, out_w, top, left, pad_mode, smaller = case
    bh, bw = jax_window.spatial_bucket(h, w)
    if resize_to:
        oh, ow = jax_resize.resized_hw(h, w, resize_to, smaller)
        assert top + oh <= out_h and left + ow <= out_w
    args = (h, w, resize_to, out_h, out_w, top, left, "bilinear", bh, bw, pad_mode, smaller)
    got, want = port_resize.shape_contract_banded(*args), jax_resize.shape_contract_banded(*args)
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype and np.array_equal(g, w_)


def test_taps_builders_give_concurrent_callers_one_set_of_arrays():
    """Decode workers preparing two videos of one resolution at once must
    get the same host arrays, which the extractors place once per set
    (``BaseExtractor._device_taps`` keys by the arrays). Twelve threads
    released together ask for sizes no earlier call has built."""
    import sys
    import threading

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for k, (build, args) in enumerate([
                (port_resize.fused_resize_crop_banded, (237, 311, 256, 224, "bilinear")),
                (port_resize.shape_contract_banded,
                 (229, 307, 256, 256, 343, 0, 0, "bilinear"))]):
            gate, got = threading.Barrier(12), []

            def ask():
                gate.wait(timeout=30)
                got.append(build(*args, pad_h=240, pad_w=320))

            threads = [threading.Thread(target=ask) for _ in range(12)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads) and len(got) == 12
            assert all(g is got[0] or all(a is b for a, b in zip(g, got[0])) for g in got), k
    finally:
        sys.setswitchinterval(switch)


def test_taps_refuse_what_jax_refuses():
    for mod in (port_resize, jax_resize):
        with pytest.raises(ValueError, match="crop_offset"):
            mod.fused_resize_crop_matrices.__wrapped__(10, 10, 8, 8, "bilinear", crop_offset="x")
        with pytest.raises(ValueError, match="output contract"):
            mod.shape_contract_matrices.__wrapped__(240, 320, 0, 200, 320)
        with pytest.raises(ValueError, match="pad_mode"):
            mod.shape_contract_matrices.__wrapped__(24, 32, 0, 24, 32, pad_mode="reflect")


def _port_taps(pair):
    wt, idx = pair
    return torch.from_numpy(np.array(wt)), torch.from_numpy(idx.astype(np.int64))


def _fused_taps(h, w, bucket, resize_to=64, crop=56, method="bicubic"):
    wt_y, idx_y, wt_x, idx_x = port_resize.fused_resize_crop_banded(
        h, w, resize_to, crop, method, *bucket)
    return (wt_y, idx_y), (wt_x, idx_x)


def _layout(name):
    """(uint8 frames, wy, wx) of one layout: two source resolutions that
    share the (128, 192) bucket, each with its taps."""
    bucket = (128, 192)
    taps = [_fused_taps(120, 180, bucket), _fused_taps(100, 150, bucket)]
    frames = RNG.randint(0, 256, (2, 3) + bucket + (3,)).astype(np.uint8)
    stack = lambda pairs: tuple(np.stack(a) for a in zip(*pairs))  # noqa: E731
    if name == "solo":
        return frames[0], taps[0][0], taps[0][1]
    if name == "group":
        return frames, stack([t[0] for t in taps]), stack([t[1] for t in taps])
    rows = frames.reshape((-1,) + frames.shape[2:])  # 6 rows, 3 of each video
    ids = [0, 0, 0, 1, 1, 1]
    return rows, stack([taps[i][0] for i in ids]), stack([taps[i][1] for i in ids])


def _within_a_level(got, want, level):
    diff = np.abs(got - want)
    assert diff.max() <= level + 1e-4, diff.max()
    assert (diff > 1e-4).mean() <= MAX_SHARE, (diff > 1e-4).mean()


@pytest.mark.parametrize("layout", ["solo", "group", "rows"])
def test_device_resize_frames_matches_jax(layout):
    frames, wy, wx = _layout(layout)
    got = port_pre.device_resize_frames(torch.from_numpy(frames), _port_taps(wy), _port_taps(wx))
    want = np.asarray(jax_pre.device_resize_frames(jnp.asarray(frames), wy, wx))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _within_a_level(got.numpy(), want, LEVEL)


@pytest.mark.parametrize("layout", ["solo", "group", "rows"])
def test_device_preprocess_frames_matches_jax(layout):
    frames, wy, wx = _layout(layout)
    mean, std = port_pre.CLIP_MEAN, port_pre.CLIP_STD
    got = port_pre.device_preprocess_frames(torch.from_numpy(frames), _port_taps(wy),
                                            _port_taps(wx), mean, std)
    want = np.asarray(jax_pre.device_preprocess_frames(jnp.asarray(frames), wy, wx, mean, std))
    assert got.shape == want.shape and got.is_contiguous()
    _within_a_level(got.numpy(), want, LEVEL / 255.0 / min(std))


def test_layouts_equal_the_solo_layout():
    """A group's and rows' taps give each video the output of its solo run."""
    frames, wy, wx = _layout("group")
    group = port_pre.device_resize_frames(torch.from_numpy(frames), _port_taps(wy),
                                          _port_taps(wx))
    for i in range(2):
        solo = port_pre.device_resize_frames(
            torch.from_numpy(frames[i]), _port_taps((wy[0][i], wy[1][i])),
            _port_taps((wx[0][i], wx[1][i])))
        assert torch.equal(group[i], solo)


@pytest.mark.parametrize("hw", [(96, 100), (250, 330)])
def test_identity_contract_is_exact(hw):
    """No --side_size: the taps are the identity band plus the padder's edge
    replication, and both packages give ``np.pad(mode="edge")`` exactly."""
    h, w = hw
    tgt_h, tgt_w = max(-(-h // 8) * 8, 128), max(-(-w // 8) * 8, 128)
    top, left = (tgt_h - h) // 2, (tgt_w - w) // 2
    bucket = port_window.spatial_bucket(h, w)
    wt_y, idx_y, wt_x, idx_x = port_resize.shape_contract_banded(
        h, w, 0, tgt_h, tgt_w, top, left, "bilinear", *bucket, "edge")
    raw = RNG.randint(0, 256, (3, h, w, 3)).astype(np.uint8)
    x = port_window.pad_hw(raw, *bucket)
    got = port_pre.device_resize_frames(torch.from_numpy(x), _port_taps((wt_y, idx_y)),
                                        _port_taps((wt_x, idx_x))).numpy()
    want = np.asarray(jax_pre.device_resize_frames(jnp.asarray(x), (wt_y, idx_y), (wt_x, idx_x)))
    host = np.pad(raw, [(0, 0), (top, tgt_h - h - top), (left, tgt_w - w - left), (0, 0)],
                  mode="edge").astype(np.float32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, host)


def test_dynamic_center_crop_matches_jax():
    x = RNG.rand(2, 40, 50, 2).astype(np.float32)
    got = port_pre.dynamic_center_crop(torch.from_numpy(x), 5, 9, 24)
    want = np.asarray(jax_pre.dynamic_center_crop(jnp.asarray(x), 5, 9, 24))
    np.testing.assert_array_equal(got.numpy(), want)


def _frames(kind):
    a = np.zeros((4, 4, 3), np.uint8)
    if kind == "static":
        return [a, a, a, a]
    if kind == "drift":  # +2 a frame: re-keys once the drift adds up
        return [np.full((4, 4, 3), v, np.uint8) for v in (0, 2, 4, 6, 8)]
    if kind == "cut":
        return [a, np.full((4, 4, 3), 200, np.uint8), a]
    return list(RNG.randint(0, 256, (6, 8, 8, 3)).astype(np.uint8))


@pytest.mark.parametrize("kind", ["static", "drift", "cut", "noise"])
@pytest.mark.parametrize("threshold", [0.0, 3.0, 5.0, 90.0])
def test_frame_delta_helpers_match_jax(kind, threshold):
    frames = _frames(kind)
    keep = port_sampler.frame_delta_keep_mask(frames, threshold)
    np.testing.assert_array_equal(keep, jax_sampler.frame_delta_keep_mask(frames, threshold))
    if threshold == 0.0:
        assert keep.all()  # threshold 0 keeps every frame
    rows = RNG.rand(int(keep.sum()), 5)
    np.testing.assert_array_equal(port_sampler.copy_forward(rows, keep),
                                  jax_sampler.copy_forward(rows, keep))


# JAX tests/test_device_preprocess.py::test_preprocess_flag_validation and
# tests/test_ingest.py's frame-delta cases, without the mesh ones:
# (fields, the match of the ValueError, or None when accepted)
FLAG_CASES = [
    (dict(feature_type="resnet18", preprocess="device"), None),
    (dict(feature_type="CLIP-ViT-B/32", extract_method="uni_4", preprocess="device"), None),
    (dict(feature_type="raft", preprocess="device"), None),
    (dict(feature_type="pwc", preprocess="device"), None),
    (dict(feature_type="i3d", preprocess="device"), None),
    (dict(feature_type="i3d", preprocess="device", flow_type="raft"), None),
    (dict(feature_type="resnet18", preprocess="nonsense"), "preprocess"),
    (dict(feature_type="vggish", preprocess="device"), "raft.*resnet18|resnet18.*raft"),
    (dict(feature_type="i3d", preprocess="device", flow_type="flow"), "flow"),
    (dict(feature_type="i3d", preprocess="device", flow_type="flow", streams=["rgb"]),
     "on-the-fly flow"),
    (dict(feature_type="raft", preprocess="device", show_pred=True), "show_pred"),
    (dict(feature_type="pwc", preprocess="device", show_pred=True), "show_pred"),
    (dict(feature_type="resnet18", spatial_bucket=0), "spatial_bucket"),
    (dict(feature_type="CLIP-ViT-B/32", extract_method="uni_4", frame_delta_threshold=2.0),
     None),
    (dict(feature_type="CLIP-ViT-B/32", extract_method="uni_4", frame_delta_threshold=-1.0),
     "frame_delta_threshold"),
    (dict(feature_type="resnet50", frame_delta_threshold=2.0), "frame-level"),
]


@pytest.mark.parametrize("fields,match", FLAG_CASES,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_sanity_check_matches_jax(fields, match, tmp_path):
    for mod in (port_config, jax_config):
        cfg = mod.ExtractionConfig(allow_random_init=True, cpu=True,
                                   output_path=str(tmp_path / "o"), tmp_path=str(tmp_path / "t"),
                                   **fields)
        if match is None:
            mod.sanity_check(cfg)
        else:
            with pytest.raises(ValueError, match=match):
                mod.sanity_check(cfg)


def test_cli_preprocess_flags_parse():
    cfg = port_config.parse_args([
        "--feature_type", "CLIP-ViT-B/32", "--extract_method", "uni_4", "--video_paths",
        "x.mp4", "--allow_random_init", "--cpu", "--preprocess", "device",
        "--spatial_bucket", "32", "--frame_delta_threshold", "2.5",
    ])
    assert (cfg.preprocess, cfg.spatial_bucket, cfg.frame_delta_threshold) == ("device", 32, 2.5)
    defaults = port_config.parse_args(["--feature_type", "resnet18", "--video_paths", "x.mp4"])
    assert (defaults.preprocess, defaults.spatial_bucket, defaults.frame_delta_threshold) == (
        "host", 64, None)
