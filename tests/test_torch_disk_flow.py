"""The port's flow read from disk (``--flow_type flow`` with
``--flow_paths`` or ``--video_dir``/``--flow_dir``) against the JAX
package's.

Tolerances:

- the path lists: equal, entry for entry;
- I3D on synthetic flow JPEGs (the inputs of the JAX package's
  ``tests/test_i3d.py::test_extract_i3d_precomputed_flow``: 70 random
  256x300 pairs), both streams, seeded weights through the JAX
  package's converter: 1e-5 on features of scale ~0.5 (the same uint8
  pixels on both sides, fp32 sums in other orders through ~60
  convolutions, as ``test_torch_i3d``'s full network); the ``--show_pred``
  lines equal as printed (3 decimals);
- the round trip, PWC ``save_jpg`` into I3D ``--flow_type flow``: within
  relative L2 0.05 of the on-the-fly PWC flow features, the JAX
  package's own budget for the uint8 quantization and JPEG at quality 95
  (``tests/test_i3d.py::test_flow_roundtrip_save_jpg_matches_on_the_fly``);
- the CLI: a (video, flow dir) pair is never cached under ``--cache_dir``,
  and ``--resume`` keys the pair by its video's stem.
"""

import contextlib
import glob
import io
import os
import pathlib
import types

import cv2
import numpy as np
import pytest
import torch

from video_features_tpu.config import ExtractionConfig as JaxConfig
from video_features_tpu.extract.base import BaseExtractor as JaxBaseExtractor
from video_features_tpu.io import paths as jax_paths
from video_features_tpu.models.i3d import convert as jax_i3d_convert
from video_features_tpu.models.i3d.extract_i3d import ExtractI3D as JaxExtractI3D
from video_features_tpu_torch import cli
from video_features_tpu_torch.config import ExtractionConfig
from video_features_tpu_torch.extract.base import BaseExtractor
from video_features_tpu_torch.io import paths
from video_features_tpu_torch.models.i3d.extract_i3d import ExtractI3D
from video_features_tpu_torch.runtime.faults import iter_manifest_records
from video_features_tpu_torch.utils.synth import synth_video

from test_torch_i3d import _numpy_sd, seeded_i3d
from torch_threads import one_torch_thread  # noqa: F401 - an autouse fixture

ATOL = 1e-5
ROUND_TRIP_RTOL = 0.05
# 65 sampled frames (the 60-frame clip upsampled) zipped with 70 flow
# pairs: windows of 16 every 48 -> 2 stacks, one group of 2
DISK = dict(stack_size=16, step_size=48, batch_size=2)


@pytest.fixture(scope="module")
def flow_dir(sample_video, tmp_path_factory):
    """70 random flow_x/flow_y pairs in a dir named by the clip's stem."""
    d = tmp_path_factory.mktemp("flow") / pathlib.Path(sample_video).stem
    d.mkdir()
    rng = np.random.RandomState(0)
    for i in range(70):
        for axis in ("x", "y"):
            img = rng.randint(0, 256, size=(256, 300), dtype=np.uint8)
            cv2.imwrite(str(d / f"flow_{axis}_{i:05d}.jpg"), img)
    return str(d)


@pytest.fixture(scope="module")
def both_runs(sample_video, flow_dir, tmp_path_factory):
    """Both packages' I3D, both streams, on the clip and its flow dir with
    ``--show_pred``: {package: (features, printed text)}."""
    root = tmp_path_factory.mktemp("disk_i3d")
    models = {"rgb": seeded_i3d(3, seed=6), "flow": seeded_i3d(2, seed=7)}
    weights = root / "weights"
    weights.mkdir()
    for kind in ("rgb", "flow"):
        torch.save(models[kind].state_dict(), weights / f"i3d_{kind}.pt")
    common = dict(feature_type="i3d", flow_type="flow", video_paths=[sample_video],
                  flow_paths=[flow_dir], show_pred=True, cpu=True,
                  output_path=str(root / "out"), tmp_path=str(root / "tmp"), **DISK)
    out = {}
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        (feats,) = ExtractI3D(ExtractionConfig(weights_path=str(weights), **common),
                              external_call=True)()
    out["port"] = (feats, text.getvalue())
    jax_ex = JaxExtractI3D(JaxConfig(decoder="cv2", **common), external_call=True)
    jax_ex._host_params = {k: jax_i3d_convert.convert_state_dict(_numpy_sd(m))
                           for k, m in models.items()}
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        (feats,) = jax_ex([0])
    out["jax"] = (feats, text.getvalue())
    return out


@pytest.fixture
def input_tree(tmp_path):
    """videos/{a,b,c}.mp4 and flows/{a,b,d}/: c and d pair by position only."""
    vids, flows = tmp_path / "videos", tmp_path / "flows"
    vids.mkdir()
    flows.mkdir()
    for stem in "abc":
        (vids / f"{stem}.mp4").write_bytes(b"")
    for stem in "abd":
        (flows / stem).mkdir()
    listing = tmp_path / "list.txt"
    listing.write_text(f"{vids / 'b.mp4'}\n\n{vids / 'a.mp4'}\n")
    return vids, flows, listing


def _selection(vids, flows, listing, case):
    v = [str(vids / f"{s}.mp4") for s in "abc"]
    f = [str(flows / s) for s in "abd"]
    return {
        "video_dir": dict(video_dir=str(vids)),
        "video_dir+flow_dir": dict(video_dir=str(vids), flow_dir=str(flows)),
        "video_paths": dict(video_paths=v),
        "video_paths+flow_paths": dict(video_paths=v, flow_paths=f),
        "file_first": dict(file_with_video_paths=str(listing), video_dir=str(vids),
                           video_paths=v),
        "dir_before_paths": dict(video_dir=str(vids), flow_dir=str(flows), video_paths=v[:1]),
        "missing_flow": dict(video_paths=v[:1], flow_paths=[str(flows / "a" / "nope")]),
        "missing_video": dict(video_paths=[str(vids / "nope.mp4")]),
        "nothing": dict(),
    }[case]


@pytest.mark.parametrize("case", ["video_dir", "video_dir+flow_dir", "video_paths",
                                  "video_paths+flow_paths", "file_first", "dir_before_paths",
                                  "missing_flow", "missing_video", "nothing"])
def test_path_list_matches_jax(case, input_tree):
    fields = dict(file_with_video_paths=None, video_dir=None, flow_dir=None, video_paths=None,
                  flow_paths=None)
    fields.update(_selection(*input_tree, case))
    cfg = types.SimpleNamespace(**fields)
    try:
        ref = jax_paths.form_list_from_user_input(cfg)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(":")[0]):
            paths.form_list_from_user_input(cfg)
        return
    ours = paths.form_list_from_user_input(cfg)
    assert ours == ref
    if case.endswith("flow_paths") or case.endswith("flow_dir"):
        # the mismatched stem (c against d) is dropped
        assert [pathlib.Path(v).stem for v, _ in ours] == ["a", "b"]


def test_flow_pairs_load_in_numeric_order_and_check_pairs(tmp_path):
    d = tmp_path / "f"
    d.mkdir()
    for i in (1, 2, 10):
        for axis in "xy":
            cv2.imwrite(str(d / f"flow_{axis}_{i}.jpg"), np.zeros((4, 4), np.uint8))
    cfg = dict(feature_type="i3d", flow_type="flow", video_paths=[str(d)], cpu=True)
    ex = ExtractI3D(ExtractionConfig(**cfg), external_call=True)
    ref = JaxExtractI3D(JaxConfig(decoder="cv2", **cfg), external_call=True)
    ours = ex._load_flow_pairs(str(d))
    assert ours == ref._load_flow_pairs(str(d))
    assert [x.name for x, _ in ours] == ["flow_x_1.jpg", "flow_x_2.jpg", "flow_x_10.jpg"]
    os.remove(d / "flow_y_2.jpg")
    cv2.imwrite(str(d / "flow_y_3.jpg"), np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError, match="flow pair mismatch"):
        ex._load_flow_pairs(str(d))
    os.remove(d / "flow_y_3.jpg")
    with pytest.raises(ValueError, match="2 flow_y"):
        ex._load_flow_pairs(str(d))
    with pytest.raises(ValueError, match="needs \\(video, flow_dir\\) pairs"):
        ex.prepare(str(d))


def test_i3d_disk_flow_matches_jax(both_runs):
    ours, ref = both_runs["port"][0], both_runs["jax"][0]
    for stream in ("rgb", "flow"):
        assert ours[stream].shape == ref[stream].shape == (2, 1024)
        np.testing.assert_allclose(ours[stream], ref[stream], atol=ATOL, rtol=0)
    np.testing.assert_allclose(ours["timestamps_ms"], ref["timestamps_ms"])
    assert float(ours["fps"]) == float(ref["fps"])


def test_i3d_show_pred_prints_the_jax_lines(both_runs, sample_video):
    ours = [ln for ln in both_runs["port"][1].splitlines() if "WARNING" not in ln]
    ref = [ln for ln in both_runs["jax"][1].splitlines() if "WARNING" not in ln]
    assert ours == ref
    heads = [ln for ln in ours if " @ stack " in ln]
    # one group of 2 stacks: stream by stream, stack by stack within it
    assert heads == [f"{sample_video} @ stack {i} ({s} stream)"
                     for s in ("rgb", "flow") for i in (0, 1)]
    assert len(ours) == len(heads) * 7  # a head, 5 classes and a blank line each


def test_disk_flow_images_stay_fp32_under_bfloat16(sample_video, flow_dir):
    ex = ExtractI3D(ExtractionConfig(feature_type="i3d", flow_type="flow", dtype="bfloat16",
                                     video_paths=[sample_video], flow_paths=[flow_dir],
                                     cpu=True), external_call=True)
    imgs = ex._read_flow_images(flow_dir)
    assert imgs.dtype == np.float32 and imgs.shape == (70, 256, 300, 2)
    np.testing.assert_array_equal(imgs[0, ..., 0], cv2.imread(
        os.path.join(flow_dir, "flow_x_00000.jpg"), cv2.IMREAD_GRAYSCALE))


def test_round_trip_save_jpg_into_i3d(tmp_path):
    """PWC writes its flow as JPEGs (``save_jpg``) and I3D reads them back
    (``--flow_type flow``): within the JAX package's budget of the same
    I3D on the on-the-fly PWC flow. 65 frames of 128x128 upscale to
    256x256 on both paths; seeded random weights, the same on both."""
    video = synth_video(str(tmp_path / "rt.mp4"), n_frames=65, width=128, height=128)
    cli.main(["--feature_type", "pwc", "--cpu", "--allow_random_init", "--video_paths", video,
              "--batch_size", "8", "--side_size", "256", "--on_extraction", "save_jpg",
              "--output_path", str(tmp_path / "jpg"), "--tmp_path", str(tmp_path / "tmp")])
    flows = tmp_path / "jpg" / "pwc" / "rt"
    assert len(list(flows.glob("flow_x_*.jpg"))) == len(list(flows.glob("flow_y_*.jpg"))) == 64
    common = dict(feature_type="i3d", streams=["flow"], stack_size=10, step_size=30,
                  allow_random_init=True, cpu=True, video_paths=[video])
    (fly,) = ExtractI3D(ExtractionConfig(flow_type="pwc", **common), external_call=True)()
    (disk,) = ExtractI3D(ExtractionConfig(flow_type="flow", flow_paths=[str(flows)], **common),
                         external_call=True)()
    assert fly["flow"].shape == disk["flow"].shape == (2, 1024)
    rel = np.linalg.norm(fly["flow"] - disk["flow"]) / np.linalg.norm(fly["flow"])
    assert rel < ROUND_TRIP_RTOL, rel


@pytest.mark.parametrize("entry", ["v.mp4", ("v.mp4", "flows/v"), ("v.mp4", ""), ["v.mp4"]])
def test_cacheable_entry_matches_jax(entry):
    assert BaseExtractor._cacheable_entry(entry) == JaxBaseExtractor._cacheable_entry(None, entry)


def test_cli_pairs_skip_the_cache_and_resume_by_stem(sample_video, flow_dir, tmp_path):
    """The CLI routes (video, flow dir) pairs through the run manifest (keyed
    by the video), ``--resume`` (the video stem's output files) and
    ``--cache_dir``, which never stores or serves a pair."""
    out = str(tmp_path / "out")
    args = ["--feature_type", "i3d", "--flow_type", "flow", "--streams", "flow",
            "--stack_size", "10", "--step_size", "30", "--cpu", "--allow_random_init",
            "--video_paths", sample_video, "--flow_paths", flow_dir,
            "--cache_dir", str(tmp_path / "cache"), "--on_extraction", "save_numpy",
            "--output_path", out, "--tmp_path", str(tmp_path / "tmp")]
    for _ in range(2):
        cli.main(args)
    (saved,) = glob.glob(os.path.join(out, "i3d", "*.npy"))
    assert os.path.basename(saved) == "synth_flow.npy" and np.load(saved).shape == (2, 1024)
    done = [r for r in iter_manifest_records(out) if r.get("status") == "done"]
    assert [r["video"] for r in done] == [sample_video] * 2
    assert not [r for r in done if r.get("note") == "cache_hit"]
    assert not glob.glob(os.path.join(str(tmp_path / "cache"), "**", "*.npy"), recursive=True)
    cli.main(args + ["--resume"])
    skipped = [r for r in iter_manifest_records(out) if r.get("status") == "skipped"]
    assert [r["video"] for r in skipped] == [sample_video]
