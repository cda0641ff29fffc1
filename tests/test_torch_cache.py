"""The port's content-addressed feature cache (``extract/cache.py``) and
shared-decode fan-out (``extract/plan.py``, ``--feature_types``) against
the JAX package's.

``content_hash`` is the JAX package's byte for byte in both modes; the
config digest is salted with the package name, so a JAX-written entry is
a miss for the port, and holds the device kind, so a ``--cpu`` entry is a
miss on the card. The frame cache replays the direct decode bit for
bit, and through the CLI a CLIP + ResNet fan-out decodes each clip once
and writes what the single-model runs write; a repeat batch run with
``--cache_dir`` is 8 ``cache_hit`` records with byte-equal files.
"""

import dataclasses
import glob
import io
import json
import os

import numpy as np
import pytest
import torch

from video_features_tpu.config import ExtractionConfig as JaxConfig
from video_features_tpu.extract import cache as jax_cache
from video_features_tpu.extract.plan import SharedFrameCache as JaxFrameCache
from video_features_tpu.io import video as jax_video
from video_features_tpu_torch import cli
from video_features_tpu_torch.config import ExtractionConfig, parse_batch_args
from video_features_tpu_torch.extract import cache, plan
from video_features_tpu_torch.io import video
from video_features_tpu_torch.models.clip import model as port_model
from video_features_tpu_torch.runtime.faults import iter_manifest_records
from video_features_tpu_torch.utils.synth import synth_video

from test_torch_clip import SMALL
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.cache

FT = "CLIP-ViT-B/32"


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("cache_media")
    return [synth_video(str(d / f"c{i}.mp4"), n_frames=12, width=64, height=48, seed=i)
            for i in range(3)]


@pytest.fixture
def small_tower(monkeypatch):
    monkeypatch.setitem(port_model.CONFIGS, FT, port_model.CLIPVisionConfig(**SMALL))


@pytest.mark.parametrize("mode", cache.HASH_MODES)
@pytest.mark.parametrize("size", [100, (1 << 20) + 7, 5 << 20])
def test_content_hash_is_the_jax_packages(tmp_path, mode, size):
    path = tmp_path / "blob.bin"
    path.write_bytes(np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes())
    assert cache.content_hash(str(path), mode) == jax_cache.content_hash(str(path), mode)


def test_a_jax_entry_is_a_miss_for_the_port(tmp_path, clips):
    out = tmp_path / "feat.npy"
    np.save(out, np.ones((3, 4), np.float32))
    fields = {f.name for f in dataclasses.fields(ExtractionConfig)}
    jcfg = JaxConfig(feature_type=FT, extract_method="uni_3", on_extraction="save_numpy")
    pcfg = ExtractionConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})
    assert cache.config_digest(pcfg) != jax_cache.config_digest(jcfg)
    root = str(tmp_path / "shared")
    chash = jax_cache.content_hash(clips[0])
    jstore = jax_cache.FeatureCache(root)
    assert jstore.publish(chash, jax_cache.config_digest(jcfg), {FT: str(out)}, FT)
    store = cache.FeatureCache(root)
    assert store.content_hash(clips[0]) == chash
    assert store.lookup(chash, cache.config_digest(pcfg), [FT]) is None
    # the port's own entry hits, and a torn payload is a miss
    assert store.publish(chash, cache.config_digest(pcfg), {FT: str(out)}, FT)
    got = store.lookup(chash, cache.config_digest(pcfg), [FT])
    assert got is not None and np.array_equal(np.load(got[FT]), np.load(out))
    with open(got[FT], "wb") as fh:
        fh.write(b"torn")
    assert store.lookup(chash, cache.config_digest(pcfg), [FT]) is None
    assert cache.feature_keys_for(pcfg.replace(feature_type="i3d")) == ["rgb", "flow"]


def test_a_cpu_entry_is_a_miss_on_the_card(tmp_path, clips):
    out = tmp_path / "feat.npy"
    np.save(out, np.ones((3, 4), np.float32))
    cpu_cfg = ExtractionConfig(feature_type=FT, extract_method="uni_3", cpu=True)
    card_cfg = cpu_cfg.replace(cpu=False)
    assert cache.config_digest(cpu_cfg) != cache.config_digest(card_cfg)
    store = cache.FeatureCache(str(tmp_path / "shared"))
    chash = store.content_hash(clips[0])
    assert store.publish(chash, cache.config_digest(cpu_cfg), {FT: str(out)}, FT)
    assert store.lookup(chash, cache.config_digest(cpu_cfg), [FT]) is not None
    assert store.lookup(chash, cache.config_digest(card_cfg), [FT]) is None


def test_frame_cache_replays_the_direct_decode(clips):
    path = clips[0]
    direct = (list(video.stream_frames(path, 7.0)), video.extract_frames(path, "uni_5"),
              video.read_frames_at_indices(path, [0, 3, 11, 40]), video.probe(path))
    fc = plan.SharedFrameCache(64 << 20)
    video.set_frame_cache(fc)
    try:
        cached = (list(video.stream_frames(path, 7.0)), video.extract_frames(path, "uni_5"),
                  video.read_frames_at_indices(path, [0, 3, 11, 40]), video.probe(path))
    finally:
        video.set_frame_cache(None)
    assert fc.stats()["populated"] == 1 and fc.stats()["hits"] == 4
    (s0, e0, r0, p0), (s1, e1, r1, p1) = direct, cached
    assert [t for _, t in s0] == [t for _, t in s1]
    assert all(np.array_equal(a, b) for (a, _), (b, _) in zip(s0, s1))
    assert e0[1:] == e1[1:] and all(np.array_equal(a, b) for a, b in zip(e0[0], e1[0]))
    assert sorted(r0) == sorted(r1) and all(np.array_equal(r0[k], r1[k]) for k in r0)
    assert p0 == p1
    # the JAX package's frame cache over its own cv2 decode holds the same frames
    jfc = JaxFrameCache(64 << 20)
    jax_video.set_frame_cache(jfc)
    try:
        ref = list(jax_video.stream_frames(path, 7.0, "cv2"))
    finally:
        jax_video.set_frame_cache(None)
    assert all(np.array_equal(a, b) for (a, _), (b, _) in zip(s1, ref)) and len(s1) == len(ref)


def _run(tmp_path, name, *args):
    out = str(tmp_path / name)
    cli.main([*args, "--cpu", "--allow_random_init", "--on_extraction", "save_numpy",
              "--output_path", out, "--tmp_path", str(tmp_path / "tmp")])
    files = sorted(glob.glob(os.path.join(out, "**", "*.npy"), recursive=True))
    return out, {os.path.relpath(f, out): open(f, "rb").read() for f in files}


def test_batch_cache_repeat_is_all_hits(tmp_path, clips, small_tower):
    args = ["--feature_type", FT, "--extract_method", "uni_3", "--attn", "flash",
            "--cache_dir", str(tmp_path / "cache"), "--video_paths", *clips]
    _, first = _run(tmp_path, "a", *args)
    out, second = _run(tmp_path, "b", *args)
    assert len(first) == len(clips) and first == second
    notes = [r.get("note") for r in iter_manifest_records(out) if r.get("status") == "done"]
    assert notes == ["cache_hit"] * len(clips)
    with open(os.path.join(out, "_manifest", "summary.json")) as fh:
        assert json.load(fh)["done"] == len(clips)


def test_fan_out_decodes_once_and_matches_single_runs(tmp_path, clips, small_tower, monkeypatch):
    seen = []
    make = plan.cache_for

    def spy(cfg, fts):
        fc = make(cfg, fts)
        seen.append(fc)
        return fc

    monkeypatch.setattr(plan, "cache_for", spy)
    common = ["--extract_method", "uni_3", "--extraction_fps", "4", "--batch_size", "4",
              "--video_paths", clips[1]]
    _, both = _run(tmp_path, "both", "--feature_types", FT, "resnet18", *common)
    (fc,) = seen
    assert fc.stats()["populated"] == 1 and fc.stats()["clips"] == 1
    _, clip_only = _run(tmp_path, "clip", "--feature_type", FT, *common)
    _, resnet_only = _run(tmp_path, "resnet", "--feature_type", "resnet18", *common)
    assert sorted(both) == sorted({**clip_only, **resnet_only})
    for name, blob in {**clip_only, **resnet_only}.items():
        assert blob == both[name], name
    cfg, fts = parse_batch_args(["--feature_types", FT, "resnet18", FT])
    assert fts == [FT, "resnet18"] and cfg.feature_type == FT
    with pytest.raises(SystemExit):
        parse_batch_args(["--video_paths", clips[0]])
    # the in-process API: one call, both models, the same features
    got = plan.run_multi(cfg.replace(video_paths=[clips[1]], extraction_fps=4.0, batch_size=4,
                                     extract_method="uni_3", allow_random_init=True),
                         [FT, "resnet18"], external_call=True, device=torch.device("cpu"))
    assert sorted(got) == sorted([FT, "resnet18"]) and seen[-1].stats()["populated"] == 1
    for ft, name in ((FT, "c1_CLIP-ViT-B-32.npy"), ("resnet18", "c1_resnet18.npy")):
        ((ours,),) = [got[ft]]
        ref = next(np.frombuffer(b, np.uint8) for n, b in both.items() if n.endswith(name))
        assert np.array_equal(np.load(io.BytesIO(ref.tobytes())), ours[ft])
