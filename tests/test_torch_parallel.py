"""The port's ``parallel/`` against the JAX package's.

- ``resolve_devices``: ids, ``--cpu``, repeats kept, the out-of-range and
  no-CUDA messages (a two-card host is mocked);
- queue mode with a fake extractor on CPU "devices": every index once, a
  death re-queued, all dead raises, the retry cap, the chunk rule, the
  ``WORLD_SIZE``/``RANK`` stride; then the tiny CLIP through it on three;
- the concurrency repairs: one build per device under the lock, exact
  launch counts from many threads;
- ``make_mesh`` and the tensor-parallel cut; the sharded CLIP forward
  (TP, DP x TP, context parallel) against JAX ``build_sharded_apply`` on
  the 8 virtual CPU devices of ``conftest.py`` with one set of weights,
  biases and LayerNorm weights nonzero, and against the port's unsharded
  forward; the extractor on a mesh of CPU devices;
- every mesh and config refusal's message equal to the JAX package's.

The tiny CLIP is ``tests/test_parallel.py``'s: patch 16, width 64, 2
layers, 2 heads, embed 32, 32 px (5 tokens).
"""

import pathlib
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_features_tpu.config import ExtractionConfig as JaxConfig
from video_features_tpu.config import sanity_check as jax_sanity_check
from video_features_tpu.models.clip import convert as jax_convert
from video_features_tpu.models.clip import model as jax_model
from video_features_tpu.parallel import scheduler as jax_scheduler
from video_features_tpu.parallel import sharding as jax_sharding
from video_features_tpu_torch import cli
from video_features_tpu_torch.config import ExtractionConfig, parse_args, sanity_check
from video_features_tpu_torch.extract.base import BaseExtractor
from video_features_tpu_torch.models.clip import model as port_model
from video_features_tpu_torch.models.clip.convert import convert_state_dict
from video_features_tpu_torch.models.clip.extract_clip import ExtractCLIP
from video_features_tpu_torch.ops import kernels
from video_features_tpu_torch.parallel import devices as port_devices
from video_features_tpu_torch.parallel import scheduler, sharding
from video_features_tpu_torch.parallel.devices import resolve_devices
from video_features_tpu_torch.runtime import faults
from video_features_tpu_torch.utils.synth import synth_video

from torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
FT = "CLIP-ViT-B/32"
TINY = dict(patch_size=16, width=64, layers=2, heads=2, embed_dim=32, image_size=32)
ATOL = 1e-5


def _cpus(n):
    return [CPU] * n


# --- resolve_devices ------------------------------------------------------------

@pytest.fixture
def two_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)


def test_resolve_devices_ids_repeats_and_cpu(two_cards):
    cuda = [torch.device("cuda", i) for i in range(2)]
    assert resolve_devices(ExtractionConfig()) == cuda
    assert resolve_devices(ExtractionConfig(device_ids=[1, 0])) == cuda[::-1]
    assert resolve_devices(device_ids=[0, 0, 1]) == [cuda[0], cuda[0], cuda[1]]
    assert resolve_devices(ExtractionConfig(cpu=True, device_ids=[5])) == [CPU]
    assert resolve_devices(cpu=True) == [CPU]


def test_resolve_devices_out_of_range_message(two_cards):
    with pytest.raises(ValueError) as ours:
        resolve_devices(ExtractionConfig(device_ids=[0, 5, -1]))
    visible = [str(d) for d in (torch.device("cuda", 0), torch.device("cuda", 1))]
    assert str(ours.value) == f"device_ids [5, -1] out of range: only 2 devices visible ({visible})"
    # the JAX package's message, over its 8 virtual devices
    from video_features_tpu.parallel.devices import resolve_devices as jax_resolve

    with pytest.raises(ValueError) as ref:
        jax_resolve(JaxConfig(device_ids=[0, 9, -1]))
    jax_visible = [str(d) for d in jax.devices()]
    assert str(ref.value) == f"device_ids [9, -1] out of range: only 8 devices visible ({jax_visible})"


def test_resolve_devices_without_cuda_and_mesh_under_a_launcher(two_cards, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    # queue: rank 0 (no RANK set) of two drives its own card only
    assert resolve_devices(ExtractionConfig()) == [torch.device("cuda", 0)]
    # mesh: the same share, this process's rows of the global mesh
    assert resolve_devices(ExtractionConfig(sharding="mesh")) == [torch.device("cuda", 0)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is visible; pass --cpu"):
        resolve_devices(ExtractionConfig(device_ids=[0]))


@pytest.mark.parametrize("cards,procs,want", [
    (4, 4, [[0], [1], [2], [3]]),
    (4, 2, [[0, 2], [1, 3]]),
    (2, 4, [[0], [1], [0], [1]]),
    (1, 4, [[0], [0], [0], [0]]),
], ids=["one-per-card", "two-cards-each", "two-per-card", "one-visible-each"])
def test_resolve_devices_splits_the_host_between_launched_processes(monkeypatch, cards, procs,
                                                                    want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setenv("WORLD_SIZE", str(procs))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(procs))
    got = []
    for rank in range(procs):
        monkeypatch.setenv("LOCAL_RANK", str(rank))
        got.append([d.index for d in resolve_devices(ExtractionConfig())])
    assert got == want
    if cards == 4 and procs == 2:  # --device_ids index into the process's share
        assert resolve_devices(ExtractionConfig(device_ids=[1])) == [torch.device("cuda", 3)]
        with pytest.raises(ValueError, match=r"device_ids \[2\] out of range: only 2 devices"):
            resolve_devices(ExtractionConfig(device_ids=[2]))


@pytest.mark.parametrize("module", [
    "video_features_tpu_torch.devices", "video_features_tpu_torch.parallel",
    "video_features_tpu_torch.parallel.scheduler", "video_features_tpu_torch.extract.base",
    "video_features_tpu_torch.cli",
])
def test_each_entry_module_imports_first(module):
    """No import cycle: each module imports in a fresh interpreter, first."""
    import subprocess

    root = str(pathlib.Path(__file__).resolve().parents[1])
    done = subprocess.run([sys.executable, "-c", f"import {module}"], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr[-2000:]


# --- queue mode with a fake extractor ------------------------------------------

class _Manifest:
    def __init__(self):
        self.events, self.records = [], []

    def event(self, name, **kw):
        self.events.append((name, kw))

    def record(self, video, status, **kw):
        self.records.append((video, status, kw))


class _Telemetry:
    total_videos = None


class Fake:
    """A duck-typed extractor whose calls can die outside the per-video
    isolation a real extractor has (the worker's escape)."""

    def __init__(self, n, die=(), workers=1, **cfg):
        self.path_list = [f"v{i}.mp4" for i in range(n)]
        # every worker's warmup waits for the others, so each pulls a chunk
        self.barrier = threading.Barrier(workers)
        self.config = ExtractionConfig(**cfg)
        self.manifest, self.telemetry = _Manifest(), _Telemetry()
        self.done, self.calls, self.workers = [], [], set()
        self.die = set(die)  # worker labels that die at their first call
        self.lock = threading.Lock()

    def warmup(self, device):
        self.barrier.wait(timeout=30)
        return device

    def __call__(self, indices, device=None, worker=None, raise_stop=False):
        with self.lock:
            self.calls.append(list(indices))
            if worker in self.die:
                self.die.discard(worker)
                raise RuntimeError(f"boom on {worker}")
            self.workers.add(worker)
            self.done.extend(indices)
        time.sleep(0.05)  # keeps the queue alive until every worker pulls


def test_queue_runs_every_index_once():
    ex = Fake(24, workers=3)
    scheduler.parallel_feature_extraction(ex, _cpus(3))
    assert sorted(ex.done) == list(range(24))
    assert ex.workers == {"cpu/0", "cpu/1", "cpu/2"}
    assert scheduler.worker_labels([CPU, torch.device("cuda", 1), CPU]) == ["cpu/0", "cuda:1", "cpu/1"]


def test_queue_worker_death_is_requeued(capsys):
    ex = Fake(16, die={"cpu/1"}, workers=2)
    scheduler.parallel_feature_extraction(ex, _cpus(2))
    assert sorted(ex.done) == list(range(16))
    assert "died mid-run" in capsys.readouterr().out
    (name, kw), = ex.manifest.events
    assert (name, kw["device"], kw["phase"], kw["error_type"]) == (
        "worker_death", "cpu", "extract", "RuntimeError")


def test_queue_all_workers_dead_raises():
    ex = Fake(16, die={"cpu/0", "cpu/1"}, workers=2)
    with pytest.raises(RuntimeError, match="unprocessed"):
        scheduler.parallel_feature_extraction(ex, _cpus(2))


def test_queue_retry_cap_records_failed(capsys):
    ex = Fake(12, die={"cpu/0", "cpu/1"}, workers=2, retries=0)
    scheduler.parallel_feature_extraction(ex, _cpus(2))  # every chunk dropped: no raise
    failed = {v: kw for v, status, kw in ex.manifest.records if status == "failed"}
    assert sorted(failed) == sorted(ex.path_list) and ex.done == []
    assert {(kw["stage"], kw["error_class"], kw["attempts"]) for kw in failed.values()} == {
        ("worker", "transient", 1)}
    assert "retry budget exhausted" in capsys.readouterr().out


def test_queue_warmup_death_is_recorded():
    ex = Fake(6)
    ex.warmup = lambda device: (_ for _ in ()).throw(RuntimeError("no build"))
    with pytest.raises(RuntimeError, match="all extraction workers died with 6 of 6"):
        scheduler.parallel_feature_extraction(ex, _cpus(2))
    assert [kw["phase"] for _, kw in ex.manifest.events] == ["warmup", "warmup"]


@pytest.mark.parametrize("devices,cfg,want", [
    (1, dict(), 20),
    (2, dict(decode_workers=2), 6),
    (2, dict(decode_workers=0), 2),
    (3, dict(decode_workers=1, video_batch=5), 10),
], ids=["one-device-all", "decode-workers", "serial", "video-batch"])
def test_queue_chunk_rule(devices, cfg, want):
    ex = Fake(20, **cfg)
    scheduler.parallel_feature_extraction(ex, _cpus(devices))
    assert max(len(c) for c in ex.calls) == want and sorted(ex.done) == list(range(20))


def test_queue_strides_under_a_launcher(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "1")
    ex = Fake(11)
    scheduler.parallel_feature_extraction(ex, _cpus(2))
    assert sorted(ex.done) == list(range(1, 11, 3)) and ex.telemetry.total_videos == 4


STICKY = "CUDA error: an illegal memory access was encountered"


class _Poisoned(BaseExtractor):
    """Every forward on the worker thread ``poisoned`` raises a sticky
    CUDA error, as a card does once one launch faulted; each worker waits
    at its first warmup for the other, so both pull a chunk."""

    feature_type = "toy"
    poisoned = "extract-cpu/1"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.barrier, self.arrived = threading.Barrier(2), set()
        self.forwarded = []

    def warmup(self, device):
        state = super().warmup(device)
        me = threading.current_thread().name
        if me not in self.arrived:
            self.arrived.add(me)
            self.barrier.wait(timeout=30)
        return state

    def _build(self, device):
        return device

    def prepare(self, entry):
        return entry

    def forward(self, state, payload):
        if threading.current_thread().name == self.poisoned:
            raise RuntimeError(STICKY)
        self.forwarded.append(payload)
        time.sleep(0.01)  # keeps the queue alive until both workers pull
        return {"toy": np.ones((1, 1), np.float32), "fps": np.array(25.0)}


@pytest.mark.parametrize("workers", [0, 2], ids=["serial", "pipelined"])
def test_queue_sticky_error_kills_one_worker_and_the_other_finishes(tmp_path, workers, capsys):
    videos = []
    for i in range(16):
        videos.append(str(tmp_path / f"v{i:02d}.mp4"))
        pathlib.Path(videos[-1]).write_bytes(b"")
    cfg = ExtractionConfig(video_paths=videos, on_extraction="save_numpy", cpu=True,
                           output_path=str(tmp_path / "o"), tmp_path=str(tmp_path / "t"),
                           preflight="off", decode_workers=workers)
    ex = _Poisoned(cfg)
    scheduler.parallel_feature_extraction(ex, _cpus(2))
    summary = faults.finalize_run(cfg.output_path)
    status = {v: s["status"] for v, s in summary["videos"].items()}
    assert sorted(status) == videos  # every video has its record
    (failed,) = [v for v, s in status.items() if s == "failed"]
    assert set(status.values()) == {"done", "failed"} and failed not in ex.forwarded
    assert sorted(ex.forwarded) == sorted(v for v in videos if v != failed)
    (death,) = summary["worker_deaths"]
    assert death["device"] == "cpu" and STICKY in death["message"]
    assert "died mid-run" in capsys.readouterr().out


# --- the concurrency repairs ------------------------------------------------------

class _SlowBuild(BaseExtractor):
    feature_type = "toy"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.builds = []

    def _build(self, device):
        time.sleep(0.05)
        self.builds.append(device)
        return {"device": device}


def test_warmup_builds_once_per_device_under_threads(tmp_path):
    video = tmp_path / "x.mp4"
    video.write_bytes(b"")
    ex = _SlowBuild(ExtractionConfig(video_paths=[str(video)], output_path=str(tmp_path)),
                    external_call=True)
    devices = [CPU, torch.device("meta")] * 8
    threads = [threading.Thread(target=ex.warmup, args=(d,)) for d in devices]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert sorted(map(str, ex.builds)) == ["cpu", "meta"]


def test_launch_counts_are_exact_under_threads():
    def wrapper():
        pass

    wrapper.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [kernels.count_launch(wrapper)
                                                    for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and wrapper.launches == 16 * 2000


def test_native_threads_split_between_queue_workers():
    ex = object.__new__(BaseExtractor)
    for kw, want in ((dict(device_ids=[0, 0, 1]), 3), (dict(cpu=True, device_ids=[0, 1]), 1),
                     (dict(device_ids=[0, 1], sharding="mesh"), 1)):
        ex.config = ExtractionConfig(**kw)
        assert ex._queue_workers() == want


# --- the tiny CLIP through queue mode --------------------------------------------

@pytest.fixture(scope="module")
def clip_videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel_media")
    clip = synth_video(str(d / "c.mp4"), n_frames=8, width=64, height=48, seed=3)
    videos = []
    for i in range(6):
        dst = d / f"v{i}.mp4"
        dst.write_bytes(pathlib.Path(clip).read_bytes())
        videos.append(str(dst))
    return videos


@pytest.fixture
def tiny_clip(monkeypatch):
    monkeypatch.setitem(port_model.CONFIGS, FT, port_model.CLIPVisionConfig(**TINY))


def _clip_cfg(videos, tmp_path, **kw):
    return ExtractionConfig(feature_type=FT, video_paths=videos, extract_method="uni_4",
                            allow_random_init=True, decoder="cv2", output_path=str(tmp_path / "o"),
                            tmp_path=str(tmp_path / "t"), **kw)


def test_queue_tiny_clip_on_three_devices_matches_serial(clip_videos, tmp_path, tiny_clip):
    ex = ExtractCLIP(_clip_cfg(clip_videos, tmp_path, on_extraction="save_numpy"))
    scheduler.parallel_feature_extraction(ex, _cpus(3))
    files = sorted((tmp_path / "o" / FT).glob("*.npy"))
    assert [f.name for f in files] == [f"v{i}_CLIP-ViT-B-32.npy" for i in range(6)]
    serial = ExtractCLIP(_clip_cfg(clip_videos, tmp_path, decode_workers=0), external_call=True)
    for f, ref in zip(files, serial(device=CPU)):
        np.testing.assert_array_equal(np.load(f), ref[FT])
    assert len(ex._device_state) == 1  # three workers on one device: one build


# --- make_mesh and the tensor-parallel cut ---------------------------------------

def test_make_mesh_shapes_and_messages():
    mesh = sharding.make_mesh(_cpus(8), model=2)
    assert mesh.shape == jax_sharding.make_mesh(jax.devices(), model=2).shape == {
        "data": 4, "model": 2}
    assert sharding.make_mesh(_cpus(6), data=2, model=2).shape == {"data": 2, "model": 2}
    for kw in (dict(model=3), dict(data=3, model=3)):
        with pytest.raises(ValueError) as ours:
            sharding.make_mesh(_cpus(8), **kw)
        with pytest.raises(ValueError) as ref:
            jax_sharding.make_mesh(jax.devices(), **kw)
        assert str(ours.value) == str(ref.value)


def test_clip_shard_state_cuts_qkv_per_section_and_keeps_row_biases():
    model = port_model.init_weights(port_model.VisionTransformer(
        port_model.CLIPVisionConfig(**TINY)))
    state = model.state_dict()
    w, p = TINY["width"], "transformer.resblocks.0."
    for j in range(2):
        cut = sharding.clip_vit_shard_state(state, 2, j)
        rows = np.r_[j * 32:(j + 1) * 32, w + j * 32:w + (j + 1) * 32,
                     2 * w + j * 32:2 * w + (j + 1) * 32]
        assert torch.equal(cut[p + "attn.in_proj_weight"], state[p + "attn.in_proj_weight"][rows])
        assert torch.equal(cut[p + "attn.in_proj_bias"], state[p + "attn.in_proj_bias"][rows])
        assert torch.equal(cut[p + "attn.out_proj.weight"],
                           state[p + "attn.out_proj.weight"][:, j * 32:(j + 1) * 32])
        assert torch.equal(cut[p + "mlp.c_fc.weight"], state[p + "mlp.c_fc.weight"][j * 128:(j + 1) * 128])
        assert torch.equal(cut[p + "mlp.c_proj.weight"],
                           state[p + "mlp.c_proj.weight"][:, j * 128:(j + 1) * 128])
        for name in ("attn.out_proj.bias", "mlp.c_proj.bias", "ln_1.weight"):
            assert cut[p + name] is state[p + name]
        assert cut["proj"] is state["proj"] and cut["conv1.weight"] is state["conv1.weight"]


# --- the sharded CLIP forward against JAX build_sharded_apply ---------------------

def _openai_tiny(seed=5):
    """A seeded OpenAI ``visual.*`` state dict of the tiny tower, every
    bias and LayerNorm weight nonzero (``init_weights`` zeroes the biases,
    which would hide a bias added once per shard)."""
    rng = np.random.RandomState(seed)
    D, E, P = TINY["width"], TINY["embed_dim"], TINY["patch_size"]
    L = (TINY["image_size"] // P) ** 2 + 1

    def w(*shape):
        return (rng.randn(*shape) * shape[-1] ** -0.5).astype(np.float32)

    def b(n):
        return (0.2 * rng.randn(n)).astype(np.float32)

    sd = {"visual.class_embedding": w(D), "visual.positional_embedding": w(L, D),
          "visual.proj": w(D, E), "visual.conv1.weight": w(D, 3, P, P)}
    for ln in ("ln_pre", "ln_post"):
        sd[f"visual.{ln}.weight"], sd[f"visual.{ln}.bias"] = 1 + b(D), b(D)
    for i in range(TINY["layers"]):
        p = f"visual.transformer.resblocks.{i}"
        sd.update({f"{p}.attn.in_proj_weight": w(3 * D, D), f"{p}.attn.in_proj_bias": b(3 * D),
                   f"{p}.attn.out_proj.weight": w(D, D), f"{p}.attn.out_proj.bias": b(D),
                   f"{p}.mlp.c_fc.weight": w(4 * D, D), f"{p}.mlp.c_fc.bias": b(4 * D),
                   f"{p}.mlp.c_proj.weight": w(D, 4 * D), f"{p}.mlp.c_proj.bias": b(D)})
        for ln in ("ln_1", "ln_2"):
            sd[f"{p}.{ln}.weight"], sd[f"{p}.{ln}.bias"] = 1 + b(D), b(D)
    return sd


@pytest.fixture(scope="module")
def tiny_weights():
    sd = _openai_tiny()
    model = port_model.VisionTransformer(port_model.CLIPVisionConfig(**TINY))
    model.load_state_dict(convert_state_dict(sd, TINY["layers"]))
    x = np.random.RandomState(0).randn(8, 3, 32, 32).astype(np.float32)
    with torch.inference_mode():
        ref = model.eval()(torch.from_numpy(x)).numpy()
    return sd, model, x, ref


def _jax_sharded(sd, x, data, model, context):
    from video_features_tpu.parallel.ring_attention import make_context_parallel_core
    from jax.sharding import PartitionSpec as P

    mesh = jax_sharding.make_mesh(jax.devices()[:data * model], model=model)
    core = make_context_parallel_core(mesh) if context else None
    net = jax_model.VisionTransformer(jax_model.CLIPVisionConfig(**TINY), attn_core=core)
    params = jax_convert.convert_state_dict(sd, TINY["layers"])
    spec = P() if context else P("data")
    fn = jax_sharding.build_sharded_apply(net, mesh, batch_spec=spec, out_spec=spec)
    return np.asarray(fn(jax_sharding.shard_params(params, mesh), jnp.asarray(x)))


@pytest.mark.parametrize("data,model,context", [
    (1, 2, False), (1, 4, False), (2, 2, False), (2, 2, True),
], ids=["tp2", "tp4", "dp2xtp2", "context2xtp2"])
def test_sharded_clip_matches_jax_and_unsharded(tiny_weights, data, model, context):
    sd, net, x, ref = tiny_weights
    mesh = sharding.make_mesh(_cpus(data * model), model=model)
    sharded = port_model.ShardedVisionTransformer(net, mesh, context=context)
    with torch.inference_mode():
        out = sharded(sharded.place(x)).numpy()[:8]
    np.testing.assert_allclose(out, ref, atol=ATOL)
    np.testing.assert_allclose(out, _jax_sharded(sd, x, data, model, context), atol=ATOL)


def test_sharded_clip_data_parallel_is_the_unsharded_math(tiny_weights):
    _, net, x, ref = tiny_weights
    sharded = port_model.ShardedVisionTransformer(net, sharding.make_mesh(_cpus(4)))
    with torch.inference_mode():
        out = sharded(sharded.place(x[:7])).numpy()  # 7 rows over 4: 2, 2, 2, 1
    assert out.shape == (7, TINY["embed_dim"])
    np.testing.assert_allclose(out[:7], ref[:7], atol=ATOL)


@pytest.mark.parametrize("model", [1, 2, 4])
def test_sharded_clip_holds_one_shard_of_the_blocks(tiny_weights, model):
    """A device holds the replicated parts once and 1/m of every block's
    weights per model shard (the row-parallel biases whole): the tensors
    of the sharded tower add up to the unsharded one's plus m - 1 copies
    of those biases, and none of them is a view of the built model."""
    _, net, _, _ = tiny_weights
    sharded = port_model.ShardedVisionTransformer(net, sharding.make_mesh(_cpus(model),
                                                                          model=model))

    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    ours = [*sharded.parameters(), *sharded.buffers()]
    row_biases = [t for n, t in net.named_parameters()
                  if n.endswith(("out_proj.bias", "c_proj.bias"))]
    assert nbytes(ours) == nbytes(net.parameters()) + (model - 1) * nbytes(row_biases)
    theirs = {t.untyped_storage().data_ptr() for t in net.parameters()}
    assert not theirs & {t.untyped_storage().data_ptr() for t in ours}


# --- the extractor on a mesh -----------------------------------------------------

@pytest.mark.parametrize("kw,mesh_shape", [
    (dict(), (2, 1)),
    (dict(mesh_model=2), (2, 2)),
    (dict(mesh_model=2, mesh_context=True), (2, 2)),
    (dict(preprocess="device"), (4, 1)),
    (dict(mesh_model=2, video_batch=2), (1, 2)),
], ids=["dp", "dpxtp", "context", "device-preprocess", "tp-video-batch"])
def test_clip_extractor_on_a_mesh_matches_one_device(clip_videos, tmp_path, tiny_clip, kw,
                                                      mesh_shape):
    videos = clip_videos[:3]
    one = ExtractCLIP(_clip_cfg(videos, tmp_path, preprocess=kw.get("preprocess", "host")),
                      external_call=True)(device=CPU)
    cfg = sanity_check(_clip_cfg(videos, tmp_path, sharding="mesh", **kw))
    ex = ExtractCLIP(cfg, external_call=True)
    data, model = mesh_shape
    got = ex(device=sharding.make_mesh(_cpus(data * model), model=model))
    for a, b in zip(got, one):
        assert a[FT].shape == b[FT].shape == (4, TINY["embed_dim"])
        np.testing.assert_allclose(a[FT], b[FT], atol=ATOL)


def test_cli_mesh_on_the_cpu_matches_queue(clip_videos, tmp_path, tiny_clip):
    def run(out, *extra):
        cli.main(["--feature_type", FT, "--cpu", "--allow_random_init", "--extract_method", "uni_4",
                  "--decoder", "cv2", "--on_extraction", "save_numpy", "--output_path",
                  str(tmp_path / out), "--tmp_path", str(tmp_path / "t"), *extra,
                  "--video_paths", *clip_videos[:2]])
        return [np.load(f) for f in sorted((tmp_path / out / FT).glob("*.npy"))]

    queue, mesh = run("q"), run("m", "--sharding", "mesh", "--device_ids", "0", "0")
    assert len(queue) == len(mesh) == 2
    for a, b in zip(mesh, queue):
        np.testing.assert_array_equal(a, b)


# --- refusals: the JAX package's messages ------------------------------------------

class _Progress:
    def close(self):
        pass


def _mesh_refusal(run, devices, name, **attrs):
    cls = type(name, (), dict(feature_type=attrs.pop("feature_type"), progress=_Progress(),
                              **attrs))
    with pytest.raises(ValueError) as exc:
        run(cls(), devices)
    return str(exc.value)


@pytest.mark.parametrize("attrs", [
    dict(feature_type="resnet50", mesh_capable=False),
    dict(feature_type="r21d_rgb", mesh_capable=True, cfg=dict(mesh_model=2)),
    dict(feature_type="vggish", mesh_capable=True, mesh_tp_capable=True,
         cfg=dict(mesh_context=True, sharding="mesh")),
], ids=["mesh_capable", "mesh_tp_capable", "mesh_context_capable"])
def test_mesh_refusals_match_jax(attrs):
    cfg = attrs.pop("cfg", {})
    ours = _mesh_refusal(scheduler.mesh_feature_extraction, _cpus(2), "ExtractResNet",
                         config=ExtractionConfig(**cfg), **dict(attrs))
    ref = _mesh_refusal(jax_scheduler.mesh_feature_extraction, jax.devices()[:2], "ExtractResNet",
                        config=JaxConfig(**cfg), **dict(attrs))
    assert ours == ref


def test_cli_mesh_refuses_resnet_with_the_jax_message(clip_videos, tmp_path):
    """ResNet runs ``--sharding mesh`` (data parallel); the refusal that
    stands is tensor parallelism, with the JAX package's message."""
    with pytest.raises(ValueError) as exc:
        cli.main(["--feature_type", "resnet50", "--cpu", "--allow_random_init", "--sharding",
                  "mesh", "--mesh_model", "2", "--video_paths", clip_videos[0],
                  "--output_path", str(tmp_path / "o"), "--tmp_path", str(tmp_path / "t")])
    assert str(exc.value) == (
        "--mesh_model 2 needs tensor-parallel param specs, which ExtractResNet does not "
        "define (only the batch axis shards); use --mesh_model 1")


def test_cli_mesh_resnet_on_two_cpus_matches_queue(clip_videos, tmp_path, monkeypatch):
    """``resnet50 --sharding mesh`` through the CLI on a mesh of two CPU
    devices: the frame batches split over both rows, the files equal to
    queue mode's."""
    monkeypatch.setattr(port_devices, "resolve_devices",
                        lambda cfg=None, **kw: _cpus(len(getattr(cfg, "device_ids", None) or [0])))
    meshes = []
    real = sharding.make_mesh
    monkeypatch.setattr(sharding, "make_mesh",
                        lambda *a, **kw: meshes.append(real(*a, **kw)) or meshes[-1])

    def run(out, *extra):
        cli.main(["--feature_type", "resnet50", "--cpu", "--allow_random_init", "--decoder",
                  "cv2", "--extraction_fps", "2", "--batch_size", "3", "--on_extraction",
                  "save_numpy", "--output_path", str(tmp_path / out), "--tmp_path",
                  str(tmp_path / "t"), *extra, "--video_paths", *clip_videos[:2]])
        return [np.load(f) for f in sorted((tmp_path / out / "resnet50").glob("*.npy"))]

    queue = run("q")
    mesh = run("m", "--sharding", "mesh", "--device_ids", "0", "0")
    assert [m.shape["data"] for m in meshes] == [2]
    assert len(queue) == len(mesh) == 2
    for a, b in zip(mesh, queue):
        assert a.shape[1] == 2048
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kw", [
    dict(sharding="ring"),
    dict(mesh_model=0),
    dict(mesh_context=True),
    dict(sharding="mesh", mesh_context=True, attn="flash"),
    dict(feature_type="resnet50", sharding="mesh", preprocess="device"),
    dict(sharding="mesh", mesh_context=True, preprocess="device"),
], ids=["sharding", "mesh_model", "context-needs-mesh", "context-fused-only",
        "mesh-device-preprocess", "context-device-preprocess"])
def test_mesh_config_checks_match_jax(kw):
    kw = {"feature_type": FT, "extract_method": "uni_4", **kw}
    with pytest.raises(ValueError) as ours:
        sanity_check(ExtractionConfig(**kw))
    with pytest.raises(ValueError) as ref:
        jax_sanity_check(JaxConfig(**kw))
    assert str(ours.value) == str(ref.value)


def test_mesh_flags_parse_and_show_pred_pins_one_device():
    cfg = parse_args(["--feature_type", FT, "--device_ids", "0", "0", "1", "--sharding", "mesh",
                      "--mesh_model", "2", "--mesh_context"])
    assert (cfg.device_ids, cfg.sharding, cfg.mesh_model, cfg.mesh_context) == (
        [0, 0, 1], "mesh", 2, True)
    assert sanity_check(ExtractionConfig(feature_type="resnet50", device_ids=[1, 0],
                                         show_pred=True)).device_ids == [1]
    assert sanity_check(ExtractionConfig(feature_type="resnet50", show_pred=True)).device_ids == [0]
    assert port_devices.world_size() >= 1
