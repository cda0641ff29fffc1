"""``--sharding mesh`` across launched processes, on the CPU over gloo.

The port's counterpart of ``tests/test_multihost.py``: two OS processes
join one ``torch.distributed`` group through the CLI
(``parallel/distributed.py``), each on two CPU "devices" (the CLI's device
list patched in the worker, as
``test_torch_parallel.py::test_cli_mesh_resnet_on_two_cpus_matches_queue``
does), each with an ``--output_path`` of its own, standing in for
per-host filesystems. One launch runs, in turn, with one free port each:

- CLIP (``test_torch_parallel.py``'s tiny tower) at data 2 x model 2,
  the model axis inside each process, over two videos, with a sink fault
  planted in process 0 alone (``--fault_inject sink:error:2``: the
  second video's first write fails): both processes retry that video
  together and end with the same outcomes;
- the same under ``--mesh_context`` (the ring hops between the processes);
- CLIP from a ``.msgpack`` written by the port's ``convert_weights``, at
  data 4;
- PWC, one window of 11 pairs over 4 rows;
- I3D + PWC, one stack of 10 over one row a process: 8 frames and 2, so
  every time halo crosses the processes and the second block drops out
  of the deeper ops;
- I3D on flow read from disk (a stack of 16 over one row a process);
  I3D + RAFT differs from I3D + PWC only in the flow net a row runs, a
  replica with no collective of its own, which the RAFT run holds;
- ResNet-18, batches of 5, 5 and 2 over 4 rows (in the last batch the
  second process's rows all sit out), R(2+1)D (one block a layer) on
  stacks of 4 in batches of 3, VGGish on a 3 s wav, and RAFT (2
  iterations) over one window of 11 pairs;
- then CLIP again with ``--resume`` over one more video: the second
  process's directory holds no features, so without process 0's answer
  it would compute the two finished videos while process 0 skips them.

Each family's features are byte-equal to a one-process mesh of the same
global grid (the devices repeated in this process): a process does each
row's arithmetic as the one process does, with one torch thread, and the
collectives only move bytes. The second process writes no ``.npy``; its
manifest records the same outcomes. The CLIP from the ``.msgpack`` is
held against the JAX package's forward of the same file at
``test_torch_parallel.py``'s 1e-5. The processes are waited for with one
deadline (``WAIT_S``) and killed at it, so a deadlock fails the test with
both ranks' logs instead of holding the run.

The pure pieces run in this process: the global mesh's row ownership
(with a faked group), the gather of time-block edges against
``temporal_halo`` on one process, ``gather_rows`` with uneven rows and
the lockstep loop's agreement on a step's outcome (two threads over a
faked all-gather), and the backend rule.
"""

import functools
import json
import os
import pathlib
import socket
import subprocess
import sys
import threading
import time
import types

import cv2
import numpy as np
import pytest
import torch

from video_features_tpu.models.clip import model as jax_model
from video_features_tpu.models.clip.extract_clip import ExtractCLIP as JaxExtractCLIP
from video_features_tpu.config import ExtractionConfig as JaxConfig
from video_features_tpu_torch import cli, convert_weights
from video_features_tpu_torch.config import ExtractionConfig
from video_features_tpu_torch.extract.base import BaseExtractor
from video_features_tpu_torch.models.clip import model as port_model
from video_features_tpu_torch.models.i3d import extract_i3d
from video_features_tpu_torch.models.i3d.model import I3D
from video_features_tpu_torch.models.r21d.model import R2Plus1D
from video_features_tpu_torch.models.raft.model import RAFT
from video_features_tpu_torch.parallel import devices as port_devices
from video_features_tpu_torch.parallel import distributed, scheduler, sharding
from video_features_tpu_torch.runtime import faults
from video_features_tpu_torch.utils.synth import synth_video, synth_wav

from torch_threads import one_torch_thread  # noqa: F401 - an autouse fixture

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
FT = "CLIP-ViT-B/32"
TINY = dict(patch_size=16, width=64, layers=2, heads=2, embed_dim=32, image_size=32)
# the JAX package's CLIP against the port's, test_torch_parallel.py's bound
JAX_ATOL = 1e-5
RANKS = 2
WAIT_S = 240  # the whole launch: every run, both processes
# process 0's sink fails its second write (clip_tp's second video), once
RANK0_FAULT = ["--fault_inject", "sink:error:2", "--retry_backoff", "0"]

# the worker: this process's rank of two, the CLI's device list patched to
# as many CPU "devices" as --device_ids names, the tiny CLIP tower and a
# narrow I3D; each run with a port of its own and an output path a rank
_WORKER = r"""
import functools, json, os, sys
spec, rank = json.loads(sys.argv[1]), int(sys.argv[2])
os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                  LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1")
import torch
torch.set_num_threads(1)
from video_features_tpu_torch import cli
from video_features_tpu_torch.models.clip import model as clip_model
from video_features_tpu_torch.models.i3d import extract_i3d
from video_features_tpu_torch.models.i3d.model import I3D
from video_features_tpu_torch.models.r21d.model import R2Plus1D
from video_features_tpu_torch.models.raft.model import RAFT
from video_features_tpu_torch.parallel import devices, scheduler

def cpus(cfg=None, **kw):
    return [torch.device("cpu")] * len(getattr(cfg, "device_ids", None) or [0])

devices.resolve_devices = cli.resolve_devices = scheduler.resolve_devices = cpus
clip_model.CONFIGS["CLIP-ViT-B/32"] = clip_model.CLIPVisionConfig(**spec["tiny"])
extract_i3d.I3D = functools.partial(I3D, channel_div=8)
R2Plus1D.__init__.__defaults__ = ((1, 1, 1, 1), 400)
RAFT.__init__.__defaults__ = (2,)
for run in spec["runs"]:
    os.environ["MASTER_PORT"] = str(run["port"])
    cli.main(run["argv"] + run["rank_argv"][rank] + ["--output_path", run["out"][rank]])
    print("run done:", run["name"], flush=True)
"""


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _cpus(cfg=None, **kw):
    return [CPU] * len(getattr(cfg, "device_ids", None) or [0])


def _tiny_weights(path):
    """The tiny tower's seeded weights with nonzero biases, OpenAI names."""
    model = port_model.init_weights(port_model.VisionTransformer(
        port_model.CLIPVisionConfig(**TINY)))
    g = torch.Generator().manual_seed(7)
    sd = {k: v + 0.1 * torch.randn(v.shape, generator=g) for k, v in model.state_dict().items()}
    torch.save({f"visual.{k}": v for k, v in sd.items()}, path)


def _runs(media, out):
    """(name, argv without --output_path, one-process --device_ids)."""
    common = ["--cpu", "--allow_random_init", "--decoder", "cv2", "--on_extraction",
              "save_numpy", "--sharding", "mesh", "--strict", "--tmp_path", str(out / "tmp")]
    clip = [*common, "--feature_type", FT, "--extract_method", "uni_4"]
    two, four = ["0", "0"], ["0", "0", "0", "0"]
    v = media["videos"]
    return [
        ("clip_tp", [*clip, "--mesh_model", "2", "--device_ids", *two, "--video_paths", *v[:2]],
         four),
        ("clip_context", [*clip, "--mesh_model", "2", "--mesh_context", "--device_ids", *two,
                          "--video_paths", v[0]], four),
        ("clip_msgpack", [*clip, "--weights_path", media["msgpack"], "--device_ids", *two,
                          "--video_paths", v[0]], four),
        ("pwc", [*common, "--feature_type", "pwc", "--extraction_fps", "5", "--side_size", "64",
                 "--batch_size", "11", "--device_ids", *two, "--video_paths", v[0]], four),
        ("i3d", [*common, "--feature_type", "i3d", "--flow_type", "pwc", "--stack_size", "10",
                 "--step_size", "10", "--extraction_fps", "5", "--device_ids", "0",
                 "--video_paths", v[0]], two),
        ("i3d_disk", [*common, "--feature_type", "i3d", "--flow_type", "flow", "--stack_size",
                      "16", "--step_size", "16", "--device_ids", "0", "--video_paths",
                      media["long"], "--flow_paths", media["flows"]], two),
        ("resnet", [*common, "--feature_type", "resnet18", "--extraction_fps", "5",
                    "--batch_size", "5", "--device_ids", *two, "--video_paths", v[0]], four),
        ("r21d", [*common, "--feature_type", "r21d_rgb", "--stack_size", "4", "--step_size", "4",
                  "--batch_size", "3", "--device_ids", *two, "--video_paths", v[0]], four),
        ("vggish", [*common, "--feature_type", "vggish", "--device_ids", *two,
                    "--video_paths", media["wav"]], four),
        ("raft", [*common, "--feature_type", "raft", "--extraction_fps", "5", "--side_size",
                  "64", "--batch_size", "11", "--device_ids", *two, "--video_paths", v[0]],
         four),
    ]


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    d = tmp_path_factory.mktemp("multihost_media")
    clip = synth_video(str(d / "c.mp4"), n_frames=12, width=64, height=48, fps=5.0, seed=3)
    videos = []
    for i in range(3):
        dst = d / f"v{i}.mp4"
        dst.write_bytes(pathlib.Path(clip).read_bytes())
        videos.append(str(dst))
    _tiny_weights(d / "clip.pt")
    # I3D's disk flow: a 17-frame clip and 17 flow_x/flow_y JPEG pairs in
    # a directory named by its stem
    long = synth_video(str(d / "long.mp4"), n_frames=17, width=64, height=48, fps=5.0, seed=4)
    flows = d / "flows" / "long"
    flows.mkdir(parents=True)
    rng = np.random.RandomState(1)
    for i in range(17):
        for axis in ("x", "y"):
            cv2.imwrite(str(flows / f"flow_{axis}_{i:05d}.jpg"),
                        rng.randint(0, 256, size=(224, 256), dtype=np.uint8))
    wav = synth_wav(str(d / "tone.wav"), seconds=3.0, seed=3)
    return {"videos": videos, "pt": str(d / "clip.pt"), "msgpack": str(d / "clip.msgpack"),
            "long": long, "flows": str(flows), "wav": wav}


@pytest.fixture(scope="module")
def cluster(media, tmp_path_factory):
    """Every run through two processes and, meanwhile, each run's
    one-process mesh in this process. Returns {run: (rank 0 dir, rank 1
    dir, one-process dir)} and the processes' output."""
    out = tmp_path_factory.mktemp("multihost")
    mp = pytest.MonkeyPatch()
    try:
        mp.setitem(port_model.CONFIGS, FT, port_model.CLIPVisionConfig(**TINY))
        # the port's converter writes the .msgpack both packages read
        assert convert_weights.main(["--feature_type", FT, media["pt"], media["msgpack"]]) == 0
        runs = _runs(media, out)
        ports = _free_ports(len(runs) + 1)
        dirs = {name: [str(out / name / f"rank{r}") for r in range(RANKS)]
                for name, _, _ in runs}
        spec_runs = [dict(name=name, argv=argv, port=port, out=dirs[name],
                          rank_argv=[RANK0_FAULT if name == "clip_tp" else [], []])
                     for (name, argv, _), port in zip(runs, ports)]
        # --resume over one more video, into clip_tp's directories
        resume = runs[0][1][:runs[0][1].index("--video_paths")]
        spec_runs.append(dict(name="resume",
                              argv=[*resume, "--resume", "--video_paths", *media["videos"]],
                              port=ports[-1], out=dirs["clip_tp"], rank_argv=[[], []]))
        spec = json.dumps({"tiny": TINY, "runs": spec_runs})
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
        logs = [out / f"rank{r}.log" for r in range(RANKS)]
        procs = []
        for r, log in enumerate(logs):
            with open(log, "w") as f:  # a file, not a pipe nobody reads meanwhile
                procs.append(subprocess.Popen([sys.executable, "-c", _WORKER, spec, str(r)],
                                              cwd=str(ROOT), env=env, stdout=f,
                                              stderr=subprocess.STDOUT))
        try:
            # meanwhile, the one-process mesh of each run's global grid here
            mp.setattr(port_devices, "resolve_devices", _cpus)
            mp.setattr(cli, "resolve_devices", _cpus)
            mp.setattr(scheduler, "resolve_devices", _cpus)
            mp.setattr(extract_i3d, "I3D", functools.partial(I3D, channel_div=8))
            mp.setattr(R2Plus1D.__init__, "__defaults__", ((1, 1, 1, 1), 400))
            mp.setattr(RAFT.__init__, "__defaults__", (2,))
            result = {}
            for name, argv, one in runs:
                i = argv.index("--device_ids")
                argv = [*argv[:i + 1], *one, *argv[argv.index("--video_paths"):]]
                ref = str(out / name / "one")
                cli.main(argv + ["--output_path", ref])
                result[name] = (*dirs[name], ref)
            deadline = time.monotonic() + WAIT_S
            try:
                for p in procs:
                    p.wait(timeout=max(deadline - time.monotonic(), 0))
            except subprocess.TimeoutExpired:
                pass  # killed below; the logs say where each rank stood
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        logs = [log.read_text() for log in logs]
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-6000:]}"
        return result, logs
    finally:
        mp.undo()


def _npys(d):
    return {p.relative_to(d).as_posix(): np.load(p) for p in sorted(pathlib.Path(d).rglob("*.npy"))}


# the runs' features: (run, files on one process)
RUN_FILES = {"clip_tp": 2, "clip_context": 1, "clip_msgpack": 1, "pwc": 1, "i3d": 2,
             "i3d_disk": 2, "resnet": 1, "r21d": 1, "vggish": 1, "raft": 1}


def test_two_process_mesh_runs_every_family(cluster, media, monkeypatch):
    """One launch, every check (the test's cluster runs once whichever
    pytest worker takes it): each run's features byte-equal to the
    one-process mesh of its grid; one writer, each process with its own
    manifest of the same outcomes; ``--resume`` ending on process 0's
    answer; the CLIP from the ``.msgpack`` against the JAX package."""
    runs, logs = cluster
    for name, files in RUN_FILES.items():
        rank0, rank1, one = runs[name]
        got, ref = _npys(rank0), _npys(one)
        # clip_tp's directory also holds --resume's third video
        assert len(ref) == files and set(ref) <= set(got), (name, sorted(got), sorted(ref))
        for k in ref:
            assert got[k].shape == ref[k].shape and got[k].size and np.isfinite(got[k]).all()
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{name}: {k}")
        assert not _npys(rank1), f"{name}: the second process wrote features"
        s0, s1 = (faults.merge_manifest(d) for d in (rank0, rank1))
        want = 3 if name == "clip_tp" else 1  # clip_tp: two videos, then --resume over three
        assert s0["failed"] == s1["failed"] == 0, name
        assert s0["total"] == s0["done"] == s1["total"] == s1["done"] == want, name
        # the same outcome of each video on both processes; clip_tp's
        # second video retried once on each, after process 0's sink fault
        assert ({k: (v["status"], v["attempts"]) for k, v in s0["videos"].items()}
                == {k: (v["status"], v["attempts"]) for k, v in s1["videos"].items()}), name
        assert s0["retries"] == s1["retries"] == (1 if name == "clip_tp" else 0), name

    # --resume: the second process's directory holds no features, yet it
    # skips the two videos process 0 finished, computes the third with it,
    # and the run ends
    for r, log in enumerate(logs):
        assert "run done: resume" in log, (r, log[-3000:])
        end = log.index("run done: resume")
        resume = log[log.rindex("run done:", 0, end):end]
        assert resume.count("outputs exist (--resume)") == 2, (r, resume[-3000:])
    assert sorted(_npys(runs["clip_tp"][0])) == [
        f"{FT}/v{i}_{FT.replace('/', '-')}.npy" for i in range(3)]

    # the CLIP from the .msgpack against the JAX package's forward of it
    monkeypatch.setitem(jax_model.CONFIGS, FT, jax_model.CLIPVisionConfig(**TINY))
    ex = JaxExtractCLIP(JaxConfig(feature_type=FT, video_paths=[media["videos"][0]],
                                  extract_method="uni_4", weights_path=media["msgpack"],
                                  decoder="cv2", cpu=True), external_call=True)
    (want,) = ex()
    (feats,) = _npys(runs["clip_msgpack"][0]).values()
    assert feats.shape == want[FT].shape == (4, TINY["embed_dim"])
    np.testing.assert_allclose(feats, want[FT], atol=JAX_ATOL)


# --- the pure pieces ---------------------------------------------------------------

@pytest.mark.parametrize("rank,counts,model,want_rows", [
    (0, [1, 1], 2, [0]),
    (1, [1, 1], 2, [1]),
    (1, [2, 3, 1], 1, [2, 3, 4]),
    (2, [2, 3, 1], 1, [5]),
], ids=["r0-of-2x2", "r1-of-2x2", "r1-uneven", "r2-uneven"])
def test_global_mesh_row_ownership(monkeypatch, rank, counts, model, want_rows):
    monkeypatch.setattr(distributed, "multihost", lambda: True)
    monkeypatch.setattr(distributed, "process_index", lambda: rank)
    monkeypatch.setattr(distributed, "process_count", lambda: len(counts))
    monkeypatch.setattr(distributed, "all_gather_int", lambda n: list(counts))
    mine = [torch.device("cpu")] * (counts[rank] * model)
    mesh = sharding.make_mesh(mine, model=model)
    assert mesh.shape == {"data": sum(counts), "model": model}
    assert mesh.owners == [r for r, c in enumerate(counts) for _ in range(c)]
    assert mesh.local_rows == want_rows and mesh.multiprocess and mesh.first == CPU
    for i in range(sum(counts)):
        cells = list(mesh.devices[i])
        assert cells == ([CPU] * model if i in want_rows else [None] * model)
    sizes = sharding.row_sizes(2 * sum(counts) - 1, sum(counts))
    assert mesh.running(sizes) == [r for r in want_rows if sizes[r]]
    parts, got = sharding.split_rows(np.arange(len(sizes) * 2 - 1), mesh)
    assert got == sizes and len(parts) == len(mesh.running(sizes))
    with pytest.raises(ValueError, match="must divide this process's 3 device"):
        sharding.make_mesh([CPU] * 3, model=2)


class _FakeGroup:
    """Two threads as two processes: ``distributed._all_gather`` and
    ``_all_gather_object`` over a barrier, each thread its own rank."""

    def __init__(self, n):
        self.n, self.slots = n, [None] * n
        self.barrier, self.local = threading.Barrier(n, timeout=30), threading.local()

    def all_gather(self, t):
        self.slots[self.local.rank] = t.clone()
        self.barrier.wait()
        out = [s.clone() for s in self.slots]
        self.barrier.wait()
        return out

    def all_gather_object(self, obj):
        self.slots[self.local.rank] = obj
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out

    def run(self, fn):
        results, errors = [None] * self.n, []

        def body(rank):
            self.local.rank = rank
            try:
                results[rank] = fn(rank)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,)) for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        if errors:
            raise errors[0]
        return results


@pytest.fixture
def fake_group(monkeypatch):
    group = _FakeGroup(2)
    monkeypatch.setattr(distributed, "_all_gather", group.all_gather)
    monkeypatch.setattr(distributed, "_all_gather_object", group.all_gather_object)
    monkeypatch.setattr(distributed, "process_count", lambda: group.n)
    monkeypatch.setattr(distributed, "process_index", lambda: group.local.rank)
    return group


def _two_process_mesh(rank, rows_each):
    owners = [r for r in range(2) for _ in range(rows_each[r])]
    grid = np.full((len(owners), 1), None, dtype=object)
    for i, o in enumerate(owners):
        if o == rank:
            grid[i, 0] = CPU
    return sharding.Mesh(grid, owners, rank)


@pytest.mark.parametrize("lengths,rows_each,lo,hi,ends", [
    ([8, 8, 2], [2, 1], 3, 3, True),
    ([8, 2], [1, 1], 1, 1, True),
    ([4, 1, 2, 3], [2, 2], 2, 3, True),
    ([4, 2, 1], [1, 2], 0, 1, False),
], ids=["3-blocks", "short-last", "short-neighbours", "valid-avg-pool"])
def test_edge_gather_matches_temporal_halo_on_one_process(fake_group, lengths, rows_each,
                                                          lo, hi, ends):
    rng = np.random.RandomState(0)
    blocks = [torch.from_numpy(rng.randn(1, 2, t, 3, 3).astype(np.float32)) for t in lengths]
    want = sharding.temporal_halo(blocks, lo, hi, ends=ends)

    def rank_view(rank):
        mesh = _two_process_mesh(rank, rows_each)
        parts = [b if mesh.owners[i] == rank else torch.empty(b.shape, device="meta")
                 for i, b in enumerate(blocks)]
        return mesh, sharding.temporal_halo(parts, lo, hi, ends=ends, mesh=mesh)

    for rank, (mesh, got) in enumerate(fake_group.run(rank_view)):
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape
            if mesh.owners[i] == rank:
                torch.testing.assert_close(g, w, rtol=0, atol=0)
            else:
                assert g.is_meta


@pytest.mark.parametrize("n,rows_each", [(7, [2, 2]), (3, [2, 2]), (5, [1, 3])],
                         ids=["uneven", "second-sits-out", "one-and-three"])
def test_gather_rows_across_processes_is_every_row_in_order(fake_group, n, rows_each):
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)

    def rank_view(rank):
        mesh = _two_process_mesh(rank, rows_each)
        parts, sizes = sharding.split_rows(x, mesh)
        outs = [(p * 2, p[:, :1] + 1) for p in parts]  # a tuple a row, as ResNet's
        return sharding.gather_rows(outs, CPU, sizes, mesh)

    for feats, first in fake_group.run(rank_view):
        np.testing.assert_array_equal(feats.numpy(), x * 2)
        np.testing.assert_array_equal(first.numpy(), x[:, :1] + 1)


class _Manifest:
    def __init__(self):
        self.rows = []

    def record(self, video, status, **kw):
        self.rows.append((status, kw.get("error_class")))

    def event(self, name, **kw):
        self.rows.append((name, None))


class _Step:
    """The failure policy of ``BaseExtractor`` (``_agree``, ``_on_failure``,
    ``_stop_on_sticky``) on a stand-in with a manifest that keeps rows."""

    _agree = BaseExtractor._agree
    _on_failure = BaseExtractor._on_failure
    _stop_on_sticky = BaseExtractor._stop_on_sticky
    _video_key = BaseExtractor._video_key

    def __init__(self):
        self.config = types.SimpleNamespace(retries=1, retry_backoff=0.0)
        self.manifest = _Manifest()
        self.telemetry = types.SimpleNamespace(
            metrics=types.SimpleNamespace(inc=lambda *a, **k: None))

    def _wall(self, entry):
        return None


FLAKE = faults.InjectedTransientError("flake")
STICKY = RuntimeError("CUDA error: an illegal memory access")


@pytest.mark.parametrize("errors,attempt,want_ok,want_rows,want_requeued", [
    ((None, None), 1, True, [[], []], 0),
    ((FLAKE, None), 1, False, [[("retry", "transient")]] * 2, 1),
    ((None, FLAKE), 2, False, [[("failed", "transient")]] * 2, 0),
    ((ValueError("bad input"), FLAKE), 1, False,
     [[("failed", "permanent")], [("failed", "transient")]], 0),
    ((None, STICKY), 1, "stopped", [[("failed", "permanent"), ("worker_death", None)]] * 2, 0),
], ids=["ok", "one-flake-retries-together", "out-of-retries", "worst-is-permanent",
        "sticky-stops-both"])
def test_lockstep_step_takes_the_worst_outcome_on_every_process(
        fake_group, errors, attempt, want_ok, want_rows, want_requeued):
    """Each process gives its own outcome of a step (an error or none);
    every process then takes the one decision of the worst: go on, retry
    together, record the failure, or stop. Each record keeps its own
    process's error class (another process's failure is a
    ``PeerFailure`` of the worst class)."""
    def rank_view(rank):
        step, requeued = _Step(), []
        try:
            ok = step._agree("v.mp4", "sink", attempt, errors[rank], requeued.append, CPU)
        except faults.LoopStopped:
            ok = "stopped"
        return ok, step.manifest.rows, len(requeued)

    for rank, (ok, rows, requeued) in enumerate(fake_group.run(rank_view)):
        assert (ok, rows, requeued) == (want_ok, want_rows[rank], want_requeued), rank


@pytest.mark.parametrize("cpu,local,cards,want", [
    (True, 2, 0, "gloo"), (True, 1, 8, "gloo"), (False, 2, 1, "gloo"), (False, 2, 2, "nccl"),
    (False, 4, 8, "nccl"), (False, 8, 4, "gloo"),
], ids=["cpu", "cpu-with-cards", "two-on-one-card", "a-card-each", "two-cards-each",
        "cards-shared"])
def test_backend_rule(cpu, local, cards, want):
    assert distributed.backend_for(cpu, local, cards) == want


def test_initialize_joins_a_mesh_under_a_launcher_only(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    try:
        assert not distributed.initialize(ExtractionConfig(cpu=True))  # queue mode: no group
        assert distributed.initialize(ExtractionConfig(cpu=True, sharding="mesh"))
        assert calls[-1][0] == "gloo" and calls[-1][1]["init_method"] == "env://"
        assert calls[-1][1]["timeout"] == distributed.TIMEOUT
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        bound = []
        monkeypatch.setattr(torch.cuda, "set_device", bound.append)
        for cards, want in ((1, "gloo"), (2, "nccl")):
            monkeypatch.setattr(torch.cuda, "device_count", lambda cards=cards: cards)
            assert distributed.initialize(ExtractionConfig(sharding="mesh"))
            assert calls[-1][0] == want
        # two cards, local rank 1 of 2: its own card, bound and named to NCCL
        assert bound == [torch.device("cuda", 1)]
        assert calls[-1][1]["device_id"] == torch.device("cuda", 1)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device is visible"):
            distributed.initialize(ExtractionConfig(sharding="mesh"))
    finally:
        distributed.shutdown()
