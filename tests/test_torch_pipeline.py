"""The port's pipelined loop (``--decode_workers``) and retry queue.

The serial and pipelined loops give the same features in the same
order; ``prepare`` runs on the decode threads with a bounded number of
payloads waiting; injected faults are retried to the same counts as in
the JAX package's serial loop; and a run of 6 clips with
``--fault_inject prepare:error:3`` ends 6/6 done.
"""

import pathlib
import threading
import time

import numpy as np
import pytest
import torch

from video_features_tpu.config import ExtractionConfig as JaxConfig
from video_features_tpu.extract.base import BaseExtractor as JaxBase
from video_features_tpu.io.video import stream_frames as jax_stream_frames
from video_features_tpu.runtime import faults as jax_faults
from video_features_tpu_torch import cli
from video_features_tpu_torch.config import ExtractionConfig
from video_features_tpu_torch.extract.base import BaseExtractor
from video_features_tpu_torch.extract.ingest import RequeueTimers
from video_features_tpu_torch.io.paths import video_path_of
from video_features_tpu_torch.io.video import stream_frames
from video_features_tpu_torch.models.clip import model as port_model
from video_features_tpu_torch.runtime import faults
from video_features_tpu_torch.utils.synth import synth_video

from test_torch_clip import SMALL

FT = "CLIP-ViT-B/32"


@pytest.fixture(autouse=True)
def _clear_injectors():
    yield
    faults.install_injector(None)
    jax_faults.install_injector(None)


@pytest.fixture(scope="module")
def toy_videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("toy_media")
    return [synth_video(str(d / f"v{i}.mp4"), n_frames=10, width=64, height=48, seed=i)
            for i in range(6)]


class Toy(BaseExtractor):
    """Per-frame means: one reader open (one 'decode' call) per prepare.
    ``delays`` stalls prepare per video, so later videos can finish their
    prepare first; the threads and the payloads in flight are recorded."""

    feature_type = "toy"
    delays = {}

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.prepare_threads, self.forward_threads = set(), set()
        self.waiting = self.most_waiting = 0
        self.lock = threading.Lock()

    def _build(self, device):
        return device

    def prepare(self, entry):
        time.sleep(self.delays.get(video_path_of(entry), 0.0))
        vals = [float(f.mean()) for f, _ in stream_frames(video_path_of(entry))]
        with self.lock:
            self.prepare_threads.add(threading.current_thread().name)
            self.waiting += 1
            self.most_waiting = max(self.most_waiting, self.waiting)
        return np.asarray(vals, np.float32)

    def forward(self, state, payload):
        with self.lock:
            self.forward_threads.add(threading.current_thread().name)
            self.waiting -= 1
        return {"toy": payload.reshape(-1, 1), "fps": np.array(25.0)}


def _cfg(videos, tmp_path, **kw):
    kw.setdefault("retry_backoff", 0.0)
    return ExtractionConfig(video_paths=list(videos), on_extraction="save_numpy",
                            output_path=str(tmp_path / "out"), tmp_path=str(tmp_path / "tmp"),
                            cpu=True, **kw)


@pytest.mark.parametrize("workers", [1, 2, 3])
def test_pipelined_matches_serial_in_order(toy_videos, tmp_path, monkeypatch, workers):
    monkeypatch.setattr(Toy, "delays", {toy_videos[0]: 0.05, toy_videos[2]: 0.03})
    order = [2, 0, 5, 3, 1, 4]
    serial = Toy(_cfg(toy_videos, tmp_path, decode_workers=0), external_call=True)
    ref = serial(order, torch.device("cpu"))
    ex = Toy(_cfg(toy_videos, tmp_path, decode_workers=workers), external_call=True)
    got = ex(order, torch.device("cpu"))
    assert len(got) == len(ref) == 6
    for a, b in zip(got, ref):
        assert np.array_equal(a["toy"], b["toy"]) and a["toy"].shape == (10, 1)
    assert serial.prepare_threads == {threading.current_thread().name}
    # prepare on the decode threads only, forward on the calling thread
    assert ex.forward_threads == {threading.current_thread().name}
    assert ex.prepare_threads and all(n.startswith("decode") for n in ex.prepare_threads)
    assert len(ex.prepare_threads) <= workers
    # at most workers + 1 payloads wait beyond the one being consumed
    assert ex.most_waiting <= workers + 2


def test_cli_decode_workers_0_and_2_write_the_same_files(tmp_path, monkeypatch):
    monkeypatch.setitem(port_model.CONFIGS, FT, port_model.CLIPVisionConfig(**SMALL))
    clips = [synth_video(str(tmp_path / f"c{i}.mp4"), n_frames=12, seed=i) for i in range(3)]
    outs = {}
    for workers in ("0", "2"):
        out = tmp_path / f"w{workers}"
        cli.main(["--feature_type", FT, "--cpu", "--allow_random_init", "--extract_method",
                  "uni_3", "--on_extraction", "save_numpy", "--output_path", str(out),
                  "--tmp_path", str(tmp_path / "tmp"), "--decode_workers", workers,
                  "--video_paths", *clips])
        outs[workers] = {p.name: np.load(p) for p in pathlib.Path(out).rglob("*.npy")}
        summary = faults.merge_manifest(str(out))
        assert (summary["done"], summary["failed"], summary["retries"]) == (3, 0, 0)
    assert sorted(outs["0"]) == sorted(outs["2"]) and len(outs["0"]) == 3
    for name, feats in outs["0"].items():
        assert feats.shape == (3, SMALL["embed_dim"])
        assert np.array_equal(feats, outs["2"][name])  # same code, same thread count per op


def test_prepare_faults_retry_to_six_of_six(toy_videos, tmp_path):
    """Every third prepare raises a transient error: each is retried
    (through a backoff timer) and the run ends 6/6 done, the files equal
    to a clean run's."""
    clean = Toy(_cfg(toy_videos, tmp_path, decode_workers=2), external_call=True)
    want = clean(device=torch.device("cpu"))
    cfg = _cfg(toy_videos, tmp_path, decode_workers=2, retries=2, retry_backoff=0.02,
               fault_inject=["prepare:error:3"])
    Toy(cfg)(device=torch.device("cpu"))
    summary = faults.finalize_run(cfg.output_path)
    assert (summary["done"], summary["failed"], summary["total"]) == (6, 0, 6)
    assert summary["retries"] >= 2
    retried = [v for v in summary["videos"].values() if v["attempts"] > 1]
    assert retried and all(v["status"] == "done" for v in retried)
    retry_rows = [r for r in faults.iter_manifest_records(cfg.output_path)
                  if r.get("status") == "retry"]
    assert all(r["stage"] == "prepare" and r["error_class"] == "transient" for r in retry_rows)
    for path, feats in zip(toy_videos, want):
        saved = np.load(pathlib.Path(cfg.output_path, "toy", pathlib.Path(path).stem + "_toy.npy"))
        assert np.array_equal(saved, feats["toy"])


@pytest.mark.parametrize("workers", [0, 1])
def test_retried_videos_come_back_in_order(toy_videos, tmp_path, workers):
    """A retry goes to the back of the queue; the caller still gets the
    results in the order of its indices (one decode thread keeps the
    injection's call order fixed)."""
    want = Toy(_cfg(toy_videos, tmp_path, decode_workers=0), external_call=True)(
        device=torch.device("cpu"))
    cfg = _cfg(toy_videos, tmp_path, decode_workers=workers, retries=2,
               fault_inject=["decode:error:3"])
    got = Toy(cfg, external_call=True)(device=torch.device("cpu"))
    assert len(got) == 6 and all(np.array_equal(a["toy"], b["toy"]) for a, b in zip(got, want))


def test_pipelined_permanent_failure_keeps_the_order(toy_videos, tmp_path, capsys):
    bad = tmp_path / "broken.mp4"
    bad.write_bytes(b"not a video")
    videos = [toy_videos[0], str(bad), toy_videos[1]]
    ex = Toy(_cfg(videos, tmp_path, decode_workers=2), external_call=True)
    got = ex(device=torch.device("cpu"))
    ref = Toy(_cfg(toy_videos[:2], tmp_path, decode_workers=0), external_call=True)(
        device=torch.device("cpu"))
    assert len(got) == 2 and all(np.array_equal(a["toy"], b["toy"]) for a, b in zip(got, ref))
    out = capsys.readouterr().out
    assert out.count("An error occurred extracting") == 1 and "retrying" not in out


class JaxToy(JaxBase):
    """The JAX package's loop around the same per-frame means."""

    feature_type = "toy"

    def _build(self, device):
        return {"device": device}

    def prepare(self, path_entry):
        vals = [float(f.mean()) for f, _ in jax_stream_frames(path_entry)]
        return np.asarray(vals, np.float32)

    def extract_prepared(self, device, state, path_entry, payload):
        return {"toy": np.asarray(payload).reshape(-1, 1), "fps": 25.0}


@pytest.mark.parametrize("specs,retries", [
    (["decode:error:2"], 1),
    (["decode:error:2", "sink:error:3"], 1),
    (["decode:error:1"], 2),
    (["decode:corrupt:3"], 2),
    (["sink:kill:4"], 0),
], ids=["decode-error", "decode-and-sink", "every-decode", "corrupt", "sink-kill"])
def test_serial_fault_counts_match_jax(toy_videos, tmp_path, specs, retries):
    """The same spec on the serial loop gives the same done, failed and
    retries in both packages."""
    videos = toy_videos[:4]
    kw = dict(decode_workers=0, retries=retries, retry_backoff=0.0, fault_inject=specs)
    port_cfg = _cfg(videos, tmp_path / "port", **kw)
    Toy(port_cfg)(device=torch.device("cpu"))
    jax_cfg = JaxConfig(video_paths=list(videos), on_extraction="save_numpy", cpu=True,
                        output_path=str(tmp_path / "jax" / "out"),
                        tmp_path=str(tmp_path / "jax" / "tmp"), **kw)
    JaxToy(jax_cfg)([0, 1, 2, 3], "cpu")
    ours = faults.merge_manifest(port_cfg.output_path)
    ref = jax_faults.merge_manifest(jax_cfg.output_path)
    counts = ("done", "failed", "retries", "total")
    assert {k: ours[k] for k in counts} == {k: ref[k] for k in counts}
    assert {k: (v["status"], v["attempts"], v.get("error_class")) for k, v in ours["videos"].items()} \
        == {k: (v["status"], v["attempts"], v.get("error_class")) for k, v in ref["videos"].items()}


def test_requeue_timers_count_until_fired():
    timers, fired = RequeueTimers(), []
    timers.schedule(0.0, lambda: fired.append("now"))
    assert fired == ["now"] and timers.pending() == 0
    timers.schedule(0.05, lambda: fired.append("later"))
    assert timers.pending() == 1
    deadline = time.monotonic() + 5
    while timers.pending() and time.monotonic() < deadline:
        timers.wait_any(0.05)
    assert timers.pending() == 0 and fired == ["now", "later"]
