"""The port's async ingest pieces and the four run-contract repairs.

- ``extract/ingest.py``: the completion queue drains in FIFO order and
  probes only its head; the CPU placement and fetch pass arrays through;
- the ``--video_batch`` / ``--inflight_groups`` flags take the JAX
  package's defaults and fail its checks with its messages;
- decode notes (no fps, a truncated stream) reach the manifest as the
  JAX package's warnings, so ``--strict`` fails such a clip;
- a sticky device error stops the loop after one ``worker_death``, and
  ``--resume`` runs the videos it left;
- more than one ``--device_ids`` parses and resolves to that many cards;
- two containers with one stem rip their audio to distinct files.
"""

import os
import pathlib
import threading

import numpy as np
import pytest
import torch

from video_features_tpu.config import ExtractionConfig as JaxConfig
from video_features_tpu.config import sanity_check as jax_sanity_check
from video_features_tpu.extract.base import BaseExtractor as JaxBase
from video_features_tpu.io.video import stream_frames as jax_stream_frames
from video_features_tpu.runtime import faults as jax_faults
from video_features_tpu_torch import cli
from video_features_tpu_torch.config import ExtractionConfig, parse_args, sanity_check
from video_features_tpu_torch.devices import resolve_device
from video_features_tpu_torch.parallel.devices import resolve_devices
from video_features_tpu_torch.extract import ingest
from video_features_tpu_torch.extract.base import BaseExtractor
from video_features_tpu_torch.io import ffmpeg
from video_features_tpu_torch.io.paths import video_path_of
from video_features_tpu_torch.io.video import stream_frames
from video_features_tpu_torch.models.clip import model as port_model
from video_features_tpu_torch.runtime import faults
from video_features_tpu_torch.utils.synth import synth_video

from hostile_media import _patch_fps_zero, _truncate, _write_avi_mjpg
from test_torch_clip import SMALL

STICKY = "CUDA error: an illegal memory access was encountered"


@pytest.fixture(autouse=True)
def _clear_injectors():
    yield
    faults.install_injector(None)
    jax_faults.install_injector(None)


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """Four good clips, an AVI whose header has no usable fps, and an AVI
    cut to half its bytes (22 of 60 declared frames decode)."""
    d = tmp_path_factory.mktemp("ingest_media")
    good = [synth_video(str(d / f"v{i}.mp4"), n_frames=8, width=64, height=48, seed=i)
            for i in range(4)]
    fps_zero = _patch_fps_zero(_write_avi_mjpg(str(d / "fps_base.avi"), n_frames=12),
                               str(d / "fps_zero.avi"))
    truncated = _truncate(_write_avi_mjpg(str(d / "full.avi"), n_frames=60),
                          str(d / "truncated.avi"), 0.5)
    return {"good": good, "fps_zero": fps_zero, "truncated": truncated}


# --- ingest pieces ------------------------------------------------------------

class Pending(ingest.HostCopy):
    """A CPU copy whose readiness the test sets."""

    __slots__ = ("landed",)

    def __init__(self, value):
        super().__init__(torch.tensor([value]))
        self.landed = False

    def ready(self):
        return self.landed


def test_completion_queue_is_fifo_and_probes_only_its_head():
    q = ingest.CompletionQueue(2)
    assert q.depth == 2 and not q and not q.head_ready()
    first, second = Pending(1.0), Pending(2.0)
    q.push(["a"], (first, {"meta": 1}), False, None)
    q.push(["b"], [second], True, ["payload"])
    assert len(q) == 2 and q.full
    second.landed = True
    assert not q.head_ready()  # the second has landed, the head has not
    first.landed = True
    assert q.head_ready()
    assert q.pop()[0] == ["a"]
    slots, handle, grouped, payloads = q.pop()
    assert (slots, grouped, payloads) == (["b"], True, ["payload"])
    assert not q and ingest.CompletionQueue(0).depth == 1


def test_cpu_placement_and_fetch_pass_arrays_through():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    t = ingest.place_batch(x, torch.device("cpu"))
    assert t.dtype == torch.float32 and np.shares_memory(t.numpy(), x)
    got = ingest.HostCopy(t * 2)
    assert got.ready() and ingest.handle_ready(({"k": [got]}, 3, "meta"))
    assert np.array_equal(got.numpy(), 2 * x)
    stacked = ingest.stack_group([x, x + 1], pad_to=4)
    assert stacked.shape == (4, 3, 4) and not stacked[2:].any()


# --- flags --------------------------------------------------------------------

def test_ingest_flags_take_the_jax_defaults():
    ours, ref = parse_args(["--feature_type", "resnet18"]), JaxConfig()
    assert (ours.video_batch, ours.inflight_groups) == (1, 2)
    assert (ref.video_batch, ref.inflight_groups) == (1, 2)
    ours = parse_args(["--feature_type", "resnet18", "--video_batch", "4",
                       "--inflight_groups", "3"])
    assert (ours.video_batch, ours.inflight_groups) == (4, 3)


@pytest.mark.parametrize("kw", [
    dict(video_batch=0),
    dict(video_batch=4, decode_workers=0),
    dict(inflight_groups=0),
], ids=["video_batch-0", "needs-decode-workers", "inflight-0"])
def test_ingest_checks_match_jax(kw):
    with pytest.raises(ValueError) as ours:
        sanity_check(ExtractionConfig(feature_type="resnet18", **kw))
    with pytest.raises(ValueError) as ref:
        jax_sanity_check(JaxConfig(feature_type="resnet18", **kw))
    assert str(ours.value) == str(ref.value)


def test_more_than_one_device_id_parses_and_resolves(monkeypatch):
    cfg = parse_args(["--feature_type", "resnet18", "--device_ids", "0", "1"])
    assert cfg.device_ids == [0, 1] and cfg.sharding == "queue"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert resolve_devices(cfg) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert resolve_device(cfg) == torch.device("cuda", 0)
    assert parse_args(["--feature_type", "resnet18", "--device_ids", "0"]).device_ids == [0]


# --- the audio rip's names ----------------------------------------------------

def test_same_stem_containers_rip_to_distinct_files(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(ffmpeg, "require_ffmpeg", lambda: "ffmpeg")
    monkeypatch.setattr(ffmpeg, "_run", lambda cmd, timeout_s=None: calls.append(cmd))
    tmp = str(tmp_path / "tmp")
    rips = [ffmpeg.extract_wav_from_video(str(tmp_path / d / "x.mp4"), tmp) for d in ("a", "b")]
    assert len({p for rip in rips for p in rip}) == 4  # two wavs, two aacs
    for (wav, aac), d in zip(rips, ("a", "b")):
        assert os.path.dirname(wav) == tmp and pathlib.Path(wav).name.startswith("x_")
        assert wav.endswith(".wav") and aac.endswith(".aac")
    assert rips[0] == ffmpeg.extract_wav_from_video(str(tmp_path / "a" / "x.mp4"), tmp)
    assert [c[-1] for c in calls[:2]] == [rips[0][1], rips[0][0]]


# --- decode notes -------------------------------------------------------------

class Means(BaseExtractor):
    """Per-frame means; ``sticky`` names a video whose forward raises a
    sticky CUDA error, ``forwarded`` lists the videos that reached it."""

    feature_type = "toy"
    sticky = None

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.forwarded = []
        self.lock = threading.Lock()

    def _build(self, device):
        return device

    def prepare(self, entry):
        path = video_path_of(entry)
        return path, np.asarray([float(f.mean()) for f, _ in stream_frames(path)], np.float32)

    def forward(self, state, payload):
        path, vals = payload
        with self.lock:
            self.forwarded.append(path)
        if path == self.sticky:
            raise RuntimeError(STICKY)
        return {"toy": vals.reshape(-1, 1), "fps": np.array(25.0)}


class JaxMeans(JaxBase):
    feature_type = "toy"

    def _build(self, device):
        return {"device": device}

    def prepare(self, path_entry):
        return np.asarray([float(f.mean()) for f, _ in jax_stream_frames(path_entry, None, "cv2")],
                          np.float32)

    def extract_prepared(self, device, state, path_entry, payload):
        return {"toy": np.asarray(payload).reshape(-1, 1), "fps": 25.0}


def _cfg(videos, out, **kw):
    kw.setdefault("retry_backoff", 0.0)
    return ExtractionConfig(video_paths=list(videos), on_extraction="save_numpy",
                            output_path=str(out), tmp_path=str(out) + "_tmp", cpu=True, **kw)


def _warnings(summary):
    return sorted((w["video"], w["stage"], w["kind"], w["message"]) for w in summary["warnings"])


@pytest.mark.parametrize("workers", [0, 2], ids=["serial", "pipelined"])
def test_decode_notes_reach_the_manifest_as_in_jax(media, tmp_path, workers):
    """No fps and a truncated stream are warnings in both packages' manifests,
    with the same stage, kind and message, so ``--strict`` fails both runs."""
    videos = [media["good"][0], media["fps_zero"], media["truncated"]]
    port_cfg = _cfg(videos, tmp_path / "port", decode_workers=workers, preflight="off")
    Means(port_cfg)(device=torch.device("cpu"))
    jax_cfg = JaxConfig(video_paths=videos, on_extraction="save_numpy", cpu=True, decoder="cv2",
                        preflight="off",
                        decode_workers=workers, output_path=str(tmp_path / "jax"),
                        tmp_path=str(tmp_path / "jax_tmp"))
    JaxMeans(jax_cfg)([0, 1, 2], "cpu")
    ours = faults.merge_manifest(port_cfg.output_path)
    ref = jax_faults.merge_manifest(jax_cfg.output_path)
    assert _warnings(ours) == _warnings(ref)
    assert {w[2] for w in _warnings(ours)} == {"fps_defaulted", "partial_decode"}
    assert ours["done"] == ref["done"] == 3
    assert len(faults.strict_failures(ours)) == len(jax_faults.strict_failures(ref)) == 2
    partial = next(w for w in ours["warnings"] if w["kind"] == "partial_decode")
    assert (partial["decoded"], partial["declared"]) == (22, 60)


@pytest.mark.parametrize("kind", ["fps_zero", "truncated"])
def test_strict_cli_fails_a_clip_with_a_decode_note(media, tmp_path, monkeypatch, kind):
    monkeypatch.setitem(port_model.CONFIGS, "CLIP-ViT-B/32", port_model.CLIPVisionConfig(**SMALL))
    out = tmp_path / "out"
    with pytest.raises(SystemExit, match="--strict") as exc:
        cli.main(["--feature_type", "CLIP-ViT-B/32", "--cpu", "--allow_random_init",
                  "--extract_method", "uni_3", "--on_extraction", "save_numpy", "--strict",
                  "--output_path", str(out), "--tmp_path", str(tmp_path / "tmp"),
                  "--video_paths", media[kind]])
    assert "warning" in str(exc.value)
    assert len(list(out.rglob("*.npy"))) == 1  # the features are still written


# --- a sticky device error ----------------------------------------------------

@pytest.mark.parametrize("workers", [0, 2], ids=["serial", "pipelined"])
def test_sticky_error_stops_the_loop_and_resume_runs_the_rest(media, tmp_path, monkeypatch,
                                                              workers, capsys):
    videos = media["good"]
    monkeypatch.setattr(Means, "sticky", videos[1])
    cfg = _cfg(videos, tmp_path / "out", decode_workers=workers)
    ex = Means(cfg)
    ex(device=torch.device("cpu"))
    assert ex.forwarded == videos[:2]  # nothing reaches the device after the error
    summary = faults.finalize_run(cfg.output_path)
    assert summary["videos"][videos[0]]["status"] == "done"
    assert summary["videos"][videos[1]]["status"] == "failed"
    assert summary["videos"][videos[1]]["error_class"] == "permanent"
    assert all(v not in summary["videos"] for v in videos[2:])  # unattempted
    (death,) = summary["worker_deaths"]
    assert death["device"] == "cpu" and STICKY in death["message"]
    assert any("worker death" in p for p in faults.strict_failures(summary))
    assert "Stopping" in capsys.readouterr().out

    monkeypatch.setattr(Means, "sticky", None)
    again = Means(_cfg(videos, tmp_path / "out", decode_workers=workers, resume=True))
    again(device=torch.device("cpu"))
    assert again.forwarded == videos[2:]  # the unattempted ones; the failed one is skipped
    assert faults.merge_manifest(cfg.output_path)["done"] == 3
