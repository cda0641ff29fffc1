"""The port's serve daemon (``video_features_tpu_torch/serve/``) against
the JAX package's.

The stdlib pieces are held to the JAX package's on the same inputs: the
admission controller and schedulers on a fake clock give the same groups
in the same order, the service-time model the same predictions, and
each package's request tracker reads the other's records. The slice as
a whole: both packages' daemons, with the small CLIP tower, take the
same five requests through ``submit`` and the inline drain, and their
feature files agree within 1e-4; a repeat is a cache hit in both. Then
one test each for the real dispatcher thread, the HTTP door on port 0,
the spool watcher, a group stopped by a sticky device error (the daemon
then stops for every model: refused admission, 503s, no spool claim, and
``serve_main`` returning 1), and ``--preempt``, ``--hbm_budget_bytes``
and the preemptor's tuning flags parsed and validated as the JAX
package's.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from video_features_tpu.config import parse_serve_args as jax_parse_serve_args
from video_features_tpu.models.clip import model as jax_model
from video_features_tpu.serve import batcher as jax_batcher
from video_features_tpu.serve import costmodel as jax_costmodel
from video_features_tpu.serve import lifecycle as jax_lifecycle
from video_features_tpu.serve import scheduler as jax_scheduler
from video_features_tpu.serve.daemon import ServeDaemon as JaxServeDaemon
from video_features_tpu_torch import cli
from video_features_tpu_torch.config import parse_serve_args
from video_features_tpu_torch.models.clip import model as port_model
from video_features_tpu_torch.runtime import faults
from video_features_tpu_torch.serve import batcher, costmodel, lifecycle, scheduler
from video_features_tpu_torch.serve.daemon import ServeDaemon, serve_main
from video_features_tpu_torch.serve.supervisor import DaemonStopped
from video_features_tpu_torch.serve.sources import SpoolWatcher, parse_spool_name
from video_features_tpu_torch.utils.synth import synth_video

from test_torch_clip import SMALL, openai_state_dict
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.serve

FT = "CLIP-ViT-B/32"
ATOL = 1e-4


class FakeClock:
    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.fixture(scope="module")
def serve_videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_media")
    return [synth_video(str(d / f"v{i}.mp4"), n_frames=10, width=64, height=48, seed=i)
            for i in range(6)]


@pytest.fixture
def small_tower(monkeypatch):
    """Both packages' CLIP-ViT-B/32 become the small tower."""
    monkeypatch.setitem(port_model.CONFIGS, FT, port_model.CLIPVisionConfig(**SMALL))
    monkeypatch.setitem(jax_model.CONFIGS, FT, jax_model.CLIPVisionConfig(**SMALL))


@pytest.fixture
def weights(tmp_path):
    path = str(tmp_path / "clip_small.npz")
    np.savez(path, **openai_state_dict())
    return path


def _argv(tmp_path, name, weights, *extra):
    return ["--feature_types", FT, "--cpu", "--weights_path", weights,
            "--extract_method", "uni_3", "--heartbeat_s", "0",
            "--output_path", str(tmp_path / name / "out"),
            "--tmp_path", str(tmp_path / name / "tmp"), *extra]


def _daemon(tmp_path, weights, *extra, name="port"):
    return ServeDaemon(parse_serve_args(_argv(tmp_path, name, weights, *extra)))


def _wait(pred, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


# --- the stdlib pieces against the JAX package's ------------------------------

# (arrival time, feature type, bucket, priority, deadline_ms); the sweeps
# of the fake clock fall between arrivals
STREAM = [
    (0.000, "resnet18", "64x48", 0, None),
    (0.004, "resnet18", "64x48", 3, None),
    (0.010, "CLIP-ViT-B/32", "640x480", 0, 200.0),
    (0.012, "resnet18", "32x32", 9, None),
    (0.020, "resnet18", "64x48", 0, 50.0),
    (0.030, "CLIP-ViT-B/32", "640x480", 1, None),
    (0.031, "CLIP-ViT-B/32", "640x480", 0, None),
    (0.040, "resnet18", "64x48", 0, None),
    (0.070, "resnet18", "32x32", 0, 20.0),
    (0.090, "CLIP-ViT-B/32", "640x480", 5, None),
]
SWEEPS = [0.035, 0.06, 0.08, 0.2]


def _groups(batcher_mod, lifecycle_mod, scheduler_mod, name):
    clock = FakeClock()
    got = []
    ctl = batcher_mod.AdmissionController(
        dispatch=lambda key, reqs: got.append((key, [r.id for r in reqs])),
        max_group_size=3, max_batch_wait_s=0.025, max_queue=64, clock=clock,
        scheduler=scheduler_mod.build_scheduler(name, default_slack_s=0.1, aging_s=0.05),
    )
    sweeps = list(SWEEPS)
    for i, (t, ft, bucket, pri, dl) in enumerate(STREAM):
        while sweeps and sweeps[0] <= t:
            clock.t = sweeps.pop(0)
            for key, reqs in ctl.take_ready():
                got.append((key, [r.id for r in reqs]))
        clock.t = t
        ctl.admit(lifecycle_mod.ExtractionRequest(
            feature_type=ft, video_path=f"/v{i}.mp4", bucket=bucket, id=f"r{i}",
            priority=pri, deadline_ms=dl))
    for t in sweeps:
        clock.t = t
        for key, reqs in ctl.take_ready():
            got.append((key, [r.id for r in reqs]))
    ctl.close(drain=True)
    return got


@pytest.mark.parametrize("name", ["edf", "fifo"])
def test_admission_and_scheduler_match_jax(name):
    ours = _groups(batcher, lifecycle, scheduler, name)
    ref = _groups(jax_batcher, jax_lifecycle, jax_scheduler, name)
    assert ours == ref
    assert sorted(i for _, ids in ours for i in ids) == sorted(f"r{i}" for i in range(len(STREAM)))
    assert all(len(ids) <= 3 for _, ids in ours)


def test_concurrent_admission_dispatches_each_request_once():
    """More admitting threads than cores against the real dispatcher
    thread, with a short switch interval: every request lands in exactly
    one group and the depth returns to 0 (a lost update would break
    either)."""
    import sys
    import threading

    seen, lock = [], threading.Lock()

    def dispatch(key, reqs):
        with lock:
            seen.extend(r.id for r in reqs)

    ctl = batcher.AdmissionController(dispatch=dispatch, max_group_size=3,
                                      max_batch_wait_s=0.002, max_queue=10_000)
    ctl.start()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def admit(t):
            for i in range(40):
                ctl.admit(lifecycle.ExtractionRequest(
                    feature_type=FT, video_path="/v.mp4", bucket=f"b{i % 3}", id=f"{t}-{i}"))

        threads = [threading.Thread(target=admit, args=(t,)) for t in range(2 * os.cpu_count())]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        ctl.close(drain=True)
    finally:
        sys.setswitchinterval(interval)
    assert sorted(seen) == sorted(f"{t}-{i}" for t in range(len(threads)) for i in range(40))
    assert ctl.depth() == 0


def test_cost_model_predictions_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    ours, ref = costmodel.ServiceTimeModel(), jax_costmodel.ServiceTimeModel()
    keys = [("CLIP-ViT-B/32", "640x480"), ("i3d", "~"), ("resnet50", "64x48")]
    for _ in range(40):
        key = keys[int(rng.integers(len(keys)))]
        n, s = int(rng.integers(1, 9)), float(rng.uniform(0.01, 2.0))
        ours.observe(key[0], key[1], n, s)
        ref.observe(key[0], key[1], n, s)
    for key in keys + [("resnet18", "1x1"), ("pwc", "~")]:
        for n in (1, 4, 8):
            assert abs(ours.predict(key, n) - ref.predict(key, n)) <= 1e-12
    # either package's persisted model warm-starts the other's
    ref.save(str(tmp_path / "m.json"))
    back = costmodel.ServiceTimeModel(path=str(tmp_path / "m.json"))
    assert abs(back.predict(keys[0], 4) - ref.predict(keys[0], 4)) <= 1e-12
    assert costmodel.default_model_path(type("C", (), {"output_path": "o"})()) == \
        os.path.join("o", "_telemetry", costmodel.MODEL_FILENAME)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tracker_reads_the_other_packages_records(tmp_path, writer):
    mods = {"port": lifecycle, "jax": jax_lifecycle}
    w, r = mods[writer], mods["jax" if writer == "port" else "port"]
    tw = w.RequestTracker(str(tmp_path), replica_id="a")
    done = w.ExtractionRequest(feature_type=FT, video_path="/x.mp4", id="req-1", priority=2)
    tw.admit(done)
    tw.dispatched(done, group_size=1)
    tw.finish(done, "done", features=["/o/x.npy"])
    stuck = w.ExtractionRequest(feature_type=FT, video_path="/y.mp4", id="req-2")
    tw.admit(stuck)  # a dead process's queued request
    getattr(tw.manifest, "close", lambda: None)()  # flushed per line in both
    tr = r.RequestTracker(str(tmp_path), replica_id="b")
    assert tr.get("req-1")["state"] == "done" and tr.get("req-1")["features"] == ["/o/x.npy"]
    assert tr.reconcile() == {"requeued": 0, "interrupted": 1}
    assert tr.get("req-2")["state"] == "failed"
    assert tr.get("req-2")["error_class"] == "interrupted"


def test_spool_name_hints_match_jax():
    from video_features_tpu.serve.sources import parse_spool_name as jax_parse

    for name in ("clip.p7.d500", "a.d20.p3", "x", "p9", "v.p10"):
        assert parse_spool_name(name) == jax_parse(name)


# --- the slice as a whole -----------------------------------------------------


def _drain_five(daemon, videos):
    for i, v in enumerate(videos[:5]):
        daemon.submit({"feature_type": FT, "video_path": v, "id": f"req-{i}",
                       "bucket": "64x48"}, source="local")
    daemon.batcher.close(drain=True)  # inline drain on this thread
    return {f"req-{i}": daemon.tracker.get(f"req-{i}") for i in range(5)}


def test_daemons_agree_and_repeat_from_the_cache(tmp_path, serve_videos, small_tower, weights):
    port = _daemon(tmp_path, weights, "--max_group_size", "3", "--cache_dir",
                   str(tmp_path / "port" / "cache"))
    jax_d = JaxServeDaemon(jax_parse_serve_args(
        _argv(tmp_path, "jax", weights, "--max_group_size", "3", "--decoder", "cv2",
              "--cache_dir", str(tmp_path / "jax" / "cache"))))
    try:
        ours, ref = _drain_five(port, serve_videos), _drain_five(jax_d, serve_videos)
        for rid in ours:
            assert ours[rid]["state"] == ref[rid]["state"] == "done", (ours[rid], ref[rid])
            (a,), (b,) = ours[rid]["features"], ref[rid]["features"]
            assert os.path.basename(a) == os.path.basename(b)
            x, y = np.load(a), np.load(b)
            assert x.shape == y.shape == (3, SMALL["embed_dim"])
            np.testing.assert_allclose(x, y, atol=ATOL)
        assert port.pool.build_count == {FT: 1}
        # a repeat is terminal 'done' at admission in both: a cache hit
        for d in (port, jax_d):
            rec = d.submit({"feature_type": FT, "video_path": serve_videos[0],
                            "id": "again"}, source="local")
            assert rec["state"] == "done"
            assert d.stats()["cache"]["hits"] == 1 and d.stats()["cache"]["misses"] == 5
        assert np.array_equal(np.load(port.tracker.get("again")["features"][0]),
                              np.load(ours["req-0"]["features"][0]))
    finally:
        port.shutdown()
        jax_d.shutdown()
    # the two packages' cache entries never mix: a different digest each
    assert os.listdir(tmp_path / "port" / "cache") and os.listdir(tmp_path / "jax" / "cache")


def test_dispatcher_thread_end_to_end(tmp_path, serve_videos, small_tower, weights):
    d = _daemon(tmp_path, weights, "--max_batch_wait_ms", "10", "--max_group_size", "2")
    d.batcher.start()
    try:
        for i in range(3):
            d.submit({"feature_type": FT, "video_path": serve_videos[i], "id": f"t-{i}"},
                     source="local")
        assert _wait(lambda: all((d.tracker.get(f"t-{i}") or {}).get("state") == "done"
                                 for i in range(3)))
    finally:
        d.shutdown()
    assert d.tracker.counts()["done"] == 3


def _post(port, payload, path="/v1/extract"):
    data = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.load(resp)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
            body = resp.read().decode()
            return resp.status, (json.loads(body) if path != "/metrics" else body)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def test_http_door_on_port_0(tmp_path, serve_videos, small_tower, weights):
    from video_features_tpu_torch.telemetry.exposition import validate_exposition

    d = _daemon(tmp_path, weights, "--port", "0", "--max_batch_wait_ms", "10")
    d.start()
    try:
        port = d.http_port
        code, rec = _post(port, {"feature_type": FT, "video_path": serve_videos[0], "id": "h-0"})
        assert code == 202 and rec["state"] == "queued"
        assert _wait(lambda: d.tracker.get("h-0")["state"] == "done")
        code, got = _get(port, "/v1/requests/h-0")
        assert code == 200 and got["state"] == "done" and got["features"]
        assert _get(port, "/v1/requests/nope")[0] == 404
        code, health = _get(port, "/healthz")
        assert code == 200 and health["status"] == "ok" and health["warm"] == [FT]
        code, text = _get(port, "/metrics")
        assert code == 200 and validate_exposition(text) == []
        assert "vft_stage_seconds" in text and "vft_slo_latency_seconds" in text
        assert _post(port, b"{not json")[0] == 400
        assert _post(port, {"feature_type": "resnet18", "video_path": serve_videos[0]})[0] == 400
    finally:
        d.shutdown()


def test_spool_watcher(tmp_path, serve_videos, small_tower, weights):
    d = _daemon(tmp_path, weights, "--max_batch_wait_ms", "10")
    spool = str(tmp_path / "spool")
    d.batcher.start()
    w = SpoolWatcher(d, spool, poll_s=0.02)
    w.start()
    try:
        with open(os.path.join(spool, ".t.tmp"), "w") as fh:
            json.dump({"feature_type": FT, "video_path": serve_videos[0], "id": "t-0"}, fh)
        os.replace(os.path.join(spool, ".t.tmp"), os.path.join(spool, "t.p3.json"))
        with open(os.path.join(spool, "bad.json"), "w") as fh:
            fh.write("{not json")
        assert _wait(lambda: (d.tracker.get("t-0") or {}).get("state") == "done")
        assert _wait(lambda: os.path.exists(os.path.join(spool, "bad.json.bad")))
    finally:
        w.stop()
        d.shutdown()
    assert d.tracker.get("t-0")["priority"] == 3


def test_sticky_error_fails_the_group_without_retry(tmp_path, serve_videos, small_tower,
                                                    weights, monkeypatch):
    """A sticky device error in a fused group: every member ends failed
    with a terminal record, nothing is retried, and the daemon stops for
    every model: /healthz's status names the error, and a second model's
    request is refused, recorded nowhere and never run."""
    d = _daemon(tmp_path, weights, "--feature_types", FT, "resnet18", "--max_group_size", "3",
                "--fault_inject", "dispatch:error:1", "--retries", "2")
    # the injected error, read as sticky: a CUDA error poisons the process
    monkeypatch.setattr(faults, "is_sticky", lambda exc: "injected fault" in str(exc))
    try:
        for i in range(3):
            d.submit({"feature_type": FT, "video_path": serve_videos[i], "id": f"s-{i}",
                      "bucket": "64x48"}, source="local")
        d.batcher.close(drain=True)
        recs = [d.tracker.get(f"s-{i}") for i in range(3)]
        assert [r["state"] for r in recs] == ["failed"] * 3, recs
        assert all(r.get("message") for r in recs)
        summary = faults.merge_manifest(str(tmp_path / "port" / "out"))
        assert summary["retries"] == 0 and summary["failed"] == 3
        health = d.status()
        assert health["status"] == "stopped" and "injected fault" in health["error"]
        assert d.stop_requested.is_set()
        for ft, rid in ((FT, "s-3"), ("resnet18", "r-0")):
            with pytest.raises(DaemonStopped, match="injected fault"):
                d.submit({"feature_type": ft, "video_path": serve_videos[3], "id": rid},
                         source="local")
            assert d.tracker.get(rid) is None
        assert "resnet18" not in d.pool.feature_types()  # never built
    finally:
        d.shutdown(drain=False)


def test_sticky_error_stops_http_and_spool(tmp_path, serve_videos, small_tower, weights,
                                           monkeypatch):
    """After a sticky group the HTTP door answers 503 (health and submit),
    the spool watcher claims nothing more and the replica's heartbeat
    stops; queued work leaves by the shutdown contract."""
    spool = tmp_path / "spool"
    # a lone request runs the serial loop: the group itself raises the
    # sticky error here (the serve stage 'extractor'), not its loop
    d = _daemon(tmp_path, weights, "--feature_types", FT, "resnet18", "--port", "0",
                "--max_batch_wait_ms", "10", "--spool_dir", str(spool), "--spool_poll_s",
                "0.02", "--fault_inject", "extractor:error:1", "--retries", "0")
    monkeypatch.setattr(faults, "is_sticky", lambda exc: "injected fault" in str(exc))
    d.start()
    try:
        port = d.http_port
        code, _ = _post(port, {"feature_type": FT, "video_path": serve_videos[0], "id": "h-0"})
        assert code == 202
        assert _wait(lambda: d.stopped_by is not None)
        assert _wait(lambda: d.tracker.get("h-0")["state"] == "failed")
        code, health = _get(port, "/healthz")
        assert code == 503 and health["status"] == "stopped"
        assert "injected fault" in health["error"]
        code, body = _post(port, {"feature_type": "resnet18", "video_path": serve_videos[1],
                                  "id": "h-1"})
        assert code == 503 and "injected fault" in body["error"]
        assert d.tracker.get("h-1") is None
        beat = os.stat(d.registry.path).st_mtime_ns
        with open(spool / ".late.tmp", "w") as fh:
            json.dump({"feature_type": FT, "video_path": serve_videos[2], "id": "late"}, fh)
        os.replace(spool / ".late.tmp", spool / "late.json")
        time.sleep(0.3)  # 15 poll intervals of a live watcher
        assert sorted(os.listdir(spool)) == ["late.json"]
        assert d.tracker.get("late") is None
        assert os.stat(d.registry.path).st_mtime_ns == beat
    finally:
        d.shutdown(drain=False)


def test_serve_main_exits_nonzero_after_a_sticky_error(tmp_path, serve_videos, small_tower,
                                                       weights, monkeypatch):
    """``serve`` ends by itself after a sticky group (no signal), shuts
    down without draining and returns 1 for a supervisor to restart it."""
    spool = tmp_path / "spool"
    spool.mkdir()
    with open(spool / "first.json", "w") as fh:
        json.dump({"feature_type": FT, "video_path": serve_videos[0], "id": "m-0"}, fh)
    monkeypatch.setattr(faults, "is_sticky", lambda exc: "injected fault" in str(exc))
    argv = _argv(tmp_path, "main", weights, "--max_batch_wait_ms", "10", "--spool_dir",
                 str(spool), "--spool_poll_s", "0.02", "--fault_inject", "extractor:error:1",
                 "--retries", "0")
    got = []
    runner = threading.Thread(target=lambda: got.append(serve_main(argv)))
    runner.start()
    runner.join(timeout=120)
    assert not runner.is_alive() and got == [1]
    with open(os.path.join(lifecycle.requests_root(str(tmp_path / "main" / "out")),
                           "m-0.json")) as fh:
        rec = json.load(fh)
    assert rec["state"] == "failed" and "injected fault" in rec["message"]


def _serve_decision(parse, argv):
    """(the preemption fields parsed, or the refusal's kind and text)."""
    try:
        scfg = parse(argv)
    except ValueError as exc:
        return ("refused", str(exc))
    except SystemExit:
        return ("argparse", None)
    return (scfg.preempt, scfg.hbm_budget_bytes, scfg.preempt_cooldown_s,
            scfg.preempt_min_residency_s)


@pytest.mark.parametrize("flags", [["--preempt", "on"], ["--hbm_budget_bytes", "1000"]],
                         ids=["preempt", "hbm_budget"])
def test_refused_serve_flags(tmp_path, flags, capsys):
    """``--preempt on`` and a non-zero ``--hbm_budget_bytes`` parse and
    validate as the JAX package's do (a negative budget is refused)."""
    base = ["--feature_types", FT, "--cpu", "--output_path", str(tmp_path / "o")]
    for extra in (flags, ["--hbm_budget_bytes", "-5", *flags], [*flags, "--preempt", "maybe"]):
        ours = _serve_decision(parse_serve_args, base + extra)
        assert ours == _serve_decision(jax_parse_serve_args, base + extra), extra
    assert _serve_decision(parse_serve_args, base + flags) == (
        ("on", 0, 30.0, 60.0) if flags[0] == "--preempt" else ("off", 1000, 30.0, 60.0))
    assert _serve_decision(parse_serve_args, base + ["--hbm_budget_bytes", "-5"])[0] == "refused"
    capsys.readouterr()  # argparse's usage lines


@pytest.mark.parametrize("flag", ["--preempt_cooldown_s", "--preempt_min_residency_s"])
def test_preemptor_tuning_flags_are_not_parsed(tmp_path, flag, capsys):
    """The preemptor's tuning flags parse, and validate (>= 0), as the
    JAX package's do."""
    base = ["--feature_types", FT, "--cpu", "--output_path", str(tmp_path / "o"),
            "--preempt", "on"]
    for value in ("5", "0", "-1", "x"):
        ours = _serve_decision(parse_serve_args, base + [flag, value])
        assert ours == _serve_decision(jax_parse_serve_args, base + [flag, value]), value
    assert _serve_decision(parse_serve_args, base + [flag, "5"]) == (
        ("on", 0, 5.0, 60.0) if flag == "--preempt_cooldown_s" else ("on", 0, 30.0, 5.0))
    assert _serve_decision(parse_serve_args, base + [flag, "-1"])[0] == "refused"
    capsys.readouterr()


def test_serve_without_cpu_needs_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve", "--feature_types", FT, "--allow_random_init",
                  "--output_path", str(tmp_path / "o"), "--tmp_path", str(tmp_path / "t")])
