"""The port's run telemetry (``runtime/telemetry.py``, ``telemetry/``)
against the JAX package's.

- The pure functions (``overlap_report``, ``utilization_report``,
  ``spans_to_chrome_trace``, ``merge_metrics_files`` / ``collect`` on
  files written by each package, ``heartbeat_line`` on a fixed clock,
  ``payload_nbytes``) give equal results on the same inputs.
- The span schema is byte-equal to the JAX package's, and every row a run
  writes validates against it.
- A tiny CLIP through each package's real pipelined loop
  (``--decode_workers 2 --video_batch 2``, 3 clips) leaves the same
  multiset of (video, stage, group size), the same counters and gauges,
  equal ``videos_done`` / ``frames_decoded`` / ``retries`` /
  ``h2d_bytes``, the same keys in ``summary.json``'s telemetry block, and
  the JAX package's ``_telemetry/`` files but its cost ledger
  (``cost_ledger.json``, left for serve). The payloads have the same
  dtypes and shapes in both modes, so ``h2d_bytes`` is equal at
  ``--preprocess host`` (float32 frames) and at ``device`` (uint8 frames
  and their taps). What differs at ``device`` is one counter: the JAX
  package's recompile watch counts XLA's ``compiles``, which the port
  leaves out (eager PyTorch compiles no shape).
- The behaviour cases of ``tests/test_telemetry.py``: ``--telemetry off``
  writes nothing and keeps the timer, a failure record links its span,
  nested and cross-thread spans, a flush concurrent with recording, and
  the ``export`` / ``report`` CLI with its usage errors.

Every JAX config passes ``decoder="cv2"`` (the native decoder aborts the
process on a decode thread here).
"""

import glob
import json
import os
import threading
from collections import Counter
from types import SimpleNamespace

import jsonschema
import numpy as np
import pytest
import torch

from video_features_tpu.config import ExtractionConfig as JaxConfig
from video_features_tpu.models.clip import model as jax_model
from video_features_tpu.models.clip.extract_clip import ExtractCLIP as JaxExtractCLIP
from video_features_tpu.runtime import faults as jax_faults
from video_features_tpu.runtime import telemetry as jtm
from video_features_tpu.telemetry import SCHEMA_PATH as JAX_SCHEMA_PATH
from video_features_tpu_torch.config import ExtractionConfig, sanity_check
from video_features_tpu_torch.extract.base import BaseExtractor
from video_features_tpu_torch.io.paths import video_path_of
from video_features_tpu_torch.io.video import stream_frames
from video_features_tpu_torch.models.clip import model as port_model
from video_features_tpu_torch.models.clip.extract_clip import ExtractCLIP
from video_features_tpu_torch.runtime import faults
from video_features_tpu_torch.runtime import telemetry as tm
from video_features_tpu_torch.telemetry import SCHEMA_PATH, load_schema
from video_features_tpu_torch.telemetry.__main__ import main as tele_main
from video_features_tpu_torch.utils.synth import synth_video

from test_torch_clip import SMALL
from torch_threads import one_torch_thread  # noqa: F401 - an autouse fixture

FT = "CLIP-ViT-B/32"


@pytest.fixture(autouse=True)
def _clear_global_state():
    """The current telemetry and the fault injector are process-global,
    latest-wins: no test's extractor leaks into the next."""
    yield
    tm.set_current(None)
    jtm.set_current(None)
    faults.install_injector(None)
    jax_faults.install_injector(None)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("tele_media")
    return [synth_video(str(d / f"v{i}.mp4"), n_frames=12, width=64, height=48, seed=i)
            for i in range(3)]


# --- the pure functions, both packages on the same inputs --------------------

def _rows():
    """Synthetic span rows: two pids, a decode worker lane and the loop's
    thread, host and device stages overlapping, a serial ``extract`` row,
    junk rows (t1 < t0, a missing t0), and two device lanes."""
    rows = []
    seq = 0
    for pid, base in ((11, 100.0), (22, 5.0)):
        for stage, t0, t1, thread, worker in [
            ("decode", 0.0, 0.4, 1, None), ("prepare", 0.0, 0.5, 1, "cuda:0"),
            ("h2d", 0.45, 0.6, 2, "cuda:0"), ("dispatch", 0.6, 0.7, 2, "cuda:0"),
            ("prepare", 0.55, 1.1, 1, "cuda:0"), ("fetch", 0.7, 1.3, 2, "cuda:0"),
            ("dispatch", 1.2, 1.25, 3, "cuda:1"), ("sink", 1.3, 1.35, 2, None),
            ("extract", 2.0, 3.0, 2, "cuda:0"), ("fetch", 4.0, 3.5, 2, "cuda:0"),
        ]:
            seq += 1
            rows.append({"span": f"r{pid}.{seq}", "seq": seq, "stage": stage,
                         "video": f"v{seq % 3}.mp4", "t0": base + t0, "t1": base + t1,
                         "pid": pid, "run": f"r{pid}", "thread": thread,
                         "thread_name": f"decode-{thread}" if thread == 1 else "MainThread",
                         "worker": worker, "attempt": 1, "group_size": None})
    rows.append({"span": "x.1", "stage": "prepare", "t0": None, "t1": 2.0, "pid": 11})
    return rows


@pytest.mark.parametrize("fn", ["overlap_report", "utilization_report"])
def test_reports_equal_jax(fn):
    rows = _rows()
    assert getattr(tm, fn)(rows) == getattr(jtm, fn)(rows)
    assert getattr(tm, fn)([]) == getattr(jtm, fn)([])


@pytest.mark.parametrize("device_lanes", [False, True], ids=["threads", "device-lanes"])
def test_chrome_trace_equals_jax(device_lanes):
    rows = _rows()
    ours = tm.spans_to_chrome_trace(rows, device_lanes=device_lanes)
    assert ours == jtm.spans_to_chrome_trace(rows, device_lanes=device_lanes)
    xs = [e for e in ours["traceEvents"] if e["ph"] == "X"]
    assert all(isinstance(e["ts"], int) and e["dur"] >= 0 for e in xs)


def _record(mod, root, videos):
    """A Telemetry of ``mod`` writing under ``root``: spans, counters,
    gauges and buckets, flushed and closed."""
    tele = mod.Telemetry(output_root=str(root), total_videos=videos)
    for i in range(videos):
        with tele.span("prepare", video=f"v{i}", attempt=1):
            with tele.span("decode", video=f"v{i}"):
                tele.metrics.inc("frames_decoded", 8)
        with tele.span("dispatch", video=f"v{i}"):
            tele.count_h2d(np.zeros((4, 3), np.float32))
        with tele.span("sink", video=f"v{i}"):
            pass
        tele.metrics.inc("videos_done")
    tele.metrics.set_gauge("queue_depth.pending", videos)
    tele.note_bucket((64, 64))
    tele.close()
    return tele


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_collect_and_merge_equal_jax_on_files_of_either(tmp_path, writer):
    """Files written by either package merge to the same block in both."""
    (_record(tm if writer == "port" else jtm, tmp_path / "a", 3),
     _record(tm if writer == "port" else jtm, tmp_path / "a", 2))
    root = str(tmp_path / "a")
    assert len(glob.glob(os.path.join(root, "_telemetry", "spans-*.jsonl"))) == 2
    ours, ref = tm.merge_metrics_files(root), jtm.merge_metrics_files(root)
    assert ours == ref
    assert ours["counters"] == {"frames_decoded": 40, "videos_done": 5, "h2d_bytes": 240}
    assert ours["gauges"]["queue_depth.pending"] == 3 and ours["buckets_seen"] == 1
    assert ours["stages"]["prepare"]["calls"] == 5
    ours, ref = tm.collect(root), jtm.collect(root)
    assert ours == ref and ours["overlap"]["spans"] == 15
    assert tm.collect(str(tmp_path / "nowhere")) is jtm.collect(str(tmp_path / "nowhere")) is None


def test_heartbeat_line_equals_jax_on_a_fixed_clock(monkeypatch):
    for mod in (tm, jtm):
        monkeypatch.setattr(mod.time, "time", lambda: 1000.0)
    lines = []
    for mod in (tm, jtm):
        tele = mod.Telemetry(enabled=True, total_videos=10)
        tele.metrics.t_start = 990.0
        tele.metrics.inc("videos_done", 4)
        tele.metrics.inc("frames_decoded", 100)
        tele.metrics.set_gauge("queue_depth.inflight", 2)
        lines.append(tele.heartbeat_line())
        tele.close()
    assert lines[0] == lines[1] == (
        "telemetry: 4/10 videos, 0.40 videos/s, 10 decode fps, eta 15s, inflight 2, prepared 0")


def test_payload_nbytes_equals_jax():
    a = np.zeros((4, 3), np.float32)
    t = torch.zeros(2, 5, dtype=torch.uint8)
    cases = [a, t, {"x": a, "y": [a, t]}, (t, 3, None, "s"), ((a, 12, 25.0, [0.0, 40.0], None),
                                                            (t, (np.zeros(6), np.arange(6))))]
    for payload in cases:
        assert tm.payload_nbytes(payload) == jtm.payload_nbytes(payload)
    assert tm.payload_nbytes(cases[2]) == 48 + 48 + 10
    assert tm.payload_nbytes(("s", 3, None)) == 0


# --- the schema ---------------------------------------------------------------

def test_schema_is_byte_equal_to_jax_and_covers_the_stages():
    with open(SCHEMA_PATH, "rb") as f, open(JAX_SCHEMA_PATH, "rb") as g:
        assert f.read() == g.read()
    schema = load_schema()
    jsonschema.Draft7Validator.check_schema(schema)
    assert set(schema["properties"]["stage"]["enum"]) == set(tm.STAGES) == set(jtm.STAGES)
    assert (tm.HOST_STAGES, tm.DEVICE_STAGES, tm.HIST_BOUNDS) == \
        (jtm.HOST_STAGES, jtm.DEVICE_STAGES, jtm.HIST_BOUNDS)


# --- a pipelined run in both packages -------------------------------------------

def _spans_of(root):
    return [r for f in sorted(glob.glob(os.path.join(root, "_telemetry", "spans-*.jsonl")))
            for r in tm.read_spans(f)]


def _run_both(clips, tmp, monkeypatch, **flags):
    monkeypatch.setitem(port_model.CONFIGS, FT, port_model.CLIPVisionConfig(**SMALL))
    monkeypatch.setitem(jax_model.CONFIGS, FT, jax_model.CLIPVisionConfig(**SMALL))
    flags = dict(feature_type=FT, video_paths=list(clips), extract_method="uni_3",
                 allow_random_init=True, cpu=True, on_extraction="save_numpy",
                 decode_workers=2, video_batch=2, **flags)
    port_cfg = ExtractionConfig(output_path=str(tmp / "port"), tmp_path=str(tmp / "pt"), **flags)
    ex = ExtractCLIP(sanity_check(port_cfg))
    ex(device=torch.device("cpu"))
    ex.telemetry.close()
    jax_cfg = JaxConfig(output_path=str(tmp / "jax"), tmp_path=str(tmp / "jt"), decoder="cv2",
                        **flags)
    jex = JaxExtractCLIP(jax_cfg)
    jex()
    jex.telemetry.close()
    return SimpleNamespace(
        port=port_cfg.output_path, jax=jax_cfg.output_path,
        ours=faults.finalize_run(port_cfg.output_path),
        ref=jax_faults.finalize_run(jax_cfg.output_path))


@pytest.fixture(scope="module")
def both_runs(clips, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        yield _run_both(clips, tmp_path_factory.mktemp("both"), mp)


def _stage_multiset(rows):
    return Counter((r.get("video"), r["stage"], r.get("group_size")) for r in rows)


def test_pipelined_run_spans_match_jax(both_runs, clips):
    ours, ref = _spans_of(both_runs.port), _spans_of(both_runs.jax)
    assert _stage_multiset(ours) == _stage_multiset(ref)
    # 3 clips at --video_batch 2: one group of 2 and the flushed 1; uni_3
    # opens two readers a clip (the probe of the sampler, then the decode)
    multiset = _stage_multiset(ours)
    assert {(g, s) for (v, s, g) in multiset if v is None} == {
        (2, "h2d"), (2, "dispatch"), (2, "fetch"), (1, "h2d"), (1, "dispatch"), (1, "fetch")}
    for c in clips:
        assert multiset[(c, "decode", None)] == 2
        assert multiset[(c, "prepare", None)] == multiset[(c, "sink", None)] == 1
    validator = jsonschema.Draft7Validator(load_schema())
    for row in ours:
        validator.validate(row)
    by_id = {r["span"]: r for r in ours}
    for d in (r for r in ours if r["stage"] == "decode"):  # each nests in its prepare
        parent = by_id[d["parent"]]
        assert parent["stage"] == "prepare" and parent["video"] == d["video"]
        assert parent["thread"] == d["thread"] and parent["thread_name"].startswith("decode-")
    assert all(r["thread_name"] == "MainThread" for r in ours
               if r["stage"] in ("h2d", "dispatch", "fetch", "sink"))


def test_pipelined_run_metrics_and_summary_match_jax(both_runs):
    ours, ref = both_runs.ours["telemetry"], both_runs.ref["telemetry"]
    assert "telemetry_error" not in both_runs.ours
    assert sorted(ours) == sorted(ref)
    assert sorted(ours["counters"]) == sorted(ref["counters"])
    assert sorted(ours["gauges"]) == sorted(ref["gauges"])
    for name in ("videos_done", "frames_decoded", "retries", "h2d_bytes"):
        assert ours["counters"].get(name) == ref["counters"].get(name), name
    assert ours["counters"]["videos_done"] == 3 and ours["counters"]["frames_decoded"] == 9
    assert ours["counters"]["h2d_bytes"] == 3 * 8 * 3 * 224 * 224 * 4  # uni_3 pads to 8, fp32
    assert ours["buckets_seen"] == ref["buckets_seen"] == 1
    assert {k: v["calls"] for k, v in ours["stages"].items()} == \
        {k: v["calls"] for k, v in ref["stages"].items()}
    assert ours["throughput"]["videos_per_s"] > 0 and ours["throughput"]["decode_fps"] > 0
    line = faults.format_summary(both_runs.ours)
    assert "videos/s" in line and "decode fps" in line


def test_telemetry_dir_holds_the_jax_files_but_the_ledger(both_runs):
    """Both packages' ``_telemetry/`` hold the same kinds of file, the
    device cost ledger's ``cost_ledger.json`` included."""
    def kinds(root):
        return sorted(f.split("-")[0] if "-" in f else f
                      for f in os.listdir(os.path.join(root, "_telemetry")))

    assert kinds(both_runs.port) == kinds(both_runs.jax) == ["cost_ledger.json", "metrics",
                                                            "spans"]


def test_device_preprocess_run_counts_match_jax(clips, tmp_path, monkeypatch):
    """At ``--preprocess device`` the spans, counters and H2D bytes (uint8
    frames and taps) match; the JAX package's ``compiles`` counter (its
    recompile watch, armed on device-preprocess save runs) is the one
    counter, and ``compile`` the one span stage, that the port does not
    keep (the count depends on what XLA has compiled in the process)."""
    runs = _run_both(clips, tmp_path, monkeypatch, preprocess="device")
    ours, ref = runs.ours["telemetry"], runs.ref["telemetry"]
    jax_rows = [r for r in _spans_of(runs.jax) if r["stage"] != "compile"]
    assert _stage_multiset(_spans_of(runs.port)) == _stage_multiset(jax_rows)
    assert set(ref["counters"]) - {"compiles"} == set(ours["counters"])
    for name in ("videos_done", "frames_decoded", "retries", "h2d_bytes"):
        assert ours["counters"].get(name) == ref["counters"].get(name), name
    frames = 3 * 8 * 64 * 64 * 3  # uint8, uni_3 padded to 8, the 64x64 bucket
    assert ours["counters"]["h2d_bytes"] > frames
    assert ours["buckets_seen"] == ref["buckets_seen"] == 2  # the spatial bucket, the agg key


# --- behaviour cases ----------------------------------------------------------

class Toy(BaseExtractor):
    """Per-frame means of the decoded clip."""

    feature_type = "toy"

    def _build(self, device):
        return device

    def prepare(self, entry):
        return np.asarray([float(f.mean()) for f, _ in stream_frames(video_path_of(entry))],
                          np.float32)

    def forward(self, state, payload):
        return {"toy": payload.reshape(-1, 1), "fps": np.array(25.0)}


def _cfg(videos, tmp_path, **kw):
    kw.setdefault("retry_backoff", 0.0)
    return ExtractionConfig(video_paths=list(videos), on_extraction="save_numpy",
                            output_path=str(tmp_path / "out"), tmp_path=str(tmp_path / "tmp"),
                            cpu=True, **kw)


def test_telemetry_off_writes_nothing_and_keeps_the_timer(clips, tmp_path):
    cfg = _cfg(clips[:2], tmp_path, telemetry="off", decode_workers=2)
    ex = Toy(cfg)
    ex(device=torch.device("cpu"))
    ex.telemetry.close()
    assert not os.path.isdir(os.path.join(cfg.output_path, "_telemetry"))
    assert ex.timer.counts["prepare"] == 2 and ex.timer.counts["sink"] == 2
    summary = faults.finalize_run(cfg.output_path)
    assert summary["done"] == 2 and "telemetry" not in summary
    assert "videos/s" not in faults.format_summary(summary)


@pytest.mark.parametrize("workers,stage", [(0, "extract"), (1, "prepare")])
def test_failure_record_links_the_failing_span(clips, tmp_path, workers, stage):
    cfg = _cfg(clips[:2], tmp_path, retries=0, decode_workers=workers,
               fault_inject=["decode:corrupt:2"])
    ex = Toy(cfg)
    ex(device=torch.device("cpu"))
    ex.telemetry.close()
    summary = faults.finalize_run(cfg.output_path)
    assert (summary["done"], summary["failed"]) == (1, 1)
    rec = summary["videos"][clips[1]]
    assert rec["status"] == "failed" and rec.get("span")
    failing = next(r for r in _spans_of(cfg.output_path) if r["span"] == rec["span"])
    assert failing["stage"] == stage and failing["video"] == clips[1]


def test_nested_and_cross_thread_spans():
    tele = tm.Telemetry(enabled=True)
    with pytest.raises(RuntimeError) as ei:
        with tele.span("prepare", video="v"):
            with tele.span("decode", video="v"):
                raise RuntimeError("boom")
    out = {}

    def worker():
        with tele.span("prepare", video="w"):
            tok = tele.begin("decode", video="w")
            tok.finish(frames=3)
            tok.finish()  # idempotent
        out["thread"] = threading.get_ident()

    t = threading.Thread(target=worker, name="decode-x")
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    rows = tele.spans()
    decode = next(r for r in rows if r["stage"] == "decode" and r["video"] == "v")
    prepare = next(r for r in rows if r["stage"] == "prepare" and r["video"] == "v")
    assert ei.value.telemetry_span == decode["span"] and decode["parent"] == prepare["span"]
    w_rows = [r for r in rows if r["video"] == "w"]
    assert {r["thread"] for r in w_rows} == {out["thread"]}
    assert {r["thread_name"] for r in w_rows} == {"decode-x"}
    w_decode = next(r for r in w_rows if r["stage"] == "decode")
    assert w_decode["frames"] == 3 and w_decode["parent"] == next(
        r for r in w_rows if r["stage"] == "prepare")["span"]
    assert tele.timer.counts["prepare"] == 2 and tele.timer.counts["decode"] == 2
    tele.close()


def test_disabled_mode_and_module_hooks():
    off = tm.Telemetry(enabled=False)
    with off.span("prepare") as row:
        assert row is None
    assert off.timer.counts["prepare"] == 1 and off.spans() == [] and off.begin("decode") is None
    tm.end(None)
    on = tm.Telemetry(enabled=True)
    tm.set_current(on)
    tm.frame_decoded(5)
    for key in ((64, 64), (64, 64), ("flow", 128, 192)):
        tm.note_bucket(key)
    tm.end(tm.begin("decode", video="v"))
    assert on.metrics.counter("frames_decoded") == 5 and on.buckets_seen() == 2
    assert [r["stage"] for r in on.spans()] == ["decode"]
    tm.set_current(None)
    tm.frame_decoded(1)  # no current telemetry: nothing happens
    on.close()
    off.close()


# spans each recording thread writes: enough that the flushes below land
# while all four still record, bounded so the test's cost does not grow
# with how long a loaded host takes to flush
SPANS_PER_THREAD = 5000


def test_flush_concurrent_with_recording(tmp_path):
    tele = tm.Telemetry(output_root=str(tmp_path), enabled=True)
    stop = threading.Event()
    flushed_while_recording = []

    def record():
        for _ in range(SPANS_PER_THREAD):
            if stop.is_set():
                break
            with tele.span("sink", video="v"):
                pass

    threads = [threading.Thread(target=record) for _ in range(4)]
    for t in threads:
        t.start()
    flushes = 0
    while flushes < 20 or any(t.is_alive() for t in threads):
        alive = any(t.is_alive() for t in threads)
        tele.flush()
        flushes += 1
        flushed_while_recording.append(alive)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert any(flushed_while_recording)
    assert len(tele.spans()) == tele.timer.counts["sink"] > 0
    tele.close()


def test_export_and_report_cli(clips, tmp_path, capsys):
    cfg = _cfg(clips, tmp_path, decode_workers=2)
    ex = Toy(cfg)
    ex(device=torch.device("cpu"))
    ex.telemetry.close()
    rows = _spans_of(cfg.output_path)
    out = tmp_path / "trace.json"
    assert tele_main(["export", cfg.output_path, "-o", str(out)]) == 0
    assert "perfetto" in capsys.readouterr().err
    trace = json.loads(out.read_text())
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == len(rows) and all(e["name"] in tm.STAGES for e in xs)
    assert [e["ts"] for e in xs] == sorted(e["ts"] for e in xs)
    assert tele_main(["export", os.path.join(cfg.output_path, "_telemetry"),
                      "--device-lanes"]) == 0
    lanes = json.loads(capsys.readouterr().out)
    assert any(e["ph"] == "M" and e["args"]["name"] == "device cpu"
               for e in lanes["traceEvents"])
    assert tele_main(["report", cfg.output_path, "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep == tm.overlap_report(rows) and rep["wall_s"] > 0
    assert tele_main(["report", cfg.output_path]) == 0
    text = capsys.readouterr().out
    assert text.startswith(f"spans: {rep['spans']} | wall ") and "overlap:" in text


def test_cli_usage_errors(tmp_path, capsys):
    assert tele_main(["report", str(tmp_path)]) == 2  # no spans files
    assert "no spans" in capsys.readouterr().err
    empty = tmp_path / "spans-empty.jsonl"
    empty.write_text("")
    assert tele_main(["export", str(empty)]) == 2
    assert "no spans" in capsys.readouterr().err
    assert tele_main(["report", str(tmp_path / "missing.jsonl")]) == 2
    assert "cannot read" in capsys.readouterr().err
    assert tele_main(["trace", "r1", str(tmp_path)]) == 2  # no spans files
    assert "no spans" in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        tele_main([])
    assert exc.value.code == 2  # argparse: a subcommand is required
    assert tele_main(["ledger", str(tmp_path)]) == 2  # no cost_ledger.json under it
    assert "no ledger" in capsys.readouterr().err


def test_config_flags_validate_as_jax():
    from video_features_tpu.config import sanity_check as jax_sanity_check

    sanity_check(ExtractionConfig(telemetry="off", heartbeat_s=5.0, profile_dir="p"))
    for kw, match in (({"telemetry": "sometimes"}, "telemetry"),
                      ({"heartbeat_s": -1.0}, "heartbeat_s")):
        with pytest.raises(ValueError, match=match):
            sanity_check(ExtractionConfig(**kw))
        with pytest.raises(ValueError, match=match):
            jax_sanity_check(JaxConfig(**kw))
