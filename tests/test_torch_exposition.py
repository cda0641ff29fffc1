"""The port's Prometheus text (``telemetry/exposition.py``) and one serve
request's trace (``runtime/telemetry.py::request_trace_rows``, the
telemetry CLI's ``trace``) against the JAX package's.

The same registry snapshot renders byte-identical text in both packages
and passes both checkers; the checkers agree on malformed text; the same
span rows give the same request trace.
"""

import json

import numpy as np
import pytest

from video_features_tpu.runtime.telemetry import MetricsRegistry as JaxRegistry
from video_features_tpu.runtime.telemetry import request_trace_rows as jax_request_trace_rows
from video_features_tpu.telemetry import exposition as jax_expo
from video_features_tpu_torch.runtime.telemetry import MetricsRegistry, request_trace_rows
from video_features_tpu_torch.telemetry import exposition as expo
from video_features_tpu_torch.telemetry.__main__ import main as telemetry_main

pytestmark = pytest.mark.serve


def _fill(reg, seed):
    rng = np.random.default_rng(seed)
    for state in ("done", "failed", "admitted", "shed.queue_full"):
        reg.inc(f"requests_{state}", int(rng.integers(1, 9)))
    for name in ("videos_done", "frames_decoded", "h2d_bytes", "retries", "deadline_missed",
                 "cache_hit.CLIP-ViT-B/32", "cache_miss.i3d", "windows_skipped",
                 "lease_steals.resnet50", "lease_expired", "some.new/counter"):
        reg.inc(name, int(rng.integers(1, 1000)))
    for name in ("queue_depth.admission", "queue_depth.inflight", "groups_inflight",
                 "buckets_seen", "replica_up.r1", "an.unknown-gauge"):
        reg.set_gauge(name, float(rng.integers(0, 5)))
    for stage in ("decode", "prepare", "dispatch", "fetch", "request", "queue_wait"):
        for v in rng.lognormal(-4, 2, 7):
            reg.observe(f"stage_s.{stage}", float(v))
    for ft, bucket in (("CLIP-ViT-B/32", "640x480"), ("i3d", "~")):
        reg.observe(expo.group_service_metric(ft, bucket), float(rng.uniform(0, 3)))
    reg.observe("odd.histogram", 0.25)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_snapshot_same_text(seed):
    ours, ref = MetricsRegistry(), JaxRegistry()
    _fill(ours, seed)
    _fill(ref, seed)
    snap = ours.snapshot()
    text = expo.render_families(expo.families_from_snapshot(snap))
    assert text == jax_expo.render_families(jax_expo.families_from_snapshot(snap))
    assert expo.validate_exposition(text) == [] == jax_expo.validate_exposition(text)
    assert "vft_stage_seconds_bucket" in text and 'le="+Inf"' in text
    assert expo.group_service_metric("a", "b") == jax_expo.group_service_metric("a", "b")


@pytest.mark.parametrize("text", [
    "vft_x 1\n",
    "# HELP vft_x c\n# TYPE vft_x counter\nvft_x 1\n",
    "# HELP vft_h h\n# TYPE vft_h histogram\nvft_h_bucket{le=\"1\"} 3\n"
    "vft_h_bucket{le=\"+Inf\"} 2\nvft_h_sum 1\nvft_h_count 2\n",
    "# HELP vft_g g\n# TYPE vft_g gauge\nvft_g{bad-label=\"1\"} 1\n",
    "# HELP vft_g g\n# TYPE vft_g gauge\nvft_g 1\n",
], ids=["no-type", "counter-suffix", "non-cumulative", "label-name", "good"])
def test_checkers_agree(text):
    ours = expo.validate_exposition(text)
    assert ours == jax_expo.validate_exposition(text)
    assert bool(ours) == (not text.startswith("# HELP vft_g g\n# TYPE vft_g gauge\nvft_g 1"))


def _rows():
    """A daemon's lifecycle spans and an extractor's group and stages for
    two requests, plus an unrelated video."""
    def row(span, stage, t0, t1, parent=None, pid=1, **kw):
        return {"span": span, "seq": int(span.split(".")[1]), "stage": stage, "t0": t0,
                "t1": t1, "parent": parent, "pid": pid, "run": span.split(".")[0],
                "thread": 1, "thread_name": "t", **kw}
    return [
        row("d.1", "admission", 0.0, 0.1, request="a", video="/a.mp4"),
        row("d.2", "request", 0.05, 2.0, request="a", video="/a.mp4"),
        row("d.3", "queue_wait", 0.05, 0.5, parent="d.2", request="a", video="/a.mp4"),
        row("d.4", "admission", 0.2, 0.3, request="b", video="/b.mp4"),
        row("e.1", "request", 0.5, 1.9, requests=["a", "b"], group_size=2),
        row("e.2", "dispatch", 0.9, 1.2, parent="e.1", video=None, group_size=2),
        row("e.3", "prepare", 0.6, 0.8, video="/a.mp4"),
        row("e.4", "decode", 0.6, 0.7, parent="e.3", video="/a.mp4"),
        row("e.5", "prepare", 0.6, 0.8, video="/c.mp4"),
        row("e.6", "prepare", 0.6, 0.8, video="/a.mp4", pid=2),
    ]


@pytest.mark.parametrize("rid", ["a", "b", "zzz"])
def test_request_trace_rows_match_jax(rid):
    ours = request_trace_rows(_rows(), rid)
    assert ours == jax_request_trace_rows(_rows(), rid)
    if rid == "a":
        assert {r["span"] for r in ours} == {"d.1", "d.2", "d.3", "e.1", "e.2", "e.3", "e.4"}
    if rid == "zzz":
        assert ours == []


def test_trace_cli(tmp_path, capsys):
    tdir = tmp_path / "_telemetry"
    tdir.mkdir()
    with open(tdir / "spans-1.jsonl", "w") as fh:
        for r in _rows():
            fh.write(json.dumps(r) + "\n")
    out = tmp_path / "trace.json"
    assert telemetry_main(["trace", "b", str(tmp_path), "-o", str(out)]) == 0
    events = json.loads(out.read_text())["traceEvents"]
    assert {e.get("name") for e in events if e.get("ph") == "X"} >= {"admission", "request"}
    assert telemetry_main(["trace", "nobody", str(tmp_path)]) == 2
