"""The whole run on the CPU at a tiny size, past the check for a card:
sound, ``correct`` is true; with the timed path broken underneath, it is
false, once for each fault a one-card inference cell can have:

- an answer altered where it is produced (one feature of every video, in
  the extractor's fetch);
- half of the batch left out, the mean taken over the rest (each I3D
  stream sees the first half of a stack's frames twice);
- a step that returns its state unchanged (the flow net returns no
  motion: RAFT's coordinates, PWC's estimate left at zero).

Tiny means I3D at a sixteenth of its widths, RAFT at 2 iterations, stacks
of 16 frames, 66-frame 260x256 clips; the program is patched to the same
sizes, so it and the reference share the weight files."""

import functools
import json
import shutil

import pytest
import torch

from port_bench.harness import cell as harness
from port_bench.harness import spec

WIDTH_DIV = 16
ITERS = 2


def _tiny_bench(root, flow, chips=1):
    bench = root / "port_bench"
    for d in ("configs", "workloads", "traffic", "metrics"):
        shutil.copytree(spec.BENCH_DIR / d, bench / d)
    config = spec.config(f"i3d_{flow}")
    config["pipeline"]["stack_size"] = 16
    config["sizes"]["raft"] = dict(config["sizes"].get("raft", {}), iters=ITERS)
    (bench / "configs" / "tiny.json").write_text(json.dumps(config))
    (bench / "traffic" / "tiny.json").write_text(json.dumps(
        {"clips": 2, "frames": 66, "fps": 25.0, "width": 260, "height": 256, "codec": "mp4v"}))
    name = "i3d_raft.k400" if flow == "raft" else "i3d_pwc.k400_devprep"
    cell = dict(spec.workload(name), config="tiny", traffic="tiny", check_videos=2, chips=chips)
    if chips > 1:
        cell["flags"] = cell["flags"] + ["--sharding", "queue"]
    (bench / "workloads" / "tiny.cell.json").write_text(json.dumps(cell))
    bench_json = spec.benchmark()
    bench_json["workloads"].append({"name": "tiny.cell", "config": "tiny", "traffic": "tiny",
                                    "chips": chips, "why": "tiny"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench_json))
    return bench


def _patch_sizes(monkeypatch):
    from video_features_tpu_torch.models.i3d import extract_i3d
    from video_features_tpu_torch.models.i3d.model import I3D
    from video_features_tpu_torch.models.raft.model import RAFT

    monkeypatch.setattr(extract_i3d, "I3D", lambda c: I3D(c, channel_div=WIDTH_DIV))
    monkeypatch.setattr(extract_i3d, "RAFT", functools.partial(RAFT, iters=ITERS))


def _altered_answer(monkeypatch):
    from video_features_tpu_torch.models.i3d.extract_i3d import ExtractI3D

    fetch = ExtractI3D.fetch_dispatched

    def altered(self, handle):
        out = fetch(self, handle)
        out["flow"][0, 0] += 1.0
        return out

    monkeypatch.setattr(ExtractI3D, "fetch_dispatched", altered)


def _half_batch(monkeypatch):
    from video_features_tpu_torch.models.i3d.model import I3D

    forward = I3D.forward

    def half(self, x):
        head = x[:, : x.shape[1] // 2]
        return forward(self, torch.cat([head, head], dim=1))

    monkeypatch.setattr(I3D, "forward", half)


def _no_motion(monkeypatch):
    from video_features_tpu_torch.models.pwc.model import PWCNet
    from video_features_tpu_torch.models.raft.model import RAFT

    for cls in (RAFT, PWCNet):
        forward = cls.forward
        monkeypatch.setattr(cls, "forward", lambda self, x, f=forward: torch.zeros_like(f(self, x)))


FAULTS = {"sound": None, "altered_answer": _altered_answer, "half_batch": _half_batch,
          "no_motion": _no_motion}


@pytest.mark.parametrize("flow,fault", [("pwc", f) for f in FAULTS] + [("raft", "sound"),
                                                                       ("raft", "no_motion")])
def test_correct_reads_the_fault(tmp_path, monkeypatch, flow, fault):
    torch.set_num_threads(4)
    bench = _tiny_bench(tmp_path, flow)
    _patch_sizes(monkeypatch)
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    result, compared = harness.run("tiny.cell", 2 ** 31 + 99, 4.0, False, bench_dir=bench,
                                   cuda=False, width_div=WIDTH_DIV)
    assert result["failed"] == 0
    assert result["correct"] is (fault == "sound"), compared


def test_queue_mode_over_two_workers(tmp_path, monkeypatch):
    """A queue cell's path (one cold video a worker at once, then the
    window through ``parallel_feature_extraction``) on two CPU workers."""
    from video_features_tpu_torch.parallel import devices

    torch.set_num_threads(4)
    bench = _tiny_bench(tmp_path, "pwc", chips=2)
    _patch_sizes(monkeypatch)
    monkeypatch.setattr(devices, "resolve_devices",
                        lambda cfg=None, **kw: [torch.device("cpu"), torch.device("cpu")])
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    result, compared = harness.run("tiny.cell", 2 ** 31 + 98, 4.0, False, bench_dir=bench,
                                   cuda=False, width_div=WIDTH_DIV)
    assert result["failed"] == 0 and result["device"]["count"] == 2
    assert result["correct"] is True, compared
