"""The port's run contract against the JAX package's: error classes,
backoff, fault specs, and the manifest files each package reads of the
other's; then ``--strict`` and ``--resume`` through the port's CLI.
"""

import json
import os
import pathlib

import pytest
import torch

from video_features_tpu.runtime import faults as jax_faults
from video_features_tpu_torch import cli
from video_features_tpu_torch.config import ExtractionConfig, sanity_check
from video_features_tpu_torch.models.clip import model as port_model
from video_features_tpu_torch.ops import kernels
from video_features_tpu_torch.runtime import faults

from test_torch_clip import SMALL

FT = "CLIP-ViT-B/32"


@pytest.fixture(autouse=True)
def _clear_injector():
    yield
    faults.install_injector(None)


# the taxonomy classes both packages have, by name
SHARED_CLASSES = ["DecodeTimeout", "CorruptVideoError", "MediaRejected", "ResourceCapExceeded",
                  "AudioDecodeError", "MissingStreamError", "InjectedTransientError",
                  "InjectedPermanentError", "InjectedOOMError", "InjectedSinkKill"]


@pytest.mark.parametrize("make", [
    *[lambda m, n=n: getattr(m, n)("x") for n in SHARED_CLASSES],
    lambda m: OSError("EIO"),
    lambda m: TimeoutError("slow"),
    lambda m: MemoryError(),
    lambda m: RuntimeError("RESOURCE_EXHAUSTED: out of HBM"),
    lambda m: RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    lambda m: ValueError("operands could not be broadcast"),
    lambda m: KeyError("features.0.weight"),
], ids=[*SHARED_CLASSES, "oserror", "timeout", "memory", "resource-exhausted", "oom-message",
        "value", "key"])
def test_classify_error_matches_jax(make):
    assert faults.classify_error(make(faults)) == jax_faults.classify_error(make(jax_faults))


@pytest.mark.parametrize("exc,cls", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), "oom"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), "permanent"),
    (RuntimeError("flash_attention kernel launch failed: CUDA error 700"), "permanent"),
    (RuntimeError("nvcc failed on flash_attention.cu"), "permanent"),
    (RuntimeError("kernel library /x/lib.so does not load: bad ELF"), "permanent"),
    (OSError("CUDA error: device-side assert triggered"), "permanent"),
    (faults.InjectedCompileError("injected: nvcc failed"), "permanent"),
    (RuntimeError("XLA lowering failed"), "permanent"),  # the JAX package's 'compile'
], ids=["torch-oom", "illegal-address", "launch", "nvcc", "load", "sticky-oserror",
        "injected-compile", "xla-marker"])
def test_classify_error_torch_cases(exc, cls):
    assert faults.classify_error(exc) == cls
    assert faults.is_retryable(cls) == (cls == "oom")


def test_kernel_library_that_does_not_load_is_permanent(monkeypatch, tmp_path):
    lib = tmp_path / "libbroken.so"
    lib.write_bytes(b"not an ELF file")
    monkeypatch.setattr(kernels, "build", lambda name: lib)
    monkeypatch.setattr(kernels, "_libs", {})
    with pytest.raises(RuntimeError, match="kernel library") as info:
        kernels.load("broken")
    assert faults.classify_error(info.value) == "permanent"


@pytest.mark.parametrize("attempt,base,key", [
    (1, 0.5, "a.mp4"), (2, 0.5, "a.mp4"), (3, 0.5, "b.mp4"), (1, 0.0, "a.mp4"), (4, 1.5, "c.wav"),
])
def test_backoff_delay_matches_jax(attempt, base, key):
    ours = faults.backoff_delay(attempt, base, key)
    assert ours == jax_faults.backoff_delay(attempt, base, key)  # exact
    assert (ours == 0.0) == (base == 0.0)
    assert base * 2 ** (attempt - 1) * 0.5 <= ours <= base * 2 ** (attempt - 1)


@pytest.mark.parametrize("specs", [
    ["prepare:error:3"], ["decode:hang:1", "sink:kill:2"], ["dispatch:oom:4", "prepare:corrupt:1"],
    ["prepare:compile:2"], ["prepare:error"], ["prepare:error:0"], ["prepare:melt:1"],
    ["nowhere:error:1"], ["prepare:error:x"],
])
def test_parse_fault_specs_matches_jax(specs):
    try:
        ref = [(s.stage, s.kind, s.every_n) for s in jax_faults.parse_fault_specs(specs)]
    except ValueError:
        with pytest.raises(ValueError, match="--fault_inject"):
            faults.parse_fault_specs(specs)
        return
    assert [(s.stage, s.kind, s.every_n) for s in faults.parse_fault_specs(specs)] == ref


def test_serve_stages_are_not_ported():
    """Every serve stage of the JAX package parses in the port, the
    preemptor's ``hbm_squeeze`` included, and the stage lists are equal."""
    for stage in ("admission", "serve_dispatch", "extractor", "tracker_write",
                  "replica_kill", "hbm_squeeze", "lease_stall"):
        assert faults.parse_fault_specs([f"{stage}:error:1"]) == [
            faults.FaultSpec(stage, "error", 1)]
        assert jax_faults.parse_fault_specs([f"{stage}:error:1"])
    assert faults.STAGES == jax_faults.STAGES


def _write_events(mod, root):
    """One run's records: a retry that recovers, a permanent failure, a
    skip of a done video, an empty-feature warning and an event."""
    m = mod.RunManifest(root)
    m.record("a.mp4", "retry", stage="prepare", error_class="transient",
             error_type="OSError", message="flake", attempts=1, wall_s=0.1)
    m.record("a.mp4", "done", attempts=2, wall_s=0.3)
    m.record("b.mp4", "failed", stage="decode", error_class="permanent",
             error_type="CorruptVideoError", message="cannot open video", attempts=1)
    m.record("c.mp4", "done", attempts=1)
    m.record("c.mp4", "skipped", message="outputs exist")
    m.record("c.mp4", "warning", stage="sink", message="the value is empty")
    m.event("note", detail=1)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_merge_reads_the_others_files(tmp_path, writer):
    root = str(tmp_path / "out")
    _write_events(faults if writer == "port" else jax_faults, root)
    ours, ref = faults.merge_manifest(root), jax_faults.merge_manifest(root)
    ref.pop("telemetry", None)
    assert ours == ref
    assert (ours["done"], ours["failed"], ours["retries"], ours["total"]) == (2, 1, 1, 3)
    assert ours["videos"]["b.mp4"]["error_class"] == "permanent"
    assert faults.permanently_failed_videos(root) == jax_faults.permanently_failed_videos(root)
    assert faults.format_summary(ours) == jax_faults.format_summary(ref)
    assert faults.strict_failures(ours) == jax_faults.strict_failures(ref)


def test_finalize_writes_summary_atomically(tmp_path):
    root = str(tmp_path / "out")
    _write_events(faults, root)
    summary = faults.finalize_run(root)
    path = pathlib.Path(faults.manifest_dir(root), faults.SUMMARY_BASENAME)
    assert json.loads(path.read_text()) == json.loads(json.dumps(summary))
    assert not list(path.parent.glob("*.tmp"))
    assert faults.finalize_run(str(tmp_path / "none")) is None


@pytest.mark.parametrize("kw,match", [
    (dict(retries=-1), "retries"),
    (dict(retry_backoff=-0.1), "retry_backoff"),
    (dict(retry_failed=True), "--retry_failed"),
    (dict(fault_inject=["prepare:error"]), "--fault_inject"),
])
def test_sanity_check_rejects(kw, match):
    with pytest.raises(ValueError, match=match):
        sanity_check(ExtractionConfig(extract_method="uni_3", **kw))


def test_run_contract_defaults_are_the_jax_packages():
    from video_features_tpu.config import ExtractionConfig as JaxConfig

    ours, ref = ExtractionConfig(), JaxConfig()
    for field in ("decode_workers", "retries", "retry_backoff", "strict", "retry_failed",
                  "fault_inject", "keep_tmp_files"):
        assert getattr(ours, field) == getattr(ref, field), field


@pytest.fixture
def small_tower(monkeypatch):
    monkeypatch.setitem(port_model.CONFIGS, FT, port_model.CLIPVisionConfig(**SMALL))


def _argv(videos, out, *extra):
    return ["--feature_type", FT, "--cpu", "--allow_random_init", "--extract_method", "uni_3",
            "--on_extraction", "save_numpy", "--output_path", str(out),
            "--tmp_path", str(out) + "_tmp", "--video_paths", *videos, *extra]


def test_strict_corrupt_clip_exits_nonzero(sample_video, tmp_path, small_tower):
    """A corrupt clip among good ones: the run exits nonzero under
    --strict, the record says failed and permanent (the default
    ``--preflight on`` rejects it before any decode), the good clip's file
    is written, and the JAX package's merge reads the port's summary to
    the same counts."""
    bad = tmp_path / "broken.mp4"
    bad.write_bytes(b"not a video")
    out = tmp_path / "out"
    with pytest.raises(SystemExit, match="--strict: run completed with 1 problem"):
        cli.main(_argv([sample_video, str(bad)], out, "--strict"))
    summary = json.loads((out / "_manifest" / "summary.json").read_text())
    assert (summary["done"], summary["failed"], summary["retries"]) == (1, 1, 0)
    rec = summary["videos"][str(bad)]
    assert rec["status"] == "failed" and rec["error_class"] == "permanent"
    assert rec["error_type"] == "MediaRejected" and rec["stage"] == "preflight"
    assert rec["attempts"] == 1
    assert (out / FT / "synth_CLIP-ViT-B-32.npy").exists()
    ref = jax_faults.merge_manifest(str(out))
    assert {k: ref[k] for k in ("done", "failed", "retries", "total")} == \
        {k: summary[k] for k in ("done", "failed", "retries", "total")}
    cli.main(_argv([sample_video], tmp_path / "clean", "--strict"))  # no failure: exit 0


def test_resume_skips_prior_permanent_failure_unless_retry_failed(
    sample_video, tmp_path, small_tower, capsys
):
    bad = tmp_path / "broken.mp4"
    bad.write_bytes(b"junk")
    out = tmp_path / "out"
    videos = [sample_video, str(bad)]
    cli.main(_argv(videos, out))
    done = out / FT / "synth_CLIP-ViT-B-32.npy"
    mtime = os.stat(done).st_mtime_ns
    cli.main(_argv(videos, out, "--resume"))
    text = capsys.readouterr().out
    assert "prior permanent failure" in text and "outputs exist" in text
    assert os.stat(done).st_mtime_ns == mtime
    failed = [r for r in faults.iter_manifest_records(str(out))
              if r.get("video") == str(bad) and r.get("status") == "failed"]
    assert len(failed) == 1  # skipped, not decoded again
    assert faults.merge_manifest(str(out))["videos"][str(bad)]["status"] == "failed"
    cli.main(_argv(videos, out, "--resume", "--retry_failed"))
    failed = [r for r in faults.iter_manifest_records(str(out))
              if r.get("video") == str(bad) and r.get("status") == "failed"]
    assert len(failed) == 2  # attempted again, and the bytes are still junk
    assert os.stat(done).st_mtime_ns == mtime


def test_print_run_writes_no_manifest(sample_video, tmp_path, small_tower):
    out = tmp_path / "out"
    cli.main([a if a != "save_numpy" else "print" for a in _argv([sample_video], out)])
    assert not (out / "_manifest").exists() and faults.merge_manifest(str(out)) is None
