"""The port's preflight probe (``io/probe.py``) and the reader's input
caps and decode deadline (``io/video.py``) against the JAX package's, on
the hostile-media corpus (``tests/hostile_media.py``).

- The probe: for every corpus file, the port's ``preflight(...)`` report
  equals the JAX package's, field for field, for ``need="video"`` and
  ``need="audio"``, with and without caps.
- The caps: declared-metadata rejections are equal; the readers' running
  budgets (``--max_decode_bytes``, ``--max_duration_s``) raise
  ``ResourceCapExceeded`` after the same frame in both packages;
  ``--max_pixels`` stops both readers at the open; ``--decode_timeout``
  raises ``DecodeTimeout``.
- The CLI on the corpus in each package (a 2-layer CLIP, ``uni_3``): the
  manifest's ``status``, ``stage``, ``error_class``, ``error_type`` and
  ``attempts`` per file are equal, with the probe's rejects failed at
  ``preflight`` with zero retries; with ``--preflight off`` every file
  still ends done or failed, as in the JAX package.

Every JAX config passes ``decoder="cv2"``.
"""

import pytest
import torch

from video_features_tpu import cli as jax_cli
from video_features_tpu.config import ExtractionConfig as JaxConfig
from video_features_tpu.config import sanity_check as jax_sanity_check
from video_features_tpu.io import probe as jax_probe
from video_features_tpu.io import video as jax_video
from video_features_tpu.models.clip import model as jax_model
from video_features_tpu.runtime import faults as jax_faults
from video_features_tpu.runtime import telemetry as jtm
from video_features_tpu_torch import cli
from video_features_tpu_torch.config import ExtractionConfig, sanity_check
from video_features_tpu_torch.extract.registry import media_need_for
from video_features_tpu_torch.io import probe
from video_features_tpu_torch.io import video
from video_features_tpu_torch.models.clip import model as port_model
from video_features_tpu_torch.runtime import faults
from video_features_tpu_torch.runtime import telemetry as tm

from hostile_media import build_corpus
from test_torch_clip import SMALL
from torch_threads import one_torch_thread  # noqa: F401 - an autouse fixture

FT = "CLIP-ViT-B/32"
CAPS = {
    "none": {},
    "pixels": dict(max_pixels=1000),
    "duration": dict(max_duration_s=1.0),
    "bytes": dict(max_decode_bytes=100_000),
    "roomy": dict(max_pixels=10_000, max_duration_s=10.0, max_decode_bytes=10 ** 8),
}


@pytest.fixture(autouse=True)
def _clear_global_decode_state():
    """The caps, the deadline, the injector and the current telemetry are
    process-global (installed by each extractor): none leaks out of a
    test."""
    yield
    for mod in (video, jax_video):
        mod.set_resource_caps(None)
        mod.set_decode_timeout(None)
        mod.pop_decode_warnings()
    faults.install_injector(None)
    jax_faults.install_injector(None)
    tm.set_current(None)
    jtm.set_current(None)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return build_corpus(str(tmp_path_factory.mktemp("hostile_corpus")))


# --- the probe ------------------------------------------------------------------

@pytest.mark.parametrize("need", ["video", "audio"])
@pytest.mark.parametrize("caps", list(CAPS))
def test_probe_reports_equal_jax_across_the_corpus(corpus, need, caps):
    verdicts = set()
    for e in corpus.values():
        ours = probe.preflight(e.path, need=need, caps=probe.ResourceCaps(**CAPS[caps]))
        ref = jax_probe.preflight(e.path, need=need, caps=jax_probe.ResourceCaps(**CAPS[caps]))
        assert ours.as_dict() == ref.as_dict(), e.name
        verdicts.add(ours.verdict)
    assert "reject" in verdicts
    assert caps not in ("none", "roomy") or verdicts & {"ok", "caution"}


def test_probe_missing_file_and_directory_equal_jax(tmp_path):
    for path in (str(tmp_path / "nope.mp4"), str(tmp_path)):
        assert probe.preflight(path).as_dict() == jax_probe.preflight(path).as_dict()
    assert probe.preflight(str(tmp_path)).verdict == "caution"


def test_declared_cap_rejects_raise_the_same_errors(corpus):
    ok = corpus["ok"].path  # 64x48, 60 frames at 25 fps
    for name in ("pixels", "duration", "bytes"):
        caps = probe.ResourceCaps(**CAPS[name])
        with pytest.raises(faults.ResourceCapExceeded) as ours:
            probe.preflight_or_raise(ok, caps=caps)
        with pytest.raises(jax_faults.ResourceCapExceeded) as ref:
            jax_probe.preflight_or_raise(ok, caps=jax_probe.ResourceCaps(**CAPS[name]))
        assert str(ours.value) == str(ref.value) and ours.value.stage == "preflight"
        assert faults.classify_error(ours.value) == "permanent"
    with pytest.raises(faults.MediaRejected, match="empty file"):
        probe.preflight_or_raise(corpus["zero_byte"].path)
    assert probe.ResourceCaps.from_config(ExtractionConfig(max_pixels=7)) == \
        probe.ResourceCaps(max_pixels=7)
    assert media_need_for("vggish") == media_need_for("vggish_torch") == "audio"
    assert media_need_for(FT) == media_need_for("i3d") == "video"


# --- the reader's running caps and deadline ---------------------------------------

def _frames_until_raise(stream):
    n = 0
    with pytest.raises(Exception) as exc:
        for _ in stream:
            n += 1
    return n, exc.value


@pytest.mark.parametrize("caps,match", [
    (dict(max_decode_bytes=5 * 64 * 48 * 3), "max_decode_bytes"),
    (dict(max_duration_s=0.2), "max_duration_s"),
])
def test_running_budget_stops_both_readers_at_the_same_frame(corpus, caps, match):
    """Readers opened with no preflight: the running budget stops the
    60-frame clip partway in both packages."""
    path = corpus["ok"].path
    video.set_resource_caps(probe.ResourceCaps(**caps))
    jax_video.set_resource_caps(jax_probe.ResourceCaps(**caps))
    ours, ours_exc = _frames_until_raise(video.stream_frames(path))
    ref, ref_exc = _frames_until_raise(jax_video.stream_frames(path, decoder="cv2"))
    assert isinstance(ours_exc, faults.ResourceCapExceeded) and match in str(ours_exc)
    assert isinstance(ref_exc, jax_faults.ResourceCapExceeded)
    assert ours == ref and 0 < ours < 60
    video.set_resource_caps(None)
    assert sum(1 for _ in video.stream_frames(path)) == 60  # uncapped, the stream is fine


def test_max_pixels_stops_both_readers_at_the_open(corpus):
    path = corpus["ok"].path
    video.set_resource_caps(probe.ResourceCaps(max_pixels=1000))
    jax_video.set_resource_caps(jax_probe.ResourceCaps(max_pixels=1000))
    with pytest.raises(faults.ResourceCapExceeded, match="--max_pixels 1000") as ours:
        video.extract_frames(path, "uni_3")
    with pytest.raises(jax_faults.ResourceCapExceeded) as ref:
        jax_video.extract_frames(path, "uni_3", decoder="cv2")
    assert str(ours.value) == str(ref.value)


def test_decode_timeout_raises_decode_timeout(corpus):
    video.set_decode_timeout(1e-9)
    with pytest.raises(faults.DecodeTimeout, match="--decode_timeout") as exc:
        video.extract_frames(corpus["ok"].path, "uni_3")
    assert faults.classify_error(exc.value) == "transient" and exc.value.stage == "decode"
    video.set_decode_timeout(None)
    frames, _, _ = video.extract_frames(corpus["ok"].path, "uni_3")
    assert len(frames) == 3


def test_caps_config_validation_as_jax():
    sanity_check(ExtractionConfig(max_pixels=1, max_duration_s=0.5, max_decode_bytes=1,
                                  decode_timeout=2.0))
    for kw in ({"max_pixels": 0}, {"max_duration_s": 0.0}, {"max_decode_bytes": 0},
               {"preflight": "maybe"}, {"decode_timeout": 0.0}):
        with pytest.raises(ValueError):
            sanity_check(ExtractionConfig(**kw))
        with pytest.raises(ValueError):
            jax_sanity_check(JaxConfig(**kw))


# --- the CLI on the corpus, in each package ------------------------------------------

def _argv(paths, out, *extra):
    return ["--feature_type", FT, "--cpu", "--allow_random_init", "--extract_method", "uni_3",
            "--on_extraction", "save_numpy", "--output_path", str(out),
            "--tmp_path", str(out) + "_tmp", "--retry_backoff", "0", "--heartbeat_s", "0",
            *extra, "--video_paths", *paths]


def _records(summary):
    keys = ("status", "stage", "error_class", "error_type", "attempts")
    return {k: tuple(v.get(f) for f in keys) for k, v in summary["videos"].items()}


@pytest.fixture
def small_towers(monkeypatch):
    monkeypatch.setitem(port_model.CONFIGS, FT, port_model.CLIPVisionConfig(**SMALL))
    monkeypatch.setitem(jax_model.CONFIGS, FT, jax_model.CLIPVisionConfig(**SMALL))


@pytest.mark.parametrize("flags", [(), ("--max_pixels", "1000")], ids=["default", "max_pixels"])
def test_cli_corpus_records_equal_jax(corpus, tmp_path, small_towers, flags):
    paths = [e.path for e in corpus.values()]
    cli.main(_argv(paths, tmp_path / "port", *flags))
    jax_cli.main(_argv(paths, tmp_path / "jax", "--decoder", "cv2", *flags))
    ours = faults.merge_manifest(str(tmp_path / "port"))
    ref = jax_faults.merge_manifest(str(tmp_path / "jax"))
    assert _records(ours) == _records(ref)
    assert ours["retries"] == ref["retries"] == 0
    assert ours["total"] == len(paths) and not ours["worker_deaths"]
    rejected = {k for k, v in ours["videos"].items() if v.get("stage") == "preflight"}
    assert rejected and all(ours["videos"][k]["status"] == "failed" and
                            ours["videos"][k]["error_class"] == "permanent" and
                            ours["videos"][k]["attempts"] == 1 for k in rejected)
    if not flags:  # the files the JAX package's probe rejects in this build of cv2
        for e in corpus.values():
            report = jax_probe.preflight(e.path)
            if report.verdict == "reject":
                assert e.path in rejected, e.name
                assert report.reason in ours["videos"][e.path]["message"], e.name
    else:  # the cap rejects every decodable file at preflight
        assert ours["done"] == 0 and ours["videos"][corpus["ok"].path]["error_type"] == \
            "ResourceCapExceeded"
    assert sorted((w["video"], w["stage"], w["message"]) for w in ours["warnings"]) == \
        sorted((w["video"], w["stage"], w["message"]) for w in ref["warnings"])


def test_cli_preflight_off_still_ends_every_file(corpus, tmp_path, small_towers):
    paths = [e.path for e in corpus.values()]
    cli.main(_argv(paths, tmp_path / "port", "--preflight", "off"))
    jax_cli.main(_argv(paths, tmp_path / "jax", "--preflight", "off", "--decoder", "cv2"))
    ours = faults.merge_manifest(str(tmp_path / "port"))
    ref = jax_faults.merge_manifest(str(tmp_path / "jax"))
    assert {v["status"] for v in ours["videos"].values()} <= {"done", "failed"}
    assert ours["total"] == len(paths) and ours["done"] >= 1
    assert not any(v.get("stage") == "preflight" for v in ours["videos"].values())
    assert _records(ours) == _records(ref)
