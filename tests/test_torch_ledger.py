"""The port's device cost ledger (``telemetry/ledger.py``) against the JAX
package's.

- ``CostLedger``: the same records through both ledgers give equal
  snapshots (entries, ``n_compiles``, the ``hbm_projection`` arithmetic,
  ``projected_resident_bytes``); torn, foreign-version and missing files
  load the same; each package's ``CostLedger`` and ``ledger`` CLI read the
  other's ``cost_ledger.json``, with the same table, the same ``--json``
  and rc 2 on a path with no ledger.
- ``families_from_ledger`` and the ``device_mem_*`` / ``preemptions.``
  registry names render byte-identical Prometheus text from one snapshot.
- ``DeviceMemorySampler``: fed fake CUDA statistics it sets the four
  gauges of the card and the headroom ``free + reserved - allocated``; on
  the CPU it sets none.
- The capture seam: the small CLIP tower through each package's save run
  records an entry whose ``argument_bytes`` and ``output_bytes`` equal the
  JAX package's CPU entry exactly, and whose flops equal the analytic
  count (patch embedding, the matmuls and K1's ``4 * N * H * L * L * d``)
  under ``--attn flash`` (K1's plain version plus its formula) and
  ``--attn fused`` alike. A dict state records one family per module, each
  entry carrying the whole state's weights; K2 inside a capture counts its
  formula; a signature captures once; a forward that raises records
  nothing and releases the capture.

Tolerance: exact everywhere (integers, and text compared byte for byte).
Every JAX config passes ``decoder="cv2"`` (the native decoder aborts the
process on a decode thread here).
"""

import json
import os

import numpy as np
import pytest
import torch

from video_features_tpu.config import ExtractionConfig as JaxConfig
from video_features_tpu.models.clip import model as jax_model
from video_features_tpu.models.clip.extract_clip import ExtractCLIP as JaxExtractCLIP
from video_features_tpu.runtime import telemetry as jtm
from video_features_tpu.telemetry import exposition as jax_exposition
from video_features_tpu.telemetry import ledger as jax_ledger
from video_features_tpu.telemetry.__main__ import main as jax_tele_main
from video_features_tpu_torch.config import ExtractionConfig, sanity_check
from video_features_tpu_torch.models.clip import model as port_model
from video_features_tpu_torch.models.clip.extract_clip import ExtractCLIP
from video_features_tpu_torch.ops.correlation import correlation_flops, local_correlation
from video_features_tpu_torch.runtime import telemetry as tm
from video_features_tpu_torch.telemetry import exposition, ledger
from video_features_tpu_torch.telemetry.__main__ import main as tele_main
from video_features_tpu_torch.utils.synth import synth_video

from test_torch_clip import SMALL
from torch_threads import one_torch_thread  # noqa: F401 - an autouse fixture

FT = "CLIP-ViT-B/32"
MEM = {"argument_bytes": 1000, "output_bytes": 100, "temp_bytes": 50,
       "generated_code_bytes": 10}


@pytest.fixture(autouse=True)
def _clear_current():
    yield
    tm.set_current(None)
    jtm.set_current(None)


# --- the ledger itself, both packages on the same records ---------------------

# (model, family, bucket, sharding, platform, analysis)
RECORDS = {
    "cpu_only": [
        ("resnet18", "forward", "4x8", "queue", "cpu", {"flops": 512.0, "memory": dict(MEM)}),
    ],
    "recapture": [
        ("resnet18", "forward", "4x8", "queue", "cpu", {"flops": 512.0}),
        ("resnet18", "forward", "4x8", "queue", "cpu", {"flops": 640.0}),
    ],
    "max_and_sum": [
        ("i3d", "rgb", "2x64", "queue", "cuda", {"flops": 1.0, "memory": dict(MEM)}),
        ("i3d", "pwc", "2x128", "queue", "cuda",
         {"flops": 1.0, "memory": {**MEM, "argument_bytes": 4000, "generated_code_bytes": 7}}),
        ("i3d", "flow", "2x64", "queue", "cuda",
         {"memory": {"argument_bytes": 10, "output_bytes": 900, "temp_bytes": 5}}),
        ("CLIP-ViT-B/32", "forward", "16x3x224x224", "queue", "cuda",
         {"flops": 8.8e9, "memory": {"argument_bytes": 7, "output_bytes": 1}}),
        ("CLIP-ViT-B/32", "forward", "64x3x224x224", "queue", None, {"flops": 3.5e10}),
    ],
    "absent_never_zero": [
        ("m", "f", "~", "queue", "cuda", {}),
        ("m", "g", "1x2", "mesh", "cuda", {"bytes_accessed": 3.0}),
    ],
}


def _fill(mod, path, records):
    led = mod.CostLedger(path)
    for rec in records:
        led.record(*rec)
    return led


def _snap(led):
    return {k: v for k, v in led.snapshot().items() if k != "path"}


@pytest.mark.parametrize("case", sorted(RECORDS))
def test_ledger_snapshot_and_projection_equal_jax(case, tmp_path):
    ours = _fill(ledger, str(tmp_path / "p" / ledger.LEDGER_FILENAME), RECORDS[case])
    ref = _fill(jax_ledger, str(tmp_path / "j" / jax_ledger.LEDGER_FILENAME), RECORDS[case])
    assert _snap(ours) == _snap(ref)
    assert len(ours) == len(ref)
    for models in (None, ["i3d"], ["resnet18", "CLIP-ViT-B/32"], []):
        assert ours.projected_resident_bytes(models) == ref.projected_resident_bytes(models)
    if case == "max_and_sum":  # arguments/outputs/temp MAXed, generated code SUMmed
        assert ours.hbm_projection()["i3d"] == {
            "arguments": 4000, "outputs": 900, "temp": 50, "generated_code": 17,
            "resident": 4000 + 900 + 50 + 17}
    if case == "recapture":
        assert ours.entries()[0]["n_compiles"] == 2 and ours.entries()[0]["flops"] == 640.0


@pytest.mark.parametrize("direction", ["port_reads_jax", "jax_reads_port"])
def test_ledger_files_read_across_packages(direction, tmp_path):
    path = str(tmp_path / ledger.LEDGER_FILENAME)
    writer, reader = (jax_ledger, ledger) if direction == "port_reads_jax" else (ledger, jax_ledger)
    written = _fill(writer, path, RECORDS["max_and_sum"])
    read = reader.load_ledger(path)
    assert read is not None and _snap(read) == _snap(written)
    with open(path) as f:
        assert set(json.load(f)) == {"version", "entries"}


@pytest.mark.parametrize("content", ['{"version": 1, "entr', '{"version": 999, "entries": {}}',
                                     '[1, 2]', '{"version": 1, "entries": {"k": {"x": 1}}}'],
                         ids=["torn", "version", "not_a_dict", "no_model"])
def test_bad_ledger_files_load_empty_as_jax(content, tmp_path):
    path = tmp_path / ledger.LEDGER_FILENAME
    path.write_text(content)
    assert len(ledger.CostLedger(str(path))) == len(jax_ledger.CostLedger(str(path))) == 0
    led = ledger.CostLedger(str(path))
    led.record("m", "f", "4x8", "queue", "cpu", {"flops": 1.0})
    assert len(jax_ledger.CostLedger(str(path))) == 1  # recovered by the rewrite


def test_missing_and_shared_ledgers(tmp_path):
    assert ledger.load_ledger(str(tmp_path / "nope.json")) is None
    path = str(tmp_path / ledger.LEDGER_FILENAME)
    assert ledger.CostLedger.shared(path) is ledger.CostLedger.shared(
        os.path.join(str(tmp_path), ".", ledger.LEDGER_FILENAME))
    cfg = ExtractionConfig(output_path=str(tmp_path / "o"))
    assert ledger.default_ledger_path(cfg) == jax_ledger.default_ledger_path(
        JaxConfig(output_path=str(tmp_path / "o")))
    assert ledger.entry_key("a", "b", "c", "d") == jax_ledger.entry_key("a", "b", "c", "d")


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1536, 953.7 * 2**20, 5 * 2**40, -2048])
def test_format_bytes_equal_jax(n):
    assert ledger.format_bytes(n) == jax_ledger.format_bytes(n)


def test_bucket_of_equal_jax():
    a, t = np.zeros((4, 8), np.float32), torch.zeros(2, 3, 5)
    for args, kwargs in [((a,), {}), (({"w": a}, t), {}), ((), {}), ((3, "s"), {"x": t}),
                         ((np.zeros(()),), {})]:
        assert ledger.bucket_of(args, kwargs) == jax_ledger.bucket_of(args, kwargs)


# --- the CLI and the exposition ------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--json"]], ids=["table", "json"])
@pytest.mark.parametrize("case", ["cpu_only", "max_and_sum"])
def test_ledger_cli_equals_jax(case, flags, tmp_path, capsys):
    _fill(ledger, str(tmp_path / "_telemetry" / ledger.LEDGER_FILENAME), RECORDS[case])
    outs = []
    for main in (tele_main, jax_tele_main):
        assert main(["ledger", str(tmp_path), *flags]) == 0  # the output root resolves
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    if flags:
        assert json.loads(outs[0])["entries"][0]["bucket"] in ("4x8", "16x3x224x224")
    elif case == "cpu_only":
        assert "CPU-backend runs record flops only" in outs[0]
    else:
        assert "projected resident HBM per model:" in outs[0]


def test_ledger_cli_rc2_when_nothing_is_found(tmp_path, capsys):
    for main in (tele_main, jax_tele_main):
        assert main(["ledger", str(tmp_path / "none")]) == 2
        assert "no ledger" in capsys.readouterr().err


@pytest.mark.parametrize("case", sorted(RECORDS))
def test_families_from_ledger_text_equals_jax(case):
    led = _fill(ledger, None, RECORDS[case])
    text = exposition.render_families(exposition.families_from_ledger(led.snapshot()))
    assert text == jax_exposition.render_families(
        jax_exposition.families_from_ledger(led.snapshot()))
    assert exposition.validate_exposition(text) == []
    assert ("vft_hbm_bytes" in text) == (case == "max_and_sum")  # absent on the CPU


def test_device_memory_and_preemption_series_equal_jax():
    reg = tm.MetricsRegistry()
    reg.set_gauge("device_mem_bytes.cuda:0|in_use", 5.0)
    reg.set_gauge("device_mem_bytes.cuda:0|limit", 10.0)
    reg.set_gauge("device_mem_bytes.cuda:1", 3.0)
    reg.set_gauge("device_mem_headroom_bytes", 5.0)
    reg.inc("preemptions.CLIP-ViT-B/32")
    snap = reg.snapshot()
    text = exposition.render_families(exposition.families_from_snapshot(snap))
    assert text == jax_exposition.render_families(jax_exposition.families_from_snapshot(snap))
    assert exposition.validate_exposition(text) == []
    assert 'vft_device_mem_bytes{device="cuda:0",kind="in_use"} 5' in text
    assert "vft_device_mem_headroom_bytes 5" in text
    assert 'vft_preemptions_total{feature_type="CLIP-ViT-B/32"} 1' in text


# --- the device-memory sampler -------------------------------------------------

def test_sampler_sets_no_gauge_on_the_cpu():
    reg = tm.MetricsRegistry()
    sampler = ledger.DeviceMemorySampler(reg, devices=[torch.device("cpu")])
    assert sampler.sample_once() == 0
    assert not any(k.startswith("device_mem") for k in reg.snapshot()["gauges"])
    sampler.stop()  # idempotent without start()


def test_sampler_reads_fake_cuda_stats(monkeypatch):
    stats = {1: {"allocated_bytes.all.current": 600, "allocated_bytes.all.peak": 800,
                 "reserved_bytes.all.current": 700},
             2: {}}  # an allocator that has allocated nothing yet
    info = {1: (300, 1000), 2: (900, 1000)}
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: stats[i])
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda i: info[i])
    reg = tm.MetricsRegistry()
    sampler = ledger.DeviceMemorySampler(reg, devices=["cuda:1", "cuda:2", "cpu"])
    assert sampler.sample_once() == 2
    g = reg.snapshot()["gauges"]
    assert {k: v for k, v in g.items() if k.startswith("device_mem_bytes.cuda:1")} == {
        "device_mem_bytes.cuda:1|in_use": 600, "device_mem_bytes.cuda:1|limit": 1000,
        "device_mem_bytes.cuda:1|peak": 800, "device_mem_bytes.cuda:1|reserved": 700}
    assert g["device_mem_bytes.cuda:2|in_use"] == 0
    # min over the cards of free + (reserved - allocated): 300 + 100 vs 900
    assert g["device_mem_headroom_bytes"] == 400


# --- the capture seam ------------------------------------------------------------

def _clip_flops(n_images, cfg=SMALL, image=224, patch=32):
    """Analytic flops of the CLIP vision tower at 2 a multiply-add: the
    patch embedding, per layer the q/k/v, out and MLP (4x) projections on
    every token and attention's two products, and the final projection."""
    width, layers, heads, embed = cfg["width"], cfg["layers"], cfg["heads"], cfg["embed_dim"]
    grid = (image // patch) ** 2
    tokens = grid + 1
    patch_embed = 2 * grid * width * 3 * patch * patch
    per_layer = 2 * tokens * (4 * width * width + 8 * width * width)
    attention = 4 * heads * tokens * tokens * (width // heads)
    return n_images * (patch_embed + layers * (per_layer + attention) + 2 * width * embed)


@pytest.fixture(scope="module")
def clip_entries(tmp_path_factory):
    """{package or attn core: the CLIP entry of a save run of one clip}."""
    tmp = tmp_path_factory.mktemp("ledger_clip")
    clip = synth_video(str(tmp / "v.mp4"), n_frames=12, width=64, height=48, seed=0)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(port_model.CONFIGS, FT, port_model.CLIPVisionConfig(**SMALL))
        mp.setitem(jax_model.CONFIGS, FT, jax_model.CLIPVisionConfig(**SMALL))
        flags = dict(feature_type=FT, video_paths=[clip], extract_method="uni_3",
                     allow_random_init=True, cpu=True, on_extraction="save_numpy")
        for attn in ("flash", "fused"):
            cfg = ExtractionConfig(output_path=str(tmp / attn), tmp_path=str(tmp / "t"),
                                   attn=attn, **flags)
            ex = ExtractCLIP(sanity_check(cfg))
            ex(device=torch.device("cpu"))
            ex.telemetry.close()
            out[attn] = ledger.load_ledger(ledger.default_ledger_path(cfg)).entries()
        jcfg = JaxConfig(output_path=str(tmp / "jax"), tmp_path=str(tmp / "jt"),
                         decoder="cv2", **flags)
        jex = JaxExtractCLIP(jcfg)
        jex()
        jex.telemetry.close()
        out["jax"] = jax_ledger.load_ledger(jax_ledger.default_ledger_path(jcfg)).entries()
    return out


@pytest.mark.parametrize("attn", ["flash", "fused"])
def test_clip_entry_bytes_equal_the_jax_cpu_entry(clip_entries, attn):
    (ours,), (ref,) = clip_entries[attn], clip_entries["jax"]
    assert (ours["model"], ours["bucket"], ours["platform"]) == (FT, "8x3x224x224", "cpu")
    # the same arrays on both sides: the tower's weights plus the 8 padded
    # images in, the 8 x 32 embeddings out
    for key in ("argument_bytes", "output_bytes"):
        assert ours["memory"][key] == ref["memory"][key], key
    assert ours["memory"]["output_bytes"] == 8 * SMALL["embed_dim"] * 4
    # absent, never zero: no peak on the CPU, no bytes-accessed figure
    assert "temp_bytes" not in ours["memory"] and "bytes_accessed" not in ours


def test_clip_flops_are_the_analytic_count_under_both_cores(clip_entries):
    want = _clip_flops(8)
    assert clip_entries["flash"][0]["flops"] == clip_entries["fused"][0]["flops"] == want


class _Twice(torch.nn.Module):
    def __init__(self, n):
        super().__init__()
        self.lin = torch.nn.Linear(n, n, bias=False)
        self.register_buffer("scale", torch.ones(n))

    def forward(self, x):
        return self.lin(x) * self.scale


class _Corr(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(1))

    def forward(self, f1, f2):
        return local_correlation(f1 * self.w, f2)


def test_dict_state_records_one_family_per_module(tmp_path):
    led = ledger.CostLedger(None)
    state = {"rgb": _Twice(8), "pwc": _Corr(), "device": torch.device("cpu")}
    assert ledger.instrument_state(state, led, model="i3d") is state
    x = torch.randn(4, 8)
    f = torch.randn(2, 3, 5, 6)
    with torch.inference_mode():
        state["rgb"](x)
        state["rgb"](x)  # the same signature: captured once
        state["pwc"](f, f)
        state["rgb"](torch.randn(2, 8))  # a new one: a second entry
    got = {(e["family"], e["bucket"]): e for e in led.entries()}
    assert sorted(got) == [("pwc", "2x3x5x6"), ("rgb", "2x8"), ("rgb", "4x8")]
    weights = (8 * 8 + 8 + 1) * 4  # every module of the state
    assert got[("rgb", "4x8")]["memory"] == {"argument_bytes": weights + 4 * 8 * 4,
                                            "output_bytes": 4 * 8 * 4}
    assert got[("rgb", "4x8")]["flops"] == 2 * 4 * 8 * 8
    # K2's formula, and none of its plain version's operations
    assert got[("pwc", "2x3x5x6")]["flops"] == correlation_flops(f) == 2 * 81 * 2 * 3 * 5 * 6
    assert all(e["n_compiles"] == 1 and e["platform"] == "cpu" for e in got.values())
    # outside a capture the kernels count nothing and run as they do
    assert local_correlation(f, f).shape == (2, 81, 5, 6)


def test_a_forward_that_raises_records_nothing_and_frees_the_capture():
    led = ledger.CostLedger(None)
    mod = _Twice(4)
    ledger.instrument_state(mod, led, model="m")
    with pytest.raises(RuntimeError):
        mod(torch.randn(3, 5))  # wrong width: the forward raises
    assert len(led) == 0 and getattr(ledger._TLS, "capture", None) is None
    assert not ledger._CAPTURE_LOCK.locked()
    mod(torch.randn(3, 4))
    (entry,) = led.entries()
    assert (entry["family"], entry["bucket"]) == ("forward", "3x4")


def test_a_state_without_modules_passes_through():
    led = ledger.CostLedger(None)
    state = {"params": {"w": np.ones(3)}, "device": "cpu"}
    assert ledger.instrument_state(state, led, model="m") is state
    assert ledger.instrument_state(object, led, model="m") is object
