"""BENCHMARK.json and the files it names: the naming rules, each file
agreeing with its entry, and a cell, a configuration, a traffic mix and a
per-layer metric added as new files found with no edit."""

import json
import shutil

import pytest

from port_bench.harness import spec


def test_benchmark_has_no_problems():
    assert spec.problems(spec.benchmark()) == []


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units_use_allowed_characters(kind):
    for entry in spec.benchmark()[kind]:
        assert spec.NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert spec.UNIT.match(entry["unit"]), entry["unit"]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        e2e = {m["name"] for m in spec.end_to_end_for(w["name"], bench)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.per_layer_for(w["name"], bench)


def test_a_metric_listing_cells_lists_only_cells_reporting_what_it_moves():
    bench = spec.benchmark()
    for m in bench["per_layer"]:
        for cell in m.get("workloads", []):
            assert m["moves"] in {e["name"] for e in spec.end_to_end_for(cell, bench)}


def test_new_cell_config_mix_and_metric_are_found_as_files(tmp_path):
    bench_dir = tmp_path / "port_bench"
    for d in ("configs", "workloads", "traffic", "metrics"):
        shutil.copytree(spec.BENCH_DIR / d, bench_dir / d)
    bench = spec.benchmark()
    config = spec.config("i3d_pwc")
    config["pipeline"]["step_size"] = 32
    (bench_dir / "configs" / "i3d_pwc_dense.json").write_text(json.dumps(config))
    mix = dict(spec.traffic("k400"), width=456)
    (bench_dir / "traffic" / "k400_wide.json").write_text(json.dumps(mix))
    cell = dict(spec.workload("i3d_pwc.k400_devprep"), config="i3d_pwc_dense",
                traffic="k400_wide")
    (bench_dir / "workloads" / "i3d_pwc_dense.k400_wide.json").write_text(json.dumps(cell))
    (bench_dir / "metrics" / "host.sink_ms.py").write_text(
        'LAYER = "io/sink.py"\nUNIT = "ms"\nBETTER = "lower"\nSOURCE = "program_span"\n'
        'MOVES = "videos_per_s"\n\n\ndef read(ctx):\n'
        '    s = [r["t1"] - r["t0"] for r in ctx["spans"] if r["stage"] == "sink"]\n'
        '    return 1e3 * sum(s) / len(s) if s else None\n')
    bench["configs"].append({"name": "i3d_pwc_dense", "source": "https://arxiv.org/abs/1709.02371",
                             "file": "port_bench/configs/i3d_pwc_dense.json", "reduced": [],
                             "why": "overlapping stacks"})
    bench["workloads"].append({k: cell[k] for k in ("config", "traffic", "chips", "why")}
                              | {"name": "i3d_pwc_dense.k400_wide"})
    bench["per_layer"].append({"name": "host.sink_ms", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "io/sink.py",
                               "moves": "videos_per_s",
                               "workloads": ["i3d_pwc_dense.k400_wide"]})
    assert spec.problems(bench, bench_dir) == []
    assert spec.workload("i3d_pwc_dense.k400_wide", bench_dir)["traffic"] == "k400_wide"
    assert spec.traffic("k400_wide", bench_dir)["width"] == 456
    names = [m["name"] for m in spec.per_layer_for("i3d_pwc_dense.k400_wide", bench)]
    assert names == ["host.sink_ms"]
    reader = spec.metric("host.sink_ms", bench_dir)
    assert reader.read({"spans": [{"stage": "sink", "t0": 1.0, "t1": 1.25}]}) == 250.0
    assert reader.read({"spans": []}) is None


def test_a_misnamed_or_missing_file_is_refused(tmp_path):
    with pytest.raises(ValueError):
        spec.workload("a/b")
    with pytest.raises(FileNotFoundError):
        spec.config("no_such_config")
