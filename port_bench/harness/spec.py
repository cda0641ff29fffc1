"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, and under ``port_bench/`` one file per cell
(``workloads/<name>.json``), configuration (``configs/<name>.json``),
traffic mix (``traffic/<name>.json``) and per-layer metric
(``metrics/<name>.py``). A later cell, configuration, mix or metric is a
new file and an entry in ``BENCHMARK.json``; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re
from types import ModuleType
from typing import List

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _json(path: pathlib.Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _named(kind: str, name: str, bench_dir: pathlib.Path, suffix: str) -> pathlib.Path:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name: {name!r}")
    path = bench_dir / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return path


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def workload(name: str, bench_dir: pathlib.Path = BENCH_DIR) -> dict:
    return _json(_named("workloads", name, bench_dir, ".json"))


def config(name: str, bench_dir: pathlib.Path = BENCH_DIR) -> dict:
    return _json(_named("configs", name, bench_dir, ".json"))


def traffic(name: str, bench_dir: pathlib.Path = BENCH_DIR) -> dict:
    return _json(_named("traffic", name, bench_dir, ".json"))


def metric(name: str, bench_dir: pathlib.Path = BENCH_DIR) -> ModuleType:
    """The reader module of a per-layer metric: ``LAYER``, ``UNIT``,
    ``BETTER``, ``SOURCE``, ``MOVES`` and ``read(ctx)``, which returns the
    value or None when the run has nothing for it to read."""
    path = _named("metrics", name, bench_dir, ".py")
    mod_spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def end_to_end_for(cell: str, spec: dict) -> List[dict]:
    return [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer_for(cell: str, spec: dict) -> List[dict]:
    """The per-layer metrics a cell reports: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end_for(cell, spec)}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in reported else [])]


def problems(spec: dict, bench_dir: pathlib.Path = BENCH_DIR) -> List[str]:
    """What in ``spec`` breaks the benchmark's naming rules, or names a file
    that is missing or disagrees with its entry."""
    out = []
    cells = {w["name"] for w in spec["workloads"]}
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in spec[kind]]
        out += [f"{kind}: bad name {n!r}" for n in names if not NAME.match(n)]
        out += [f"{kind}: {n!r} twice" for n in set(names) if names.count(n) > 1]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if not UNIT.match(m["unit"]):
            out.append(f"{m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher") or m["source"] not in SOURCES:
            out.append(f"{m['name']}: bad better or source")
        out += [f"{m['name']}: unknown cell {c}" for c in m.get("workloads", []) if c not in cells]
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        reader = metric(m["name"], bench_dir)
        for key in ("layer", "unit", "better", "source", "moves"):
            if getattr(reader, key.upper()) != m[key]:
                out.append(f"{m['name']}: {key} differs from metrics/{m['name']}.py")
        if m["moves"] not in e2e:
            out.append(f"{m['name']}: moves unknown {m['moves']}")
        for c in m.get("workloads", []):
            if m["moves"] not in {x["name"] for x in end_to_end_for(c, spec)}:
                out.append(f"{m['name']}: cell {c} does not report {m['moves']}")
    for w in spec["workloads"]:
        cell = workload(w["name"], bench_dir)
        for key in ("config", "traffic", "chips", "why"):
            if cell[key] != w[key]:
                out.append(f"{w['name']}: {key} differs from its file")
        config(w["config"], bench_dir)
        traffic(w["traffic"], bench_dir)
    for c in spec["configs"]:
        if not (bench_dir.parent / c["file"]).is_file():
            out.append(f"{c['name']}: no file {c['file']}")
        elif config(c["name"], bench_dir)["reduced"] != c["reduced"]:
            out.append(f"{c['name']}: reduced differs from its file")
    return out
