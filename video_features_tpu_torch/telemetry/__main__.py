"""CLI: ``python -m video_features_tpu_torch.telemetry <export|report> ...``.

Counterpart of ``video_features_tpu/telemetry/__main__.py``: consumers
for the span files a run leaves under ``<output>/_telemetry/``.

- ``export SPANS... [-o trace.json] [--device-lanes]`` — Chrome-trace /
  Perfetto JSON. Arguments are spans-*.jsonl files, a ``_telemetry``
  directory, or the run's output root (the ``_telemetry`` subdir is found
  either way). Open the result in Perfetto or chrome://tracing.
- ``report PATHS... [--json]`` — the overlap-efficiency summary (the same
  math as the ``overlap`` block of ``summary.json``): host-busy vs
  device-busy vs overlapped wall time, from the span intervals.
- ``trace REQUEST_ID PATHS... [-o trace.json]`` — the per-request
  Chrome trace for ONE serve request: the daemon's lifecycle spans
  (admission, request, queue_wait) and the resident extractor's group
  dispatch and per-video stages (``runtime/telemetry.py::
  request_trace_rows``). Pass the daemon's output root.
- ``ledger PATH [--json]`` — render the device cost ledger
  (``telemetry/ledger.py``): per-(model, fn family, bucket, sharding)
  flops and memory bytes, plus the per-model resident projection. PATH
  is the ledger JSON, a directory holding it, or a run's output root
  (ledger under ``_telemetry/``). Either package's ledger file reads.

Exit codes: 0 ok, 2 usage error, no spans found, or no ledger at PATH.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Any, List

from video_features_tpu_torch.runtime.telemetry import (
    overlap_report,
    read_spans,
    request_trace_rows,
    spans_to_chrome_trace,
)


def _resolve_span_files(paths: List[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            tdir = p
            if os.path.isdir(os.path.join(p, "_telemetry")):
                tdir = os.path.join(p, "_telemetry")
            out.extend(sorted(glob.glob(os.path.join(tdir, "spans-*.jsonl"))))
        else:
            out.append(p)
    return out


def _resolve_ledger_path(path: str) -> str:
    """PATH may be the ledger file itself, a directory holding it (the
    JAX package's ``--compile_cache``), or a run's output root (ledger
    under ``_telemetry/``)."""
    from video_features_tpu_torch.telemetry.ledger import LEDGER_FILENAME

    if os.path.isdir(path):
        for candidate in (
            os.path.join(path, LEDGER_FILENAME),
            os.path.join(path, "_telemetry", LEDGER_FILENAME),
        ):
            if os.path.isfile(candidate):
                return candidate
        return os.path.join(path, LEDGER_FILENAME)  # for the error message
    return path


def _ledger_main(args: Any) -> int:
    from video_features_tpu_torch.telemetry.ledger import format_bytes, load_ledger

    path = _resolve_ledger_path(args.path)
    ledger = load_ledger(path)
    if ledger is None:
        print(f"telemetry: no ledger at {path}", file=sys.stderr)
        return 2
    snap = ledger.snapshot()
    if args.json:
        print(json.dumps(snap, indent=2, sort_keys=True))
        return 0
    entries = snap["entries"]
    print(f"ledger: {path} ({len(entries)} executable(s))")
    header = (
        f"{'model':<20} {'family':<20} {'bucket':<16} {'sharding':<8} "
        f"{'platform':<8} {'flops':>12} {'moved':>10} {'hbm args':>10} "
        f"{'temp':>10}"
    )
    print(header)
    print("-" * len(header))
    for e in entries:
        mem = e.get("memory", {})
        flops = e.get("flops")
        moved = e.get("bytes_accessed")
        print(
            f"{e.get('model', '~'):<20} {e.get('family', '~'):<20} "
            f"{e.get('bucket', '~'):<16} {e.get('sharding', '~'):<8} "
            f"{e.get('platform', '~'):<8} "
            f"{(f'{flops:.3g}' if flops is not None else '-'):>12} "
            f"{(format_bytes(moved) if moved is not None else '-'):>10} "
            f"{(format_bytes(mem['argument_bytes']) if 'argument_bytes' in mem else '-'):>10} "
            f"{(format_bytes(mem['temp_bytes']) if 'temp_bytes' in mem else '-'):>10}"
        )
    proj = snap["hbm_projection"]
    if proj:
        print("projected resident HBM per model:")
        for model, p in sorted(proj.items()):
            print(
                f"  {model}: {format_bytes(p['resident'])} "
                f"(arguments {format_bytes(p['arguments'])}, outputs "
                f"{format_bytes(p['outputs'])}, temp {format_bytes(p['temp'])}, "
                f"code {format_bytes(p['generated_code'])})"
            )
    else:
        print("projected resident HBM: none (no HBM-platform entries — "
              "CPU-backend runs record flops only)")
    return 0


def main(argv: List[str]) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m video_features_tpu_torch.telemetry",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_export = sub.add_parser("export", help="spans JSONL -> Chrome-trace JSON")
    p_export.add_argument("paths", nargs="+",
                          help="spans-*.jsonl files, a _telemetry dir, or an output root")
    p_export.add_argument("-o", "--output", default=None,
                          help="trace JSON path (default: stdout)")
    p_export.add_argument("--device-lanes", action="store_true",
                          help="mirror device-stage spans (h2d/dispatch/"
                               "fetch) into one Perfetto lane per device")
    p_report = sub.add_parser("report", help="overlap-efficiency summary")
    p_report.add_argument("paths", nargs="+",
                          help="spans-*.jsonl files, a _telemetry dir, or an output root")
    p_report.add_argument("--json", action="store_true", help="emit the raw report dict")
    p_trace = sub.add_parser(
        "trace", help="one serve request's spans -> Chrome-trace JSON"
    )
    p_trace.add_argument("request_id", help="the request id (lifecycle record id)")
    p_trace.add_argument("paths", nargs="+",
                         help="spans-*.jsonl files, a _telemetry dir, or an output root")
    p_trace.add_argument("-o", "--output", default=None,
                         help="trace JSON path (default: stdout)")
    p_ledger = sub.add_parser(
        "ledger", help="render the device cost ledger (flops/memory per model call)"
    )
    p_ledger.add_argument(
        "path",
        help="cost_ledger.json, a directory holding it, or an output root",
    )
    p_ledger.add_argument("--json", action="store_true",
                          help="emit the raw ledger snapshot")
    args = parser.parse_args(argv)

    if args.cmd == "ledger":
        return _ledger_main(args)

    rows = []
    for f in _resolve_span_files(args.paths):
        try:
            rows.extend(read_spans(f))
        except OSError as e:
            print(f"telemetry: cannot read {f}: {e}", file=sys.stderr)
            return 2
    if not rows:
        print("telemetry: no spans found", file=sys.stderr)
        return 2

    if args.cmd in ("export", "trace"):
        if args.cmd == "trace":
            rows = request_trace_rows(rows, args.request_id)
            if not rows:
                print(
                    f"telemetry: no spans mention request {args.request_id!r}",
                    file=sys.stderr,
                )
                return 2
        trace = spans_to_chrome_trace(
            rows, device_lanes=getattr(args, "device_lanes", False)
        )
        text = json.dumps(trace)
        if args.output:
            with open(args.output, "w", encoding="utf-8") as f:
                f.write(text)
            print(
                f"telemetry: wrote {len(trace['traceEvents'])} events to "
                f"{args.output} — open at https://ui.perfetto.dev",
                file=sys.stderr,
            )
        else:
            print(text)
        return 0

    rep = overlap_report(rows)
    if args.json:
        print(json.dumps(rep, indent=2))
        return 0
    print(
        f"spans: {rep['spans']} | wall {rep['wall_s']:.2f}s | "
        f"host busy {rep['host_busy_s']:.2f}s | device busy {rep['device_busy_s']:.2f}s"
    )
    print(
        f"overlap: {rep['overlap_s']:.2f}s = {rep['overlap_efficiency']:.1%} of wall, "
        f"{rep['overlap_of_device']:.1%} of device-busy time"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
