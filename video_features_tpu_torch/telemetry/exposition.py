"""Prometheus text exposition (v0.0.4) rendering + a strict checker.

Counterpart of ``video_features_tpu/telemetry/exposition.py``, copied as
it is (stdlib only; the family names and HELP texts are the JAX
package's, so one snapshot — registry or cost ledger — renders
byte-identical text in both).

The serve daemon's ``GET /metrics`` endpoint (serve/server.py) renders
the live :class:`~video_features_tpu_torch.runtime.telemetry.MetricsRegistry`
snapshot — counters, gauges, and the log-bucketed stage/service-time
histograms — as Prometheus text exposition, **stdlib only**: the
container bakes no prometheus_client and the format is simple enough
that a renderer plus a validating checker is smaller than the
dependency would be.

Two halves:

- :func:`render_families` / :func:`families_from_snapshot` — the write
  side. Registry names follow the repo's dotted conventions
  (``stage_s.decode``, ``queue_depth.admission``,
  ``group_service_s.<feature_type>|<bucket>``,
  ``requests_<state>``); this module maps them onto properly labelled
  Prometheus families (``vft_stage_seconds{stage="decode"}`` …) so the
  same dashboards hold whatever hardware is behind the daemon
  (per-(model, bucket) series, never per-device).
- :func:`validate_exposition` — the read side: a pure-python checker of
  the exposition grammar (metric/label name charsets, label-value
  escaping, HELP/TYPE pairing, counter ``_total`` convention, histogram
  ``_bucket``/``_sum``/``_count`` shape with cumulative ``le`` buckets
  ending at ``+Inf``). ``chip_smoke.py`` validates the live endpoint's
  bytes through this.

No daemon imports: this module is pure data-in/text-out.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

METRIC_PREFIX = "vft_"

_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_SANITIZE_RE = re.compile(r"[^a-zA-Z0-9_:]")

# the serve-native group service-time histograms are registry-named
# "group_service_s.<feature_type>|<bucket>" — '|' never appears in a
# feature type (slashes do: CLIP-ViT-B/32) or a WxH bucket string
GROUP_SERVICE_SEP = "|"


# Unlabelled registry series with curated HELP text. Every producer-side
# metric name must map to a family here or to one of the labelled
# branches in families_from_snapshot — the sanitized fallback renders a
# name nobody documented.
_PLAIN_COUNTERS = {
    "frames_decoded": (
        "Video frames decoded across all decode workers (sampled frames "
        "entering the host pipeline, not raw container frames)."
    ),
    "h2d_bytes": (
        "Bytes staged host-to-device through the async ingest "
        "double-buffer (docs/tpu.md)."
    ),
    "videos_done": (
        "Videos fully extracted and committed by the sink (resume-safe "
        "completions, not attempts)."
    ),
    # the JAX package's family, produced in the port by the first call of
    # a built module at each argument signature (telemetry/ledger.py)
    "compiles": (
        "First calls of a built module at a new argument signature, each "
        "a compile span — growth after warmup means a shape leaked past "
        "bucketing."
    ),
    "retries": (
        "Per-video extraction retries after a retryable worker failure "
        "(--max_retries bounds these per video)."
    ),
    "groups_dispatched": (
        "Fused request groups handed to a device executor by the "
        "serve batcher."
    ),
    "deadline_missed": (
        "Requests that finished after their --deadline_ms budget "
        "(completed late, not dropped)."
    ),
}
_PLAIN_GAUGES = {
    "buckets_seen": (
        "Distinct shape buckets observed this run — the compile-surface "
        "cardinality the bucketing policy is holding."
    ),
    "groups_inflight": (
        "1 while a fused group occupies the device executor, else 0 "
        "(single-executor dispatch; see docs/serving.md)."
    ),
    "queue_age_oldest_s": (
        "Age in seconds of the oldest request waiting in the batcher "
        "queue — the head-of-line latency the scheduler is quoting."
    ),
    "device_mem_headroom_bytes": (
        "HBM budget minus the cost ledger's resident-bytes projection "
        "(what the preemptor spends; negative means overcommit)."
    ),
}


def group_service_metric(feature_type: str, bucket: str) -> str:
    """The registry histogram name for one (feature_type, bucket) group
    service-time series (daemon observes it; /metrics renders it)."""
    return f"group_service_s.{feature_type}{GROUP_SERVICE_SEP}{bucket}"


class Family:
    """One exposition family: a TYPE, a HELP line, and its samples.

    ``type`` is ``counter`` / ``gauge`` / ``histogram``. Counter and
    gauge samples are ``(labels, value)``; histogram samples are
    ``(labels, hist)`` where ``hist`` is the registry snapshot dict
    (``count``/``sum``/``bounds``/``buckets``, buckets non-cumulative
    with one overflow bucket past the last bound)."""

    def __init__(self, name: str, type: str, help: str) -> None:
        assert type in ("counter", "gauge", "histogram"), type
        self.name = name
        self.type = type
        self.help = help
        self.samples: List[Tuple[Dict[str, str], Any]] = []

    def add(self, labels: Optional[Dict[str, str]], value: Any) -> "Family":
        self.samples.append((dict(labels or {}), value))
        return self


def sanitize_metric_name(name: str) -> str:
    out = _SANITIZE_RE.sub("_", name)
    if not out or not _METRIC_NAME_RE.match(out):
        out = "_" + out
    return out


def escape_label_value(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(value: float) -> str:
    v = float(value)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _labels_text(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{escape_label_value(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def render_families(families: Sequence[Family]) -> str:
    """Families -> exposition text (deterministic: families sorted by
    name, labels sorted within a sample). Ends with a newline, as the
    format requires."""
    lines: List[str] = []
    for fam in sorted(families, key=lambda f: f.name):
        lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.type}")
        for labels, value in fam.samples:
            if fam.type == "histogram":
                cum = 0
                for bound, n in zip(value["bounds"], value["buckets"]):
                    cum += int(n)
                    ls = _labels_text({**labels, "le": _fmt(bound)})
                    lines.append(f"{fam.name}_bucket{ls} {cum}")
                ls = _labels_text({**labels, "le": "+Inf"})
                lines.append(f"{fam.name}_bucket{ls} {int(value['count'])}")
                lines.append(f"{fam.name}_sum{_labels_text(labels)} {_fmt(value['sum'])}")
                lines.append(f"{fam.name}_count{_labels_text(labels)} {int(value['count'])}")
            else:
                lines.append(f"{fam.name}{_labels_text(labels)} {_fmt(value)}")
    return "\n".join(lines) + "\n"


# -- registry snapshot -> families ---------------------------------------


def families_from_snapshot(snap: Dict[str, Any]) -> List[Family]:
    """Map a MetricsRegistry snapshot onto labelled families using the
    registry's dotted naming conventions. Unrecognized names degrade to
    a sanitized unlabelled series rather than being dropped: /metrics
    must never silently hide a counter someone added."""
    fams: Dict[str, Family] = {}

    def fam(name: str, type: str, help: str) -> Family:
        f = fams.get(name)
        if f is None:
            f = fams[name] = Family(name, type, help)
        return f

    for name, value in sorted(snap.get("counters", {}).items()):
        # "requests_shed.<reason>" must be matched BEFORE the generic
        # "requests_" prefix below (it IS a requests_ name)
        if name.startswith("requests_shed."):
            fam(
                f"{METRIC_PREFIX}requests_total", "counter",
                "Serve requests reaching each lifecycle state (terminal "
                "states plus admitted/deferred/requeued).",
            ).add(
                {"state": "shed", "shed_reason": name[len("requests_shed."):]},
                value,
            )
        elif name.startswith("requests_"):
            fam(
                f"{METRIC_PREFIX}requests_total", "counter",
                "Serve requests reaching each lifecycle state (terminal "
                "states plus admitted/deferred/requeued).",
            ).add({"state": name[len("requests_"):]}, value)
        elif name.startswith("preemptions."):
            fam(
                f"{METRIC_PREFIX}preemptions_total", "counter",
                "HBM-aware preemptions per evicted feature type (the "
                "victim's extractor was torn down to fit an "
                "overcommitting burst; see docs/serving.md \"Fleet "
                "operation\").",
            ).add({"feature_type": name[len("preemptions."):]}, value)
        elif name.startswith("lease_steals."):
            fam(
                f"{METRIC_PREFIX}lease_steals_total", "counter",
                "Spool lease files stolen from dead/stalled replicas, "
                "per feature type of the reclaimed request.",
            ).add({"feature_type": name[len("lease_steals."):]}, value)
        elif name == "lease_expired":
            fam(
                f"{METRIC_PREFIX}lease_expired_total", "counter",
                "Spool leases that aged past --lease_timeout_s without a "
                "heartbeat and were reclaimed by a surviving replica.",
            ).add(None, value)
        elif name == "windows_skipped":
            fam(
                f"{METRIC_PREFIX}windows_skipped_total", "counter",
                "Near-duplicate sampled frames skipped before H2D by "
                "--frame_delta_threshold (features filled by "
                "copy-forward; see docs/tpu.md).",
            ).add(None, value)
        elif name.startswith("cache_hit."):
            fam(
                f"{METRIC_PREFIX}cache_hit_total", "counter",
                "Content-addressed feature cache hits per feature type "
                "(request served from the store without decode or "
                "dispatch; see docs/serving.md).",
            ).add({"feature_type": name[len("cache_hit."):]}, value)
        elif name.startswith("cache_miss."):
            fam(
                f"{METRIC_PREFIX}cache_miss_total", "counter",
                "Content-addressed feature cache misses per feature type "
                "(extraction ran and populated the store).",
            ).add({"feature_type": name[len("cache_miss."):]}, value)
        elif name in _PLAIN_COUNTERS:
            fam(
                f"{METRIC_PREFIX}{name}_total", "counter",
                _PLAIN_COUNTERS[name],
            ).add(None, value)
        else:
            fam(
                f"{METRIC_PREFIX}{sanitize_metric_name(name)}_total", "counter",
                f"Registry counter {name!r}.",
            ).add(None, value)
    for name, value in sorted(snap.get("gauges", {}).items()):
        if name.startswith("queue_depth."):
            fam(
                f"{METRIC_PREFIX}queue_depth", "gauge",
                "Live queue depths by queue name (admission = requests "
                "admitted but not yet terminal; inflight = dispatched "
                "device groups not yet fetched; prepared = host-resident "
                "payloads waiting to dispatch; the backpressure bounds).",
            ).add({"queue": name[len("queue_depth."):]}, value)
        elif name.startswith("replica_up."):
            fam(
                f"{METRIC_PREFIX}replica_up", "gauge",
                "Fleet membership: 1 when the replica's heartbeat file "
                "is fresher than --lease_timeout_s, else 0 (survivors "
                "reclaim a down replica's leases and requests).",
            ).add({"replica": name[len("replica_up."):]}, value)
        elif name.startswith("device_mem_bytes."):
            # DeviceMemorySampler gauges: "device_mem_bytes.<device>|<kind>"
            # (absent entirely on backends without device.memory_stats())
            dev, _, kind = name[len("device_mem_bytes."):].partition(
                GROUP_SERVICE_SEP
            )
            fam(
                f"{METRIC_PREFIX}device_mem_bytes", "gauge",
                "Live device memory by device and kind (in_use/limit/"
                "peak/reserved), polled from device.memory_stats(); "
                "absent on backends without the API.",
            ).add({"device": dev, "kind": kind or "~"}, value)
        elif name in _PLAIN_GAUGES:
            fam(
                f"{METRIC_PREFIX}{name}", "gauge",
                _PLAIN_GAUGES[name],
            ).add(None, value)
        else:
            fam(
                f"{METRIC_PREFIX}{sanitize_metric_name(name)}", "gauge",
                f"Registry gauge {name!r}.",
            ).add(None, value)
    for name, hist in sorted(snap.get("histograms", {}).items()):
        if name.startswith("stage_s."):
            fam(
                f"{METRIC_PREFIX}stage_seconds", "histogram",
                "Per-stage latency (seconds) over the pipeline's own "
                "stage names (docs/observability.md).",
            ).add({"stage": name[len("stage_s."):]}, hist)
        elif name.startswith("group_service_s."):
            ft, _, bucket = name[len("group_service_s."):].partition(GROUP_SERVICE_SEP)
            fam(
                f"{METRIC_PREFIX}group_service_seconds", "histogram",
                "Fused-group service time (seconds) per (feature_type, "
                "bucket) — the series the edf-cost scheduler's "
                "ServiceTimeModel is calibrated from.",
            ).add({"feature_type": ft, "bucket": bucket or "~"}, hist)
        else:
            fam(
                f"{METRIC_PREFIX}{sanitize_metric_name(name)}", "histogram",
                f"Registry histogram {name!r}.",
            ).add(None, hist)
    return list(fams.values())


# -- ledger snapshot -> families -----------------------------------------


def families_from_ledger(snapshot: Dict[str, Any]) -> List[Family]:
    """Exposition families from a CostLedger snapshot
    (telemetry/ledger.py): per-executable flops / bytes-accessed for
    every entry (present on any backend — CPU included, the
    cost_analysis API is portable), and the per-model resident-HBM
    projection ``vft_hbm_bytes{model,kind}`` — which only exists for
    entries built on an HBM platform, so a CPU daemon's /metrics
    legitimately has no ``vft_hbm_*`` series."""
    fams: List[Family] = []
    f_flops = Family(
        f"{METRIC_PREFIX}executable_flops", "gauge",
        "Flops per built executable (cost_analysis), keyed by model, "
        "fn family, spatial bucket, and sharding mode.",
    )
    f_moved = Family(
        f"{METRIC_PREFIX}executable_bytes_accessed", "gauge",
        "Bytes accessed per built executable (cost_analysis).",
    )
    for e in snapshot.get("entries", []):
        labels = {
            "model": str(e.get("model", "~")),
            "family": str(e.get("family", "~")),
            "bucket": str(e.get("bucket", "~")),
            "sharding": str(e.get("sharding", "~")),
        }
        if "flops" in e:
            f_flops.add(labels, e["flops"])
        if "bytes_accessed" in e:
            f_moved.add(labels, e["bytes_accessed"])
    if f_flops.samples:
        fams.append(f_flops)
    if f_moved.samples:
        fams.append(f_moved)
    f_hbm = Family(
        f"{METRIC_PREFIX}hbm_bytes", "gauge",
        "Projected resident HBM bytes per model and kind (arguments/"
        "outputs/temp/generated_code/resident), from memory_analysis "
        "of each built executable; absent on CPU backends.",
    )
    for model, proj in sorted(snapshot.get("hbm_projection", {}).items()):
        for kind, v in sorted(proj.items()):
            f_hbm.add({"model": model, "kind": kind}, v)
    if f_hbm.samples:
        fams.append(f_hbm)
    return fams


# -- the checker ---------------------------------------------------------


def _parse_labels(text: str) -> Tuple[Optional[Dict[str, str]], Optional[str]]:
    """Parse the ``{...}`` label block body (no braces). Returns
    (labels, None) or (None, error)."""
    labels: Dict[str, str] = {}
    i, n = 0, len(text)
    while i < n:
        j = i
        while j < n and text[j] not in "=,{}\"":
            j += 1
        name = text[i:j]
        if not _LABEL_NAME_RE.match(name):
            return None, f"bad label name {name!r}"
        if j >= n or text[j] != "=":
            return None, f"expected '=' after label {name!r}"
        j += 1
        if j >= n or text[j] != '"':
            return None, f"label {name!r} value is not quoted"
        j += 1
        buf: List[str] = []
        while j < n and text[j] != '"':
            c = text[j]
            if c == "\\":
                if j + 1 >= n:
                    return None, f"dangling escape in label {name!r}"
                esc = text[j + 1]
                if esc not in ('\\', '"', 'n'):
                    return None, f"bad escape '\\{esc}' in label {name!r}"
                buf.append({"\\": "\\", '"': '"', "n": "\n"}[esc])
                j += 2
            else:
                if c == "\n":
                    return None, f"raw newline in label {name!r}"
                buf.append(c)
                j += 1
        if j >= n:
            return None, f"unterminated value for label {name!r}"
        if name in labels:
            return None, f"duplicate label {name!r}"
        labels[name] = "".join(buf)
        j += 1  # closing quote
        if j < n:
            if text[j] != ",":
                return None, f"expected ',' after label {name!r}"
            j += 1
        i = j
    return labels, None


def validate_exposition(text: str) -> List[str]:
    """Check ``text`` against the Prometheus text-exposition grammar
    plus this repo's conventions. Returns a list of human-readable
    errors — empty means valid. Enforced rules:

    - every line is a ``# HELP``/``# TYPE`` comment or a sample;
      the document ends with a newline;
    - metric names match ``[a-zA-Z_:][a-zA-Z0-9_:]*``, label names
      match ``[a-zA-Z_][a-zA-Z0-9_]*``, label values are quoted with
      only ``\\\\``/``\\"``/``\\n`` escapes, values parse as floats;
    - HELP/TYPE pairing: each family has exactly one of each, TYPE
      before any of its samples, and no sample lacks a TYPE;
    - counters are named ``*_total``; histogram families expose
      ``_bucket`` (with ``le``, cumulative, ending at ``+Inf``),
      ``_sum`` and ``_count`` (equal to the ``+Inf`` bucket) per
      label set, and nothing else.
    """
    errors: List[str] = []
    if not text:
        return ["empty exposition"]
    if not text.endswith("\n"):
        errors.append("exposition must end with a newline")
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    sampled_before_type: set = set()
    # family -> base-labels-key -> {"buckets": [(le, v)], "sum": v, "count": v}
    hists: Dict[str, Dict[Tuple, Dict[str, Any]]] = {}
    sample_names: set = set()

    def base_of(name: str) -> str:
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix):
                base = name[: -len(suffix)]
                if types.get(base) == "histogram":
                    return base
        return name

    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 2 and parts[1] in ("HELP", "TYPE"):
                if len(parts) < 3:
                    errors.append(f"line {ln}: # {parts[1]} without a metric name")
                    continue
                name = parts[2]
                if not _METRIC_NAME_RE.match(name):
                    errors.append(f"line {ln}: bad metric name {name!r} in {parts[1]}")
                    continue
                if parts[1] == "HELP":
                    if name in helps:
                        errors.append(f"line {ln}: duplicate HELP for {name}")
                    helps[name] = parts[3] if len(parts) > 3 else ""
                else:
                    kind = parts[3].strip() if len(parts) > 3 else ""
                    if kind not in ("counter", "gauge", "histogram", "summary", "untyped"):
                        errors.append(f"line {ln}: bad TYPE {kind!r} for {name}")
                        continue
                    if name in types:
                        errors.append(f"line {ln}: duplicate TYPE for {name}")
                    if name in sampled_before_type:
                        errors.append(f"line {ln}: TYPE for {name} appears after its samples")
                    types[name] = kind
                    if kind == "counter" and not name.endswith("_total"):
                        errors.append(f"line {ln}: counter {name} must end in _total")
            continue
        # sample line: name[{labels}] value [timestamp]
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)", line)
        if not m:
            errors.append(f"line {ln}: bad sample line {line!r}")
            continue
        name = m.group(1)
        rest = line[m.end():]
        labels: Dict[str, str] = {}
        if rest.startswith("{"):
            close = rest.rfind("}")
            if close < 0:
                errors.append(f"line {ln}: unterminated label block")
                continue
            parsed, err = _parse_labels(rest[1:close])
            if err:
                errors.append(f"line {ln}: {err}")
                continue
            labels = parsed or {}
            rest = rest[close + 1:]
        fields = rest.split()
        if len(fields) not in (1, 2):
            errors.append(f"line {ln}: expected '<value> [timestamp]', got {rest!r}")
            continue
        try:
            value = float(fields[0])
        except ValueError:
            errors.append(f"line {ln}: bad sample value {fields[0]!r}")
            continue
        if len(fields) == 2:
            try:
                int(fields[1])
            except ValueError:
                errors.append(f"line {ln}: bad timestamp {fields[1]!r}")
        base = base_of(name)
        sample_names.add(base)
        if base not in types:
            sampled_before_type.add(base)
        kind = types.get(base)
        if kind == "histogram":
            key = tuple(sorted((k, v) for k, v in labels.items() if k != "le"))
            slot = hists.setdefault(base, {}).setdefault(
                key, {"buckets": [], "sum": None, "count": None}
            )
            if name.endswith("_bucket"):
                le = labels.get("le")
                if le is None:
                    errors.append(f"line {ln}: histogram bucket for {base} lacks 'le'")
                else:
                    slot["buckets"].append((le, value))
            elif name.endswith("_sum"):
                slot["sum"] = value
            elif name.endswith("_count"):
                slot["count"] = value
            else:
                errors.append(
                    f"line {ln}: sample {name} of histogram {base} is not "
                    "_bucket/_sum/_count"
                )
        elif "le" in labels:
            errors.append(f"line {ln}: 'le' label on non-histogram sample {name}")

    for name in sample_names:
        if name not in types:
            errors.append(f"sampled metric {name} has no # TYPE line")
        if name not in helps:
            errors.append(f"sampled metric {name} has no # HELP line")
    for name in types:
        if name not in helps:
            errors.append(f"# TYPE {name} has no matching # HELP")
    for name in helps:
        if name not in types:
            errors.append(f"# HELP {name} has no matching # TYPE")

    def _le_key(le: str) -> float:
        return float("inf") if le == "+Inf" else float(le)

    for base, series in hists.items():
        for key, slot in series.items():
            where = f"{base}{dict(key) if key else ''}"
            les = [le for le, _ in slot["buckets"]]
            if "+Inf" not in les:
                errors.append(f"{where}: no le=\"+Inf\" bucket")
                continue
            try:
                ordered = sorted(slot["buckets"], key=lambda p: _le_key(p[0]))
            except ValueError:
                errors.append(f"{where}: unparsable le bound")
                continue
            vals = [v for _, v in ordered]
            if any(b > a for a, b in zip(vals[1:], vals)):
                errors.append(f"{where}: bucket counts are not cumulative")
            if slot["count"] is None or slot["sum"] is None:
                errors.append(f"{where}: missing _count or _sum")
            elif vals and slot["count"] != vals[-1]:
                errors.append(
                    f"{where}: _count {slot['count']} != +Inf bucket {vals[-1]}"
                )
    return errors


# the name the tests and docs use for the read side; same contract as
# validate_exposition (returns the error list, empty == valid)
check_exposition = validate_exposition
