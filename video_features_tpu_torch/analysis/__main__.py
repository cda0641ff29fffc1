"""CLI: ``python -m video_features_tpu_torch.analysis [paths...]``.

Counterpart of ``video_features_tpu/analysis/__main__.py``, without
``--update-budgets`` (the port has no compile budget, and its parity
ceilings are a reviewed edit of ``config.PARITY_CEILINGS``). The default
sweep is the ``video_features_tpu_torch`` package.

Exit codes: 0 clean, 1 findings, 2 usage/parse error. Findings print as
``file:line:col: GC### rule-name: message`` plus a fix hint — the format
scripts/check.sh and CI grep. ``--json`` emits a machine-readable list
(schema: ``analysis/findings_schema.json``).

Modes beyond the sweep:

- ``--rule GC301,host-sync`` — filter by rule id / name prefix; both the
  repeatable flag and comma-separated lists work.
- ``--diff BASE`` — only report findings on lines changed vs the git ref
  (``--diff origin/main`` is the incremental CI mode).
- ``--explain GC10x[:pathsub]`` — print matching findings WITH their
  interprocedural propagation chain (device-taint path, thread
  reachability), one ``via:`` line per hop.
- ``--sarif`` — the findings as a SARIF 2.1.0 document.

No import of the checked code, no package import side effects beyond the
analysis subpackage itself: the suite parses source, it never executes
it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Dict, List, Optional, Set, Tuple


def _split_rule_tokens(raw: Optional[List[str]]) -> Optional[List[str]]:
    if not raw:
        return None
    out: List[str] = []
    for item in raw:
        out.extend(t.strip() for t in item.split(",") if t.strip())
    return out or None


def _changed_lines(base: str) -> Optional[Dict[str, Set[int]]]:
    """abs path -> set of (new-side) line numbers changed vs ``base``,
    parsed from ``git diff --unified=0``. None on git failure."""
    try:
        top = subprocess.run(
            ["git", "rev-parse", "--show-toplevel"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
        diff = subprocess.run(
            ["git", "diff", "--unified=0", base, "--", "*.py"],
            capture_output=True, text=True, check=True, cwd=top,
        ).stdout
    except (subprocess.CalledProcessError, OSError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        print(f"graftcheck: --diff {base} failed: {detail.strip()}",
              file=sys.stderr)
        return None
    changed: Dict[str, Set[int]] = {}
    current: Optional[str] = None
    for line in diff.splitlines():
        if line.startswith("+++ "):
            name = line[4:].strip()
            if name == "/dev/null":
                current = None
            else:
                current = os.path.abspath(
                    os.path.join(top, name[2:] if name.startswith("b/") else name)
                )
        elif line.startswith("@@") and current is not None:
            # @@ -l,c +start[,count] @@
            try:
                new = line.split("+", 1)[1].split(" ", 1)[0]
                start, _, count = new.partition(",")
                first = int(start)
                n = int(count) if count else 1
            except (IndexError, ValueError):
                continue
            if n > 0:
                changed.setdefault(current, set()).update(
                    range(first, first + n)
                )
    return changed


def _parse_explain(spec: str) -> Tuple[str, Optional[str]]:
    rule, _, pathsub = spec.partition(":")
    return rule.strip(), (pathsub.strip() or None)


def _repo_relative(path: str) -> str:
    """SARIF artifact URIs are repo-relative so GitHub code scanning can
    anchor annotations; fall back to the cwd when not in a git checkout."""
    try:
        top = subprocess.run(
            ["git", "rev-parse", "--show-toplevel"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
    except (subprocess.CalledProcessError, OSError):
        top = os.getcwd()
    rel = os.path.relpath(os.path.abspath(path), top)
    return rel.replace(os.sep, "/")


def _sarif(findings, rules) -> Dict[str, object]:
    """SARIF 2.1.0 log: one run, the full rule catalogue in the driver
    (so suppressed-to-zero runs still upload a valid ruleset), findings
    as level=error results with the fix hint folded into the message."""
    results = []
    for f in findings:
        message = f.message if not f.hint else f"{f.message} (fix: {f.hint})"
        results.append(
            {
                "ruleId": f.rule.id,
                "level": "error",
                "message": {"text": message},
                "locations": [
                    {
                        "physicalLocation": {
                            "artifactLocation": {
                                "uri": _repo_relative(f.path),
                                "uriBaseId": "%SRCROOT%",
                            },
                            "region": {
                                "startLine": f.line,
                                # SARIF columns are 1-based; Finding.col
                                # is the 0-based AST col_offset
                                "startColumn": f.col + 1,
                            },
                        }
                    }
                ],
            }
        )
    return {
        "version": "2.1.0",
        "$schema": (
            "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
            "master/Schemata/sarif-schema-2.1.0.json"
        ),
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "graftcheck",
                        "informationUri": (
                            "https://github.com/video-features-tpu/"
                            "video-features-tpu/blob/main/docs/analysis.md"
                        ),
                        "rules": [
                            {
                                "id": r.id,
                                "name": r.name,
                                "shortDescription": {"text": r.summary},
                            }
                            for r in rules
                        ],
                    }
                },
                "results": results,
            }
        ],
    }


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m video_features_tpu_torch.analysis",
        description="graftcheck for the PyTorch/CUDA port: host-sync, "
        "thread-safety, concurrency, mesh-admission, durability, "
        "observability and numerics lints",
    )
    parser.add_argument(
        "paths", nargs="*",
        help="files/directories to check (default: video_features_tpu_torch)",
    )
    parser.add_argument(
        "--rule", action="append", default=None, metavar="TOKEN[,TOKEN...]",
        help="only report rules matching TOKEN (id like GC301, or a "
        "name prefix like host-sync); repeatable and comma-separable",
    )
    parser.add_argument(
        "--diff", default=None, metavar="BASE",
        help="only report findings on lines changed vs the git ref BASE "
        "(e.g. --diff origin/main for incremental CI)",
    )
    parser.add_argument(
        "--explain", default=None, metavar="RULE[:PATHSUB]",
        help="print matching findings with their propagation chain "
        "(e.g. --explain GC102:extract_clip)",
    )
    parser.add_argument("--json", action="store_true", help="JSON findings")
    parser.add_argument(
        "--sarif", action="store_true",
        help="SARIF 2.1.0 findings (GitHub code-scanning upload format)",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print the rule catalogue"
    )
    args = parser.parse_args(argv)

    from video_features_tpu_torch.analysis.core import all_rules, run_checks

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.id}  {rule.name:<24} {rule.summary}")
        return 0

    rule_tokens = _split_rule_tokens(args.rule)
    explain_rule: Optional[str] = None
    explain_path: Optional[str] = None
    if args.explain:
        explain_rule, explain_path = _parse_explain(args.explain)
        rule_tokens = (rule_tokens or []) + [explain_rule]

    try:
        findings = run_checks(args.paths or None, rules=rule_tokens)
    except (OSError, SyntaxError) as e:
        print(f"graftcheck: cannot analyze: {e}", file=sys.stderr)
        return 2

    if args.diff is not None:
        changed = _changed_lines(args.diff)
        if changed is None:
            return 2
        findings = [
            f for f in findings
            if f.line in changed.get(os.path.abspath(f.path), ())
        ]

    if args.explain:
        if explain_path:
            findings = [f for f in findings if explain_path in f.path]
        for f in findings:
            print(f.format_trace())
        print(
            f"graftcheck: {len(findings)} finding(s) for {args.explain}"
            if findings
            else f"graftcheck: nothing to explain for {args.explain}"
        )
        return 1 if findings else 0

    if args.sarif:
        print(json.dumps(_sarif(findings, all_rules()), indent=2))
    elif args.json:
        print(json.dumps([f.as_dict() for f in findings], indent=2))
    else:
        for f in findings:
            print(f.format())
        n = len(findings)
        print(
            f"graftcheck: {n} finding(s)"
            if n
            else "graftcheck: clean (waivers audited via `git grep graftcheck:`)"
        )
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
