"""GC10x — host-sync lint for hot modules.

Counterpart of ``video_features_tpu/analysis/hostsync.py``, retargeted at
PyTorch. The per-video loop's throughput depends on dispatch staying
asynchronous: the CUDA stream queues work and the host returns; the ONE
blocking point per group is the result fetch at the boundary
(``HostCopy.numpy()`` inside ``fetch_*``/``drain_*``). Any hidden sync
inside the hot modules (``extract/``, ``ops/``, ``models/*/model.py``,
``serve/``) inserts a round trip per call site:

- GC101: ``.item()`` (flagged regardless of taint, as in the JAX rule);
- GC102: ``float()``/``int()``/``bool()`` on a device tensor, and an
  ``if``/``while``/conditional expression whose test is one (Python asks
  the tensor for ``bool()``);
- GC103: ``.cpu()``, ``.numpy()``, ``.tolist()``, ``.to("cpu")`` and
  ``np.asarray``/``np.array`` of a device tensor;
- GC104: ``torch.cuda.synchronize()``, ``Event.synchronize()`` and
  ``Stream.synchronize()`` (any ``.synchronize()``: flagged regardless
  of taint), and ``torch.tensor``/``torch.as_tensor``/``torch.asarray``
  of host data with a device ``device=``: the upload copies from
  pageable memory, and PyTorch waits for the stream to drain before it
  returns (``torch.cuda.set_sync_debug_mode`` reports it on the card).

Device-value tracking is the interprocedural taint engine in
``taint.py``, with torch's device facts (a ``device=`` tensor,
``.to(device)``, a module's ``forward`` parameters, a kernel wrapper's
result); every finding carries the propagation chain in
``Finding.trace`` (``--explain GC10x`` prints it).

The sink/fetch boundary is allowlisted by function name: ``fetch_*``,
``_fetch*``, ``drain_*``, ``_drain*`` and ``*sink*`` functions exist to
sync (that is the contract — the pipelined loop calls them once per
group, after the next group's dispatch is already in flight). The
allowlist covers defs nested inside them too. ``sync_site_verdict``
answers, for a file and line that a run on the card saw synchronize
(``torch.cuda.set_sync_debug_mode``), whether GC10x allowlists or waives
it there (``chip_smoke.py``'s phase 25 holds the lint to that witness).
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional

from video_features_tpu_torch.analysis.core import (
    Finding,
    Rule,
    SourceFile,
    resolve_dotted,
)
from video_features_tpu_torch.analysis.taint import (
    _FETCH_METHODS,
    _FETCHERS,
    ProjectTaint,
    Taint,
    flatten_body,
    format_chain,
    is_cpu_expr,
    is_device_expr,
)

# torch's constructors from host data: with a device ``device=`` each is
# a blocking H2D copy from pageable memory
_UPLOADS = frozenset({"torch.tensor", "torch.as_tensor", "torch.asarray"})

RULES = {
    "GC101": Rule("GC101", "host-sync-item", ".item() forces a device->host sync"),
    "GC102": Rule(
        "GC102", "host-sync-cast",
        "float()/int()/bool() or an if-test on a device tensor syncs",
    ),
    "GC103": Rule(
        "GC103",
        "host-sync-fetch",
        ".cpu()/.numpy()/.tolist()/.to('cpu')/np.asarray on a device tensor syncs",
    ),
    "GC104": Rule(
        "GC104", "host-sync-block",
        ".synchronize() or a blocking torch.tensor(host, device=...) upload "
        "stalls the dispatch pipeline",
    ),
}

# the sink/fetch/drain boundary: these functions' JOB is the blocking
# fetch side of the pipeline. ``fetch_*`` are the extractor hooks
# (fetch_group/fetch_dispatched), ``drain_*`` is the pipelined loop's
# completion-queue drain (extract/base.py::drain_completed — the place
# dispatched handles become host numpy), and "sink" covers the result
# writers. Anything else that forces a device->host sync in a hot module
# is a finding.
ALLOWED_NAME_PREFIXES = ("fetch_", "_fetch", "drain_", "_drain")
ALLOWED_NAME_SUBSTRINGS = ("sink",)


def _allowlisted(name: str) -> bool:
    return name.startswith(ALLOWED_NAME_PREFIXES) or any(
        s in name for s in ALLOWED_NAME_SUBSTRINGS
    )


def check(src: SourceFile, project: ProjectTaint) -> List[Finding]:
    aliases = project._aliases[src.rel]
    findings: List[Finding] = []

    def trace_of(t: Taint, tail: str, line: int) -> List[str]:
        if not t.device or not t.chain:
            return []
        return format_chain(t.chain) + [f"{src.path}:{line}: {tail}"]

    def flag_call(node: ast.Call, env, info, fn_name: str) -> None:
        func = node.func
        taint = lambda e: project.expr_taint(e, env, src, info)  # noqa: E731
        if isinstance(func, ast.Attribute):
            if func.attr == "item" and not node.args:
                findings.append(
                    Finding(
                        src.path, node.lineno, node.col_offset, RULES["GC101"],
                        f".item() in hot function {fn_name!r}",
                        "keep the value on the device (torch.where/compare), "
                        "or move the read to the fetch boundary",
                        trace=trace_of(
                            taint(func.value), ".item() syncs here", node.lineno
                        ),
                    )
                )
                return
            if func.attr == "synchronize" and not node.args:
                rd = resolve_dotted(func, aliases) or f".{func.attr}"
                what = (
                    "torch.cuda.synchronize()" if rd == "torch.cuda.synchronize"
                    else ".synchronize()"
                )
                findings.append(
                    Finding(
                        src.path, node.lineno, node.col_offset, RULES["GC104"],
                        f"{what} in hot function {fn_name!r}",
                        "only the sink/fetch boundary may wait; record an "
                        "event and wait on it in fetch_*/drain_*, or make the "
                        "consumer stream wait_event() instead",
                        trace=trace_of(
                            taint(func.value), f"{what} blocks here", node.lineno
                        ),
                    )
                )
                return
            fetch = None
            if func.attr in _FETCH_METHODS and not node.args:
                fetch = f".{func.attr}()"
            elif func.attr == "to" and any(
                is_cpu_expr(a, aliases)
                for a in list(node.args[:1])
                + [kw.value for kw in node.keywords if kw.arg == "device"]
            ):
                fetch = '.to("cpu")'
            if fetch is not None:
                t = taint(func.value)
                if t.device:
                    findings.append(
                        Finding(
                            src.path, node.lineno, node.col_offset,
                            RULES["GC103"],
                            f"{fetch} on a device tensor in {fn_name!r}",
                            "return the device tensor (or a HostCopy) and let "
                            "fetch_*/the sink materialize it",
                            trace=trace_of(t, f"{fetch} syncs here", node.lineno),
                        )
                    )
                return
        rd = resolve_dotted(func, aliases)
        if rd in _UPLOADS and node.args and any(
            kw.arg == "device" and is_device_expr(kw.value, aliases)
            for kw in node.keywords
        ) and not taint(node.args[0]).device:
            findings.append(
                Finding(
                    src.path, node.lineno, node.col_offset, RULES["GC104"],
                    f"{rd}(<host data>, device=...) in hot function "
                    f"{fn_name!r}: a blocking upload from pageable memory "
                    "waits for the stream",
                    "build the constant on the device (torch.full, arithmetic "
                    "with Python scalars), upload it once at setup, or stage "
                    "it through pinned memory with non_blocking=True",
                )
            )
            return
        if rd in ("float", "int", "bool", "complex") and node.args:
            t = taint(node.args[0])
            if t.device:
                findings.append(
                    Finding(
                        src.path, node.lineno, node.col_offset, RULES["GC102"],
                        f"{rd}() on a device tensor in {fn_name!r}",
                        "keep the scalar on the device (torch ops) or fetch it "
                        "once at the sink boundary",
                        trace=trace_of(t, f"{rd}() syncs here", node.lineno),
                    )
                )
            return
        if rd in _FETCHERS:
            t = taint(node.args[0]) if node.args else Taint()
            if t.device:
                findings.append(
                    Finding(
                        src.path, node.lineno, node.col_offset, RULES["GC103"],
                        f"{rd}() on a device tensor in {fn_name!r}",
                        "return the device tensor (or a HostCopy) and let "
                        "fetch_*/the sink materialize it",
                        trace=trace_of(t, f"{rd}() syncs here", node.lineno),
                    )
                )

    def flag_test(test: ast.AST, env, info, fn_name: str) -> None:
        """``if t:`` / ``while t:`` / ``a if t else b`` on a device tensor:
        Python calls ``bool()`` on it. Identity and membership tests
        (``is None``, ``in``) never touch the tensor."""
        if isinstance(test, ast.Compare) and any(
            isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
            for op in test.ops
        ):
            return
        if isinstance(test, ast.BoolOp):
            for v in test.values:
                flag_test(v, env, info, fn_name)
            return
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            flag_test(test.operand, env, info, fn_name)
            return
        t = project.expr_taint(test, env, src, info)
        if t.device:
            findings.append(
                Finding(
                    src.path, test.lineno, test.col_offset, RULES["GC102"],
                    f"a branch on a device tensor in {fn_name!r}",
                    "branch on host metadata (shape, a host flag), or keep the "
                    "choice on the device with torch.where",
                    trace=trace_of(t, "bool() syncs here", test.lineno),
                )
            )

    def flag_scope(body, env, info, fn_name: str) -> None:
        """Walk each flattened statement's EXPRESSION children only
        (child statements are in the flat list themselves; nested defs
        get their own scope) so no call site is visited twice."""
        for st in flatten_body(body):
            if isinstance(st, (ast.If, ast.While)):
                flag_test(st.test, env, info, fn_name)
            for child in ast.iter_child_nodes(st):
                if isinstance(
                    child,
                    (ast.stmt, ast.excepthandler, ast.FunctionDef,
                     ast.AsyncFunctionDef),
                ) or type(child).__name__ == "match_case":
                    continue
                for node in ast.walk(child):
                    if isinstance(node, ast.Call):
                        flag_call(node, env, info, fn_name)
                    elif isinstance(node, ast.IfExp):
                        flag_test(node.test, env, info, fn_name)

    flag_scope(src.tree.body, project.module_env(src), None, "<module>")

    for key, info in project.graph.functions.items():
        if info.src is not src:
            continue
        if _scope_allowlisted(project, info):
            continue
        flag_scope(info.node.body, project.env_for(key), info, info.name)

    return findings


def _scope_allowlisted(project: ProjectTaint, info) -> bool:
    cur: Optional[object] = info
    while cur is not None:
        if _allowlisted(cur.name):
            return True
        cur = project.graph.functions.get(cur.parent) if cur.parent else None
    return False


def sync_site_verdict(path: str, line: int) -> str:
    """What GC10x says of a sync that a run saw at ``path:line`` (the
    innermost frame of the port): ``"cold"`` outside the hot modules,
    ``"allowlisted"`` inside a fetch/drain/sink function (or a def nested
    in one), ``"waived"`` under a ``# graftcheck: host-sync`` (or GC10x)
    waiver, else ``"unaccounted"`` — a sync the lint neither allows nor
    knows about. Parses the file; imports nothing of it."""
    from video_features_tpu_torch.analysis.core import _load

    src = _load(path, path.replace(os.sep, "/"))
    if not src.is_hot:
        return "cold"
    if any(src.waived(line, r) for r in RULES.values()):
        return "waived"
    enclosing = [
        node.name
        for node in ast.walk(src.tree)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        and node.lineno <= line <= (node.end_lineno or node.lineno)
    ]
    if any(_allowlisted(name) for name in enclosing):
        return "allowlisted"
    return "unaccounted"
