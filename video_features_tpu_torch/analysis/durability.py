"""GC60x — durability contracts for the crash-consistency layer.

Counterpart of ``video_features_tpu/analysis/durability.py``, copied; the
raw-write sinks also hold the port's own writers, ``torch.save`` and the
converted-weight codecs' ``flax_msgpack.save_msgpack`` and
``orbax.save_orbax``.

The fleet's survival story rests on a handful of filesystem idioms:
stage-under-``.tmp``-then-one-``os.replace`` publication
(io/sink.py, telemetry/ledger.py, serve/costmodel.py), claim-by-rename
work distribution (extract/cache.py, serve/sources.py), O_EXCL skip
claims (runtime/faults.py), and mtime-heartbeat lease files
(serve/sources.py). The chaos drills prove these protocols work *today*;
nothing stops a refactor from quietly replacing an atomic publish with a
bare ``json.dump`` — the torn-file bug only reappears under SIGKILL, far
from CI. GC60x makes the idioms themselves machine-checked:

- **GC601 durable-write-atomicity** — a raw write (``open(..., 'w')``,
  ``np.save``) whose target path mentions a durable root (``_manifest/``,
  ``_requests/``, ``_replicas/``, ``_telemetry/``, the cache or
  compile-cache neighborhoods, the spool) must stage under a temp sibling
  and publish with a single ``os.replace``/``os.rename`` in the same
  function — or go through a helper that does (interprocedural: a helper
  that renames satisfies its callers; a helper that raw-writes a
  parameter path is flagged at the caller passing the durable path, with
  the write site in the trace).
- **GC602 claim-protocol** — claim sites must branch on the failure
  outcome instead of assuming victory: ``os.open(..., O_CREAT|O_EXCL)``
  and rename-claims (dest mentions ``claim``/``lease``) need an enclosing
  ``try`` catching ``FileExistsError``/``OSError``; and a module that
  acquires lease/claim files by rename must heartbeat them — an
  ``os.utime`` reachable (exact-callee walk) from the module's poll loop,
  so a wedged-but-alive replica's leases go stale honestly.
- **GC603 rename-semantics** — a bare ``os.rename`` outside any
  ``try``/``except OSError`` is wrong on both of its legitimate readings:
  a *publish* wants ``os.replace`` (atomic overwrite, same semantics on
  every platform), a *claim* wants the loser branch GC602 enforces. Also
  flags ``tempfile`` staging without ``dir=`` whose product feeds a
  rename/replace: a temp file from the default tmpdir can sit on a
  different filesystem, where rename is not atomic (EXDEV).

Resolution is exact-only (concurrency.py semantics) and helper summaries
are depth-1: a caller is satisfied by the helper it calls directly, not
by a rename three frames down — the fix GC601 pushes toward is one
shared ``atomic_write_json``, not deep plumbing. Findings carry the
write/rename provenance in ``trace`` (``--explain GC601``).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from video_features_tpu_torch.analysis.callgraph import CallGraph, FunctionInfo
from video_features_tpu_torch.analysis.concurrency import _exact_callees, _own_nodes
from video_features_tpu_torch.analysis.core import (
    Finding,
    Rule,
    SourceFile,
    resolve_dotted,
)
from video_features_tpu_torch.analysis.taint import ProjectTaint

RULES = {
    "GC601": Rule(
        "GC601", "durable-write-atomicity",
        "a durable file (manifest/requests/telemetry/cache roots) is "
        "written in place — a kill mid-write leaves a torn file a reader "
        "will trust",
    ),
    "GC602": Rule(
        "GC602", "claim-protocol",
        "a claim/lease site assumes victory (no failure branch) or a "
        "lease module has no heartbeat reachable from its poll loop",
    ),
    "GC603": Rule(
        "GC603", "rename-semantics",
        "os.rename without a failure branch (publishes need os.replace), "
        "or tempfile staging outside the destination directory",
    ),
}

# Substrings of a write target's resolved text that mark it durable:
# shared-filesystem state another process (or the next run) will read
# back and trust. Matches both path constants ("_manifest/") and the
# identifier names flowing into the path (self._manifest_path, spool_dir).
_DURABLE_TOKENS = (
    "_manifest", "_requests", "_replicas", "_telemetry", "_skip_claims",
    "cache_dir", "compile_cache", "compilation_cache", "cost_model",
    "spool", "ledger_path",
)
_CLAIM_TOKENS = ("claim", "lease")
_WRITE_MODES = ("w", "x", "a")  # "a" handled separately (append is safe)
_FAILURE_HANDLERS = frozenset(
    {"OSError", "FileExistsError", "IOError", "EnvironmentError",
     "PermissionError", "Exception", "BaseException"}
)
_TEMPFILE_CTORS = frozenset(
    {"tempfile.mkstemp", "tempfile.mktemp", "tempfile.NamedTemporaryFile",
     "tempfile.TemporaryFile"}
)


def _const_text(expr: Optional[ast.AST]) -> List[str]:
    """Every string constant + identifier appearing in ``expr`` — the
    searchable text of a path expression."""
    out: List[str] = []
    if expr is None:
        return out
    for node in ast.walk(expr):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            out.append(node.value)
        elif isinstance(node, ast.Name):
            out.append(node.id)
        elif isinstance(node, ast.Attribute):
            out.append(node.attr)
    return out


def _names_of(expr: Optional[ast.AST]) -> Set[str]:
    """Local names a path expression is built from (for pairing a write's
    target with a later rename's source)."""
    if expr is None:
        return set()
    return {n.id for n in ast.walk(expr) if isinstance(n, ast.Name)}


@dataclasses.dataclass
class _WriteSite:
    node: ast.AST  # anchor (the open/np.save call)
    path: ast.AST  # the target path expression


@dataclasses.dataclass
class _RenameSite:
    node: ast.Call
    src_expr: Optional[ast.AST]
    dst_expr: Optional[ast.AST]
    op: str  # "os.rename" | "os.replace"
    guarded: bool  # inside try/except catching OSError-ish


@dataclasses.dataclass
class _FnScan:
    """One function's durability-relevant facts."""

    writes: List[_WriteSite] = dataclasses.field(default_factory=list)
    renames: List[_RenameSite] = dataclasses.field(default_factory=list)
    excl_opens: List[Tuple[ast.Call, bool]] = dataclasses.field(
        default_factory=list
    )  # (os.open O_EXCL site, guarded)
    utime_lines: List[int] = dataclasses.field(default_factory=list)
    tempfiles: List[Tuple[ast.Call, bool, Set[str]]] = dataclasses.field(
        default_factory=list
    )  # (call, has dir=, names bound to its result)
    assigns: Dict[str, ast.AST] = dataclasses.field(default_factory=dict)


def _handler_covers_failure(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:  # bare except
        return True
    names = []
    for sub in ast.walk(handler.type):
        if isinstance(sub, ast.Name):
            names.append(sub.id)
        elif isinstance(sub, ast.Attribute):
            names.append(sub.attr)
    return any(n in _FAILURE_HANDLERS for n in names)


def _is_write_mode(call: ast.Call) -> Optional[str]:
    """The constant mode string of an ``open`` call, when write-ish."""
    mode: Optional[ast.AST] = call.args[1] if len(call.args) > 1 else None
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if not (isinstance(mode, ast.Constant) and isinstance(mode.value, str)):
        return None
    m = mode.value
    return m if any(c in m for c in _WRITE_MODES) else None


def _scan_fn(fn: ast.AST, src: SourceFile, aliases: Dict[str, str]) -> _FnScan:
    scan = _FnScan()
    handle_names: Set[str] = set()  # with open(p, 'w') as fh -> fh

    def walk(node: ast.AST, guarded: bool) -> None:
        if isinstance(node, ast.Try):
            covers = any(_handler_covers_failure(h) for h in node.handlers)
            for st in node.body:
                walk(st, guarded or covers)
            for part in (node.handlers, node.orelse, node.finalbody):
                for st in part:
                    walk(st, guarded)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node is not fn:
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                ce = item.context_expr
                if (
                    isinstance(ce, ast.Call)
                    and resolve_dotted(ce.func, aliases) == "open"
                    and isinstance(item.optional_vars, ast.Name)
                ):
                    handle_names.add(item.optional_vars.id)
        if isinstance(node, ast.Assign):
            if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
                scan.assigns[node.targets[0].id] = node.value
            if isinstance(node.value, ast.Call):
                rd = resolve_dotted(node.value.func, aliases)
                if rd in _TEMPFILE_CTORS:
                    names: Set[str] = set()
                    for t in node.targets:
                        for sub in ast.walk(t):
                            if isinstance(sub, ast.Name):
                                names.add(sub.id)
                    has_dir = any(kw.arg == "dir" for kw in node.value.keywords)
                    scan.tempfiles.append((node.value, has_dir, names))
        if isinstance(node, ast.Call):
            rd = resolve_dotted(node.func, aliases)
            if rd == "open" and node.args:
                mode = _is_write_mode(node)
                if mode and "a" not in mode:  # appends tear a line, not a file
                    scan.writes.append(_WriteSite(node, node.args[0]))
            elif rd in ("numpy.save", "numpy.savez", "numpy.savez_compressed", "np.save"):
                if node.args and not (
                    isinstance(node.args[0], ast.Name)
                    and node.args[0].id in handle_names
                ):
                    scan.writes.append(_WriteSite(node, node.args[0]))
            elif rd is not None and _path_arg(rd) is not None:
                # torch.save(obj, path), save_msgpack(tree, path),
                # save_orbax(tree, path): the target is the second argument
                target = _path_arg(rd)
                pos = node.args[target] if len(node.args) > target else None
                for kw in node.keywords:
                    if kw.arg in ("f", "path", "directory"):
                        pos = kw.value
                if pos is not None and not (
                    isinstance(pos, ast.Name) and pos.id in handle_names
                ):
                    scan.writes.append(_WriteSite(node, pos))
            elif rd in ("os.rename", "os.replace"):
                scan.renames.append(
                    _RenameSite(
                        node,
                        node.args[0] if node.args else None,
                        node.args[1] if len(node.args) > 1 else None,
                        rd, guarded,
                    )
                )
            elif rd == "os.open":
                flags_text = " ".join(
                    t for a in node.args[1:] for t in _const_text(a)
                )
                if "O_EXCL" in flags_text:
                    scan.excl_opens.append((node, guarded))
            elif rd == "os.utime":
                scan.utime_lines.append(node.lineno)
        for child in ast.iter_child_nodes(node):
            walk(child, guarded)

    walk(fn, False)
    return scan


# the port's writers that take (payload, path): a raw write to the path
_PATH_SECOND_WRITERS = ("torch.save", "save_msgpack", "save_orbax")


def _path_arg(rd: str) -> Optional[int]:
    """Index of the target-path argument of a (payload, path) writer."""
    if rd == "torch.save" or rd.rsplit(".", 1)[-1] in _PATH_SECOND_WRITERS[1:]:
        return 1
    return None


def _resolved_text(expr: Optional[ast.AST], scan: _FnScan) -> str:
    """Path-expression text with one hop of local-assignment resolution:
    ``tmp = f"{path}.tmp"`` makes the text of ``tmp`` include ``path``'s
    constants and names."""
    parts = _const_text(expr)
    seen: Set[str] = set()
    frontier = [n for n in _names_of(expr)]
    for _ in range(3):  # bounded chain: tmp -> path -> self.attr
        nxt: List[str] = []
        for name in frontier:
            if name in seen:
                continue
            seen.add(name)
            sub = scan.assigns.get(name)
            if sub is not None:
                parts.extend(_const_text(sub))
                nxt.extend(_names_of(sub))
        frontier = nxt
    return "\x00".join(parts)


def _expr_names_resolved(expr: Optional[ast.AST], scan: _FnScan) -> Set[str]:
    names = set(_names_of(expr))
    for name in list(names):
        sub = scan.assigns.get(name)
        if sub is not None:
            names |= _names_of(sub)
    return names


def _is_durable(text: str) -> Optional[str]:
    for tok in _DURABLE_TOKENS:
        if tok in text:
            return tok
    return None


def _write_is_atomic(site: _WriteSite, scan: _FnScan) -> bool:
    wnames = _expr_names_resolved(site.path, scan)
    for rn in scan.renames:
        if wnames & _expr_names_resolved(rn.src_expr, scan):
            return True
    # fallback: the target is visibly a temp sibling and the function
    # publishes *something* — the pairing is by convention, not by name
    text = _resolved_text(site.path, scan).lower()
    return bool(scan.renames) and (".tmp" in text or ".part" in text)


def _fn_params(info: FunctionInfo) -> List[str]:
    a = info.node.args
    return [p.arg for p in a.posonlyargs + a.args]


def check(
    sources: Sequence[SourceFile], graph: CallGraph, project: ProjectTaint
) -> List[Finding]:
    findings: List[Finding] = []
    scans: Dict[str, _FnScan] = {}
    # helper summaries: fn key -> [(param name, positional index, write line)]
    raw_param_writes: Dict[str, List[Tuple[str, int, int]]] = {}
    # rel -> (first claiming function, its claim sites): heartbeat check
    # runs after every function is scanned, one finding per module
    module_claims: Dict[str, Tuple[FunctionInfo, List[_RenameSite]]] = {}

    for key in sorted(graph.functions):
        info = graph.functions[key]
        if info.src.rel.startswith("analysis/"):
            continue
        aliases = graph._aliases[info.src.rel]
        scan = _scan_fn(info.node, info.src, aliases)
        scans[key] = scan
        params = _fn_params(info)
        for site in scan.writes:
            if _write_is_atomic(site, scan):
                continue
            text = _resolved_text(site.path, scan)
            tok = _is_durable(text)
            if tok is not None:
                findings.append(
                    Finding(
                        info.src.path, site.node.lineno, site.node.col_offset,
                        RULES["GC601"],
                        f"durable path (mentions {tok!r}) written in place in "
                        f"{info.name!r} with no staged rename — a kill "
                        "mid-write leaves a torn file",
                        "write to a same-directory .tmp sibling and publish "
                        "with one os.replace — io/sink.py atomic_write_json "
                        "is the shared shape",
                        trace=[
                            f"{info.src.path}:{site.node.lineno}: raw write "
                            f"in {info.name}() with no os.replace pairing "
                            "its target",
                        ],
                    )
                )
                continue
            # a helper writing straight through a parameter path: judged
            # at the call sites that pass durable paths in
            pnames = _names_of(site.path) & set(params)
            for p in pnames:
                raw_param_writes.setdefault(key, []).append(
                    (p, params.index(p), site.node.lineno)
                )

        # -- GC602: claim sites must branch on losing ------------------------
        for call, guarded in scan.excl_opens:
            if not guarded:
                findings.append(
                    Finding(
                        info.src.path, call.lineno, call.col_offset,
                        RULES["GC602"],
                        f"O_EXCL claim in {info.name!r} has no failure "
                        "branch — losing the race raises FileExistsError "
                        "into the caller",
                        "wrap the claim in try/except FileExistsError (the "
                        "loser path) and except OSError (claim-side I/O "
                        "failure) — runtime/faults.py claim_skip_record is "
                        "the shape",
                    )
                )
        claim_sites: List[_RenameSite] = []
        for rn in scan.renames:
            dst_text = _resolved_text(rn.dst_expr, scan).lower()
            if any(t in dst_text for t in _CLAIM_TOKENS):
                claim_sites.append(rn)
                if not rn.guarded:
                    findings.append(
                        Finding(
                            info.src.path, rn.node.lineno,
                            rn.node.col_offset, RULES["GC602"],
                            f"rename-claim in {info.name!r} assumes victory "
                            "— the losing replica's rename raises OSError "
                            "uncaught",
                            "branch on the loser: try/except OSError around "
                            "the claim rename (serve/sources.py poll_once is "
                            "the shape)",
                        )
                    )
            elif rn.op == "os.rename" and not rn.guarded:
                # -- GC603: bare rename, neither publish nor claim shape ------
                findings.append(
                    Finding(
                        info.src.path, rn.node.lineno, rn.node.col_offset,
                        RULES["GC603"],
                        f"bare os.rename in {info.name!r}: a publish wants "
                        "os.replace (atomic overwrite everywhere), a claim "
                        "wants a try/except OSError loser branch",
                        "use os.replace for last-write-wins publication, or "
                        "guard the rename and treat OSError as losing the "
                        "claim race",
                    )
                )
        if claim_sites:
            module_claims.setdefault(info.src.rel, (info, claim_sites))

        # -- GC603: tempfile staging outside the destination dir -------------
        rename_src_names: Set[str] = set()
        for rn in scan.renames:
            rename_src_names |= _expr_names_resolved(rn.src_expr, scan)
        for call, has_dir, names in scan.tempfiles:
            if not has_dir and names & rename_src_names:
                findings.append(
                    Finding(
                        info.src.path, call.lineno, call.col_offset,
                        RULES["GC603"],
                        f"tempfile staged in the default tmpdir feeds a "
                        f"rename in {info.name!r} — across filesystems the "
                        "rename is not atomic (EXDEV)",
                        "create the temp file next to its destination: "
                        "tempfile.mkstemp(dir=os.path.dirname(dest)), or a "
                        "f'{dest}.…tmp' sibling",
                    )
                )

    for info, claim_sites in module_claims.values():
        _lease_heartbeat(info, claim_sites, graph, scans, findings)

    # -- GC601 interprocedural: durable paths handed to raw-writing helpers --
    for key in sorted(graph.functions):
        info = graph.functions[key]
        if info.src.rel.startswith("analysis/"):
            continue
        caller_scan = scans.get(key)
        if caller_scan is None:
            continue
        caller_rename_names: Set[str] = set()
        for rn in caller_scan.renames:
            caller_rename_names |= _expr_names_resolved(rn.src_expr, caller_scan)
        for node in _own_nodes(info.node):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            for ck in _exact_callees(node.func, info.src, info, graph):
                for pname, pidx, wline in raw_param_writes.get(ck, ()):
                    callee = graph.functions[ck]
                    # method calls drop the explicit self argument
                    argidx = pidx - (1 if _fn_params(callee)[:1] == ["self"] else 0)
                    if not 0 <= argidx < len(node.args):
                        continue
                    arg = node.args[argidx]
                    tok = _is_durable(_resolved_text(arg, caller_scan))
                    if tok is None:
                        continue
                    if _names_of(arg) & caller_rename_names:
                        continue  # the caller stages + renames it itself
                    findings.append(
                        Finding(
                            info.src.path, node.lineno, node.col_offset,
                            RULES["GC601"],
                            f"durable path (mentions {tok!r}) passed to "
                            f"{callee.name!r}, which writes it in place "
                            "with no staged rename",
                            "make the helper atomic (stage under .tmp, one "
                            "os.replace — io/sink.py atomic_write_json), or "
                            "stage in the caller",
                            trace=[
                                f"{info.src.path}:{node.lineno}: durable "
                                f"path built in {info.name}() flows into "
                                f"parameter {pname!r}",
                                f"{callee.src.path}:{wline}: raw write "
                                f"through {pname!r} in {callee.name}()",
                            ],
                        )
                    )
    return findings


def _lease_heartbeat(
    info: FunctionInfo,
    claim_sites: List[_RenameSite],
    graph: CallGraph,
    scans: Dict[str, _FnScan],
    findings: List[Finding],
) -> None:
    """A module acquiring claim/lease files by rename must refresh their
    mtime: ``os.utime`` somewhere in the module, reachable through exact
    callees from the module's poll loop when it has one."""
    src = info.src
    module_keys = [k for k, f in graph.functions.items() if f.src is src]
    utime_keys = {
        k for k in module_keys if scans.get(k) and scans[k].utime_lines
    }
    if utime_keys:
        poll_keys = [
            k for k in module_keys
            if "poll" in graph.functions[k].name or graph.functions[k].name == "run"
        ]
        if not poll_keys:
            return  # heartbeat exists; no poll loop in view to anchor on
        reachable: Set[str] = set(poll_keys)
        frontier = list(poll_keys)
        for _ in range(4):
            nxt: List[str] = []
            for k in frontier:
                fi = graph.functions[k]
                for node in _own_nodes(fi.node):
                    if isinstance(node, ast.Call):
                        for ck in _exact_callees(node.func, fi.src, fi, graph):
                            if ck not in reachable:
                                reachable.add(ck)
                                nxt.append(ck)
            frontier = nxt
        if utime_keys & reachable:
            return
        reason = (
            "an os.utime exists in the module but is not reachable from "
            "the poll loop — leases never refresh while polling"
        )
    else:
        reason = (
            "no os.utime anywhere in the module — held leases look stale "
            "to every peer and get stolen while this owner still works"
        )
    site = claim_sites[0]
    findings.append(
        Finding(
            src.path, site.node.lineno, site.node.col_offset, RULES["GC602"],
            f"claim/lease files acquired in {info.name!r} are never "
            f"heartbeat: {reason}",
            "pair acquisition with an os.utime refresh in the owner's poll "
            "pass (serve/sources.py _lease_pass is the shape)",
        )
    )
