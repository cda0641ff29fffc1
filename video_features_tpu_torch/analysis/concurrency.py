"""GC31x — concurrency soundness for the threaded serve/extract runtime.

Counterpart of ``video_features_tpu/analysis/concurrency.py``, copied;
GC312's device syncs are the port's GC10x facts (``.item()``,
``.synchronize()``, and ``.cpu()``/``.numpy()``/``.tolist()``/
``.to("cpu")``/``np.asarray``/``float()`` of a device tensor) in place
of ``jax.device_get`` and ``block_until_ready``.

GC301 proves each shared write sits under *a* lock; nothing proved the
locks COMPOSE. The serve daemon is now five lock domains deep (admission
condition, daemon registry, extractor pool, request tracker, breakers),
and the two failure modes GC301 cannot see are exactly the ones that
take a resident daemon down:

- **GC311 lock-order-cycle** — builds a lock-acquisition-order graph
  across the thread roots: an edge ``A -> B`` means some function
  acquires ``B`` (directly, or through a resolvable call chain) while
  holding ``A``. A cycle in that graph is a potential deadlock: two
  threads entering the cycle from different locks wait on each other
  forever. Lock identity is the module-level binding
  (``_lock = threading.Lock()``) or the instance attribute assigned a
  lock constructor in a class body (``self._lock = threading.Lock()``
  -> ``Cls._lock``; all instances share the ordering discipline even
  though each has its own lock object).
- **GC312 blocking-under-lock** — flags blocking calls reachable while
  a lock is held in the hot thread-root modules (serve/ and the
  extract pipeline): untimed ``.get()``/``.join()``/``.wait()``,
  ``time.sleep``, subprocess spawns/waits, file I/O (``open``,
  ``os.replace``...), socket accepts, and device syncs (the GC10x
  facts). A blocking call under a lock turns every
  reader of that lock into a queue behind the slow operation — the
  ``status()``-blocked-behind-a-compile class of bug. The sink/fetch
  boundary allowlist (``fetch_*``/``*sink*``) is shared with GC10x:
  those functions exist to block, and calls INTO them are not
  descended. ``cond.wait()`` while holding only that condition is the
  canonical consumer loop and is exempt (wait releases the lock);
  ``wait(timeout=...)`` is statically timed and always fine.
- **GC313 resource-lifecycle** — non-daemon ``threading.Thread``s in a
  module with no ``.join`` anywhere, ``subprocess.Popen`` neither used
  as a context manager nor reaped (wait/communicate/kill/terminate/
  poll) in its function, and ``f = open(...)`` handles that are never
  closed, returned, stored on ``self`` or entered as a context
  manager. Each is a leak the daemon pays for per request.

Resolution here is deliberately *exact-only* (module functions, import
aliases, ``self.method`` on the caller's own class, plus attribute
names defined exactly once in the project): GC311/GC312 prove the
ABSENCE of a defect with zero waivers, so a by-name fan-out that drags
every ``get`` in the tree into every lock region would bury the real
findings. The cost is under-approximation through dynamic dispatch —
documented, and bounded by keeping lock regions small (the fix GC312
pushes toward anyway).

Findings carry the acquisition/call provenance in ``trace``
(``--explain GC311`` / ``--explain GC312`` print it).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from video_features_tpu_torch.analysis.callgraph import CallGraph, FunctionInfo
from video_features_tpu_torch.analysis.core import (
    Finding,
    Rule,
    SourceFile,
    dotted_name,
    import_aliases,
    resolve_dotted,
)
from video_features_tpu_torch.analysis.hostsync import _allowlisted
from video_features_tpu_torch.analysis.taint import (
    _FETCH_METHODS,
    _FETCHERS,
    ProjectTaint,
    is_cpu_expr,
)
from video_features_tpu_torch.analysis.thread_safety import _LOCK_CALLS

RULES = {
    "GC311": Rule(
        "GC311", "lock-order-cycle",
        "locks are acquired in conflicting orders on concurrent paths — "
        "a potential deadlock",
    ),
    "GC312": Rule(
        "GC312", "blocking-under-lock",
        "a blocking call (untimed wait/join/get, file I/O, subprocess, "
        "device sync) runs while a lock is held on a hot threaded path",
    ),
    "GC313": Rule(
        "GC313", "resource-lifecycle",
        "a thread, subprocess, or file handle is created without a "
        "provable join/reap/close",
    ),
}

# one lock DISCIPLINE: (rel, class-or-None, binding name). Instance locks
# of the same class share an id — every instance must follow one order.
LockId = Tuple[str, Optional[str], str]

_REAP_METHODS = frozenset({"wait", "communicate", "kill", "terminate", "poll"})
_OS_BLOCKING = frozenset(
    {"os.replace", "os.rename", "os.makedirs", "os.remove", "os.unlink",
     "os.listdir", "os.stat", "os.scandir", "os.rmdir", "os.fsync"}
)
_SUBPROCESS_CALLS = frozenset(
    {"subprocess.run", "subprocess.call", "subprocess.check_call",
     "subprocess.check_output", "subprocess.Popen"}
)
_SOCKET_BLOCKING_ATTRS = frozenset({"accept", "recvfrom", "connect_ex"})
_THREAD_CTORS = ("threading.Thread", "Thread")


def _display(lid: LockId) -> str:
    rel, cls, name = lid
    return f"{cls}.{name}" if cls else f"{rel}::{name}"


def _lock_key(lid: LockId) -> Tuple[str, str, str]:
    # LockId's class slot is None for module locks: order with "" so
    # module and instance locks of one file sort deterministically
    rel, cls, name = lid
    return (rel, cls or "", name)


def _own_nodes(fn_node: ast.AST) -> Iterator[ast.AST]:
    """Every AST node of a function EXCLUDING nested defs (they run on
    their own schedule — a closure body executes at call time, not while
    the enclosing lock is held). Walked once per node: every pass of the
    sweep asks again."""
    cached = getattr(fn_node, "_graftcheck_own", None)
    if cached is None:
        cached = []
        stack: List[ast.AST] = [fn_node]
        while stack:
            node = stack.pop()
            cached.append(node)
            for child in ast.iter_child_nodes(node):
                if (
                    isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and child is not fn_node
                ):
                    continue
                stack.append(child)
        fn_node._graftcheck_own = cached
    return iter(cached)


class _Locks:
    """Lock identity across the sweep: module-level lock bindings plus
    ``self.<attr> = threading.Lock()``-style instance locks per class."""

    def __init__(self, sources: Sequence[SourceFile]) -> None:
        self.module_locks: Dict[str, Set[str]] = {}
        self.instance_locks: Dict[Tuple[str, str], Set[str]] = {}
        for src in sources:
            aliases = import_aliases(src.tree)
            names: Set[str] = set()
            for st in src.tree.body:
                if isinstance(st, ast.Assign) and isinstance(st.value, ast.Call):
                    if resolve_dotted(st.value.func, aliases) in _LOCK_CALLS:
                        names.update(
                            t.id for t in st.targets if isinstance(t, ast.Name)
                        )
            self.module_locks[src.rel] = names
            for cls in src.tree.body:
                if not isinstance(cls, ast.ClassDef):
                    continue
                attrs: Set[str] = set()
                for node in ast.walk(cls):
                    if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                        if resolve_dotted(node.value.func, aliases) in _LOCK_CALLS:
                            for t in node.targets:
                                if (
                                    isinstance(t, ast.Attribute)
                                    and isinstance(t.value, ast.Name)
                                    and t.value.id == "self"
                                ):
                                    attrs.add(t.attr)
                if attrs:
                    self.instance_locks[(src.rel, cls.name)] = attrs

    def classify(
        self, expr: ast.AST, src: SourceFile, info: Optional[FunctionInfo]
    ) -> Optional[LockId]:
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id in ("self", "cls")
            and info is not None
            and info.cls is not None
        ):
            if expr.attr in self.instance_locks.get((src.rel, info.cls), ()):
                return (src.rel, info.cls, expr.attr)
            return None
        dn = dotted_name(expr)
        if dn is not None:
            last = dn.split(".")[-1]
            if last in self.module_locks.get(src.rel, ()):
                return (src.rel, None, last)
        return None


def _exact_callees(
    func: ast.AST, src: SourceFile, info: Optional[FunctionInfo], graph: CallGraph
) -> List[str]:
    """Exact-only callee resolution (taint.py semantics) plus one cheap
    extension: an attribute name defined exactly ONCE in the project is
    unambiguous even through a variable receiver (``b.snapshot()``)."""
    if isinstance(func, ast.Name):
        keys, _ = graph.resolve_call(func, src, info)
        return keys
    if isinstance(func, ast.Attribute):
        aliases = graph._aliases[src.rel]
        rd = resolve_dotted(func.value, aliases)
        if rd is not None:
            m = graph.resolve_module(rd)
            if m is not None:
                hit = graph.module_function(m, func.attr)
                if hit:
                    return [hit]
        if (
            isinstance(func.value, ast.Name)
            and func.value.id in ("self", "cls")
            and info is not None
            and info.cls is not None
        ):
            own = graph.methods_of.get((src.rel, info.cls, func.attr))
            if own:
                return [own]
        hits = graph.by_name.get(func.attr, ())
        if len(hits) == 1:
            return list(hits)
        return []
    if isinstance(func, ast.Call):
        aliases = graph._aliases[src.rel]
        rd = resolve_dotted(func.func, aliases)
        if rd in ("functools.partial", "partial") and func.args:
            return _exact_callees(func.args[0], src, info, graph)
    return []


def _scope_allowlisted(graph: CallGraph, info: FunctionInfo) -> bool:
    cur: Optional[FunctionInfo] = info
    while cur is not None:
        if _allowlisted(cur.name):
            return True
        cur = graph.functions.get(cur.parent) if cur.parent else None
    return False


def _walk_held(info: FunctionInfo, locks: _Locks, visit_call, visit_with=None):
    """Walk a function body tracking the lexically-held lock stack:
    ``visit_with(lock_id, with_node, held)`` fires at each classified
    acquisition, ``visit_call(call_node, held)`` at every call site.
    Nested defs are skipped (their bodies run at call time)."""
    src = info.src

    def walk(node: ast.AST, held: List[Tuple[LockId, int]]) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = list(held)
            for item in node.items:
                # context expressions evaluate BEFORE the acquisition
                for sub in ast.walk(item.context_expr):
                    if isinstance(sub, ast.Call):
                        visit_call(sub, tuple(inner))
                lid = locks.classify(item.context_expr, src, info)
                if lid is not None:
                    if visit_with is not None:
                        visit_with(lid, node, tuple(inner))
                    inner.append((lid, node.lineno))
            for st in node.body:
                walk(st, inner)
            return
        if (
            isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and node is not info.node
        ):
            return
        if isinstance(node, ast.Call):
            visit_call(node, tuple(held))
        for child in ast.iter_child_nodes(node):
            walk(child, held)

    walk(info.node, [])


# --- GC311: lock-acquisition-order graph -------------------------------------


class _AcquireClosure:
    """lock ids a function acquires, directly or through exact callees,
    each with a first-witness provenance chain."""

    def __init__(self, graph: CallGraph, locks: _Locks) -> None:
        self.graph = graph
        self.locks = locks
        self.memo: Dict[str, Dict[LockId, Tuple[str, ...]]] = {}

    def of(self, key: str, depth: int = 0) -> Dict[LockId, Tuple[str, ...]]:
        if key in self.memo:
            return self.memo[key]
        self.memo[key] = {}  # cut recursion
        out: Dict[LockId, Tuple[str, ...]] = {}
        info = self.graph.functions.get(key)
        if info is None or depth > 4:
            return out
        src = info.src
        for node in _own_nodes(info.node):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    lid = self.locks.classify(item.context_expr, src, info)
                    if lid is not None and lid not in out:
                        out[lid] = (
                            f"{src.path}:{node.lineno}: {_display(lid)} "
                            f"acquired in {info.name}()",
                        )
            elif isinstance(node, ast.Call):
                for ck in _exact_callees(node.func, src, info, self.graph):
                    for lid, chain in self.of(ck, depth + 1).items():
                        if lid not in out:
                            out[lid] = (
                                f"{src.path}:{node.lineno}: "
                                f"{info.name}() calls the step below",
                            ) + chain
        self.memo[key] = out
        return out


def _check_lock_order(
    sources: Sequence[SourceFile], graph: CallGraph, locks: _Locks
) -> List[Finding]:
    closure = _AcquireClosure(graph, locks)
    # (A, B) -> (path, line, witness trace): B acquired while A held
    edges: Dict[Tuple[LockId, LockId], Tuple[str, int, List[str]]] = {}

    for key in sorted(graph.functions):
        info = graph.functions[key]
        if not info.src.is_thread_root:
            continue
        src = info.src

        def visit_with(lid, node, held, info=info, src=src):
            for a, aline in held:
                if a != lid and (a, lid) not in edges:
                    edges[(a, lid)] = (
                        src.path, node.lineno,
                        [
                            f"{src.path}:{aline}: {_display(a)} acquired "
                            f"in {info.name}()",
                            f"{src.path}:{node.lineno}: {_display(lid)} "
                            "acquired while holding it",
                        ],
                    )

        def visit_call(call, held, info=info, src=src):
            if not held:
                return
            for ck in _exact_callees(call.func, src, info, graph):
                for lid, chain in closure.of(ck).items():
                    for a, aline in held:
                        if a != lid and (a, lid) not in edges:
                            edges[(a, lid)] = (
                                src.path, call.lineno,
                                [
                                    f"{src.path}:{aline}: {_display(a)} "
                                    f"acquired in {info.name}()",
                                    f"{src.path}:{call.lineno}: this call "
                                    f"reaches a {_display(lid)} acquisition",
                                    *chain,
                                ],
                            )

        _walk_held(info, locks, visit_call, visit_with)

    findings: List[Finding] = []
    for comp in _cyclic_components(edges):
        in_cycle = sorted(
            (e for e in edges if e[0] in comp and e[1] in comp),
            key=lambda e: (edges[e][0], edges[e][1]),
        )
        if not in_cycle:
            continue
        path, line, _ = edges[in_cycle[0]]
        order = " -> ".join(_display(l) for l in sorted(comp, key=_lock_key)) or "?"
        trace: List[str] = []
        for e in in_cycle:
            trace.extend(edges[e][2])
        findings.append(
            Finding(
                path, line, 0, RULES["GC311"],
                f"lock-order cycle between {order}: these locks are "
                "acquired in conflicting orders on thread-reachable paths",
                "pick ONE global acquisition order for the locks involved "
                "(document it where they are declared) and restructure the "
                "offending path — usually by copying state under the first "
                "lock and calling out after releasing it",
                trace=trace,
            )
        )
    return findings


def _cyclic_components(edges) -> List[Set[LockId]]:
    """Tarjan SCCs of the lock-order graph with more than one node (a
    self-edge cannot occur: same-lock re-acquisition is never recorded)."""
    adj: Dict[LockId, List[LockId]] = {}
    nodes: Set[LockId] = set()
    for a, b in edges:
        adj.setdefault(a, []).append(b)
        nodes.add(a)
        nodes.add(b)
    index: Dict[LockId, int] = {}
    low: Dict[LockId, int] = {}
    stack: List[LockId] = []
    on: Set[LockId] = set()
    out: List[Set[LockId]] = []
    counter = [0]

    def strong(v: LockId) -> None:
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        for w in adj.get(v, ()):
            if w not in index:
                strong(w)
                low[v] = min(low[v], low[w])
            elif w in on:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            comp: Set[LockId] = set()
            while True:
                w = stack.pop()
                on.discard(w)
                comp.add(w)
                if w == v:
                    break
            if len(comp) > 1:
                out.append(comp)

    for v in sorted(nodes, key=_lock_key):
        if v not in index:
            strong(v)
    return out


# --- GC312: blocking calls while a lock is held ------------------------------


def _blocking_reason(
    call: ast.Call,
    src: SourceFile,
    info: Optional[FunctionInfo],
    locks: _Locks,
    held_ids: Optional[Sequence[LockId]],
    project: ProjectTaint,
    env,
) -> Optional[str]:
    """Why this call blocks, or None. ``held_ids`` is the lexically-held
    lock set at the site (None inside a callee summary, where only the
    callee's OWN condition-wait idiom is exempt)."""
    func = call.func
    aliases = project._aliases.get(src.rel) or import_aliases(src.tree)
    kwnames = {kw.arg for kw in call.keywords if kw.arg}
    if isinstance(func, ast.Attribute):
        if func.attr == "get" and not call.args and not (kwnames & {"timeout", "block"}):
            return "untimed .get()"
        if func.attr == "join" and not call.args and "timeout" not in kwnames:
            return "untimed .join()"
        if func.attr == "wait" and not call.args and "timeout" not in kwnames:
            recv = locks.classify(func.value, src, info)
            if recv is not None:
                if held_ids is None:
                    # callee context: waiting on its own condition is the
                    # canonical consumer loop (wait releases the lock)
                    return None
                if recv in held_ids and len(set(held_ids)) == 1:
                    return None
            return "untimed .wait()"
        if func.attr == "communicate":
            return "subprocess .communicate()"
        if func.attr == "synchronize" and not call.args:
            return "device sync (.synchronize())"
        if func.attr == "item" and not call.args:
            return "device sync (.item())"
        if (func.attr in _FETCH_METHODS and not call.args) or (
            func.attr == "to"
            and any(
                is_cpu_expr(a, aliases)
                for a in list(call.args[:1])
                + [kw.value for kw in call.keywords if kw.arg == "device"]
            )
        ):
            t = project.expr_taint(func.value, env, src, info)
            if t.device:
                return f"device sync (.{func.attr}() of a device tensor)"
        if func.attr in _SOCKET_BLOCKING_ATTRS and not call.args:
            return f"socket .{func.attr}()"
    rd = resolve_dotted(func, aliases)
    if rd is None:
        return None
    if rd == "time.sleep":
        return "time.sleep()"
    if rd == "open":
        return "file I/O (open())"
    if rd in _OS_BLOCKING:
        return f"file I/O ({rd}())"
    if rd.split(".")[0] == "shutil":
        return f"file I/O ({rd}())"
    if rd in _SUBPROCESS_CALLS:
        return f"{rd}() spawn/wait"
    if rd in ("float", "int", "bool") and call.args:
        t = project.expr_taint(call.args[0], env, src, info)
        if t.device:
            return f"device sync ({rd}() of a device tensor)"
    if rd in _FETCHERS and call.args:
        t = project.expr_taint(call.args[0], env, src, info)
        if t.device:
            return f"device sync ({rd} on a device value)"
    return None


class _BlockingSites:
    """Blocking sites reachable inside a function (through exact callees,
    bounded depth), each with a provenance chain to the site."""

    def __init__(self, graph: CallGraph, locks: _Locks, project: ProjectTaint) -> None:
        self.graph = graph
        self.locks = locks
        self.project = project
        self.memo: Dict[str, List[Tuple[str, Tuple[str, ...]]]] = {}

    def of(self, key: str, depth: int = 0) -> List[Tuple[str, Tuple[str, ...]]]:
        if key in self.memo:
            return self.memo[key]
        self.memo[key] = []  # cut recursion
        info = self.graph.functions.get(key)
        if info is None or depth > 3:
            return []
        src = info.src
        env = self.project.env_for(key)
        out: List[Tuple[str, Tuple[str, ...]]] = []
        for node in _own_nodes(info.node):
            if not isinstance(node, ast.Call):
                continue
            reason = _blocking_reason(
                node, src, info, self.locks, None, self.project, env
            )
            if reason is not None:
                out.append(
                    (reason,
                     (f"{src.path}:{node.lineno}: {reason} in {info.name}()",))
                )
                continue
            for ck in _exact_callees(node.func, src, info, self.graph):
                callee = self.graph.functions.get(ck)
                if callee is None or _scope_allowlisted(self.graph, callee):
                    continue
                for r, chain in self.of(ck, depth + 1):
                    out.append(
                        (r,
                         (f"{src.path}:{node.lineno}: {info.name}() calls "
                          "the step below",) + chain)
                    )
        self.memo[key] = out[:8]  # bound noise per callee
        return self.memo[key]


def _check_blocking(
    sources: Sequence[SourceFile],
    graph: CallGraph,
    locks: _Locks,
    project: ProjectTaint,
) -> List[Finding]:
    findings: List[Finding] = []
    summaries = _BlockingSites(graph, locks, project)
    flagged: Set[Tuple[str, int, str]] = set()

    for key in sorted(graph.functions):
        info = graph.functions[key]
        src = info.src
        if not (src.is_hot and src.is_thread_root):
            continue
        if _scope_allowlisted(graph, info):
            continue
        env = project.env_for(key)

        def visit_call(call, held, info=info, src=src, env=env):
            if not held:
                return
            held_ids = [h[0] for h in held]
            lock, lock_line = held[-1]
            reason = _blocking_reason(
                call, src, info, locks, held_ids, project, env
            )
            if reason is not None:
                sig = (src.path, call.lineno, reason)
                if sig not in flagged:
                    flagged.add(sig)
                    findings.append(
                        Finding(
                            src.path, call.lineno, call.col_offset,
                            RULES["GC312"],
                            f"{reason} while {_display(lock)} is held in "
                            f"{info.name!r}",
                            "move the blocking work outside the lock (copy "
                            "state under the lock, act after releasing it), "
                            "or give the wait a timeout",
                            trace=[
                                f"{src.path}:{lock_line}: {_display(lock)} "
                                "acquired here",
                                f"{src.path}:{call.lineno}: {reason} while "
                                "the lock is held",
                            ],
                        )
                    )
                return
            for ck in _exact_callees(call.func, src, info, graph):
                callee = graph.functions.get(ck)
                if callee is None or _scope_allowlisted(graph, callee):
                    continue
                for r, chain in summaries.of(ck):
                    sig = (src.path, call.lineno, r)
                    if sig in flagged:
                        continue
                    flagged.add(sig)
                    findings.append(
                        Finding(
                            src.path, call.lineno, call.col_offset,
                            RULES["GC312"],
                            f"{r} reachable while {_display(lock)} is held "
                            f"in {info.name!r}",
                            "move the blocking call out of the lock region, "
                            "or restructure the callee so its blocking work "
                            "happens before/after the locked section",
                            trace=[
                                f"{src.path}:{lock_line}: {_display(lock)} "
                                "acquired here",
                                f"{src.path}:{call.lineno}: "
                                f"{callee.name}() called under the lock",
                                *chain,
                            ],
                        )
                    )

        _walk_held(info, locks, visit_call)
    return findings


# --- GC313: resource lifecycle -----------------------------------------------


def _check_lifecycle(
    sources: Sequence[SourceFile], graph: CallGraph
) -> List[Finding]:
    findings: List[Finding] = []
    for src in sources:
        if not src.is_thread_root:
            continue
        aliases = import_aliases(src.tree)
        findings.extend(_thread_lifecycle(src, aliases))
        for node in ast.walk(src.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                findings.extend(_handle_lifecycle(node, src, aliases))
    return findings


def _is_thread_ctor(call: ast.Call, aliases) -> bool:
    rd = resolve_dotted(call.func, aliases)
    return rd in _THREAD_CTORS or (rd or "").endswith("threading.Thread")


def _module_has_join(tree: ast.AST) -> bool:
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "join"
            and len(node.args) <= 1
            and not (resolve_dotted(node.func.value, {}) or "").startswith("os")
        ):
            return True
    return False


def _thread_lifecycle(src: SourceFile, aliases) -> List[Finding]:
    out: List[Finding] = []
    if _module_has_join(src.tree):
        return out
    for node in ast.walk(src.tree):
        if not (isinstance(node, ast.Call) and _is_thread_ctor(node, aliases)):
            continue
        daemon = any(
            kw.arg == "daemon"
            and isinstance(kw.value, ast.Constant)
            and kw.value.value is True
            for kw in node.keywords
        )
        if daemon:
            continue
        out.append(
            Finding(
                src.path, node.lineno, node.col_offset, RULES["GC313"],
                "non-daemon Thread created in a module with no .join() — "
                "shutdown will leave it running",
                "join the thread on the shutdown path, or mark it "
                "daemon=True if abandoning it at exit is the design",
            )
        )
    return out


def _handle_lifecycle(
    fn: ast.FunctionDef, src: SourceFile, aliases
) -> List[Finding]:
    """Popen handles never reaped and open() handles never closed within
    the creating function (conservative: a close/reap/with/return/self-
    store anywhere in the function counts as evidence)."""
    out: List[Finding] = []
    ctx_calls: Set[int] = set()
    method_calls: Dict[str, Set[str]] = {}  # receiver name -> attrs called
    with_names: Set[str] = set()
    returned: Set[str] = set()
    for node in _own_nodes(fn):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if isinstance(item.context_expr, ast.Call):
                    ctx_calls.add(id(item.context_expr))
                if isinstance(item.context_expr, ast.Name):
                    with_names.add(item.context_expr.id)
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if isinstance(node.func.value, ast.Name):
                method_calls.setdefault(node.func.value.id, set()).add(
                    node.func.attr
                )
        elif isinstance(node, ast.Return) and node.value is not None:
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Name):
                    returned.add(sub.id)

    for node in _own_nodes(fn):
        if not isinstance(node, ast.Assign) or not isinstance(node.value, ast.Call):
            continue
        call = node.value
        if id(call) in ctx_calls:
            continue
        rd = resolve_dotted(call.func, aliases)
        kind = None
        if rd == "subprocess.Popen":
            kind = ("subprocess.Popen handle", _REAP_METHODS,
                    "reap it (wait/communicate) in a finally, or use "
                    "`with subprocess.Popen(...) as p:`")
        elif rd == "open":
            kind = ("open() file handle", {"close"},
                    "close it on all paths: `with open(...) as f:` or a "
                    "try/finally close")
        if kind is None:
            continue
        what, evidence, hint = kind
        escapes = False
        targets: List[str] = []
        for t in node.targets:
            if isinstance(t, ast.Attribute):
                escapes = True  # stored on self/obj: lifetime escapes fn
            elif isinstance(t, ast.Name):
                targets.append(t.id)
        if escapes:
            continue
        ok = any(
            n in returned
            or n in with_names
            or (method_calls.get(n, set()) & evidence)
            for n in targets
        )
        if targets and not ok:
            out.append(
                Finding(
                    src.path, node.lineno, node.col_offset, RULES["GC313"],
                    f"{what} {targets[0]!r} in {fn.name!r} is neither "
                    "closed/reaped, returned, nor a context manager",
                    hint,
                )
            )
    return out


# --- entry -------------------------------------------------------------------


def check(
    sources: Sequence[SourceFile], graph: CallGraph, project: ProjectTaint
) -> List[Finding]:
    locks = _Locks(sources)
    findings: List[Finding] = []
    findings.extend(_check_lock_order(sources, graph, locks))
    findings.extend(_check_blocking(sources, graph, locks, project))
    findings.extend(_check_lifecycle(sources, graph))
    return findings
