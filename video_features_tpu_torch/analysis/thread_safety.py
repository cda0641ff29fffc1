"""GC301 — thread-safety lint for module-level mutable state.

The runtime is threads all the way down (one host thread per device,
``--decode_workers`` prepare pools, native preprocess threads), so any
module-level mutable binding written from a function is a data race
UNLESS the write is provably serialized. v1 accepted exactly one proof —
a lexical ``with <module lock>:`` around the write — and everything else
needed a ``# graftcheck: unlocked`` waiver. v2 resolves three more
shapes through the project call graph (``callgraph.py``):

- **decorator locks**: ``@synchronized`` where the decorator resolves to
  a project def whose body takes a module lock around the wrapped call;
- **contextmanager helpers**: ``with locked():`` where ``locked`` is a
  ``@contextlib.contextmanager`` def whose body holds a lock across its
  ``yield``;
- **guarded callers**: every resolved call site of the writing function
  sits inside a ``with <lock>`` in its caller (the classic private
  ``_unlocked_append`` helper);
- **thread reachability**: a function NOT reachable from any thread
  entry (``Thread(target=...)``, ``pool.submit``, timers) never races —
  config-set-once setters called only from ``__init__`` before workers
  exist are exempt by *analysis*, not by waiver. Files carrying the
  ``# graftcheck: thread-root`` marker but no visible spawn site treat
  every def as an entry (the fixture contract).

Findings carry the entry-to-write reachability chain in ``trace``
(``--explain GC301`` prints it).

Scope: modules *reachable from the thread roots* (import graph, both
directions — see core.THREAD_ROOT_PATTERNS). Import-time writes (module
body statements) are exempt: the import lock serializes them.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from video_features_tpu_torch.analysis.callgraph import CallGraph, FunctionInfo
from video_features_tpu_torch.analysis.core import (
    Finding,
    Rule,
    SourceFile,
    dotted_name,
    import_aliases,
    resolve_dotted,
)

RULE = Rule(
    "GC301", "unlocked-global",
    "module-level mutable state written without a lock on a thread-reachable path",
)

_LOCK_CALLS = frozenset(
    {"threading.Lock", "threading.RLock", "threading.Condition",
     "threading.Semaphore", "threading.BoundedSemaphore",
     "multiprocessing.Lock", "multiprocessing.RLock"}
)
_LOCAL_CALLS = frozenset({"threading.local"})
_MUTABLE_CALLS = frozenset(
    {"list", "dict", "set", "collections.defaultdict", "defaultdict",
     "collections.deque", "deque", "collections.Counter", "Counter",
     "collections.OrderedDict", "OrderedDict", "bytearray"}
)
_MUTATING_METHODS = frozenset(
    {"append", "extend", "insert", "update", "add", "setdefault", "pop",
     "popitem", "clear", "remove", "discard"}
)
_CONTEXTMANAGER = ("contextlib.contextmanager", "contextmanager")


class _ModuleInfo:
    def __init__(self, src: SourceFile) -> None:
        self.src = src
        self.aliases = import_aliases(src.tree)
        self.imports = self._imported_modules()
        self.locks, self.locals_, self.mutables = self._module_bindings()

    def _imported_modules(self) -> Set[str]:
        mods: Set[str] = set()
        for node in ast.walk(self.src.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    mods.add(a.name)
            elif isinstance(node, ast.ImportFrom):
                if node.module:
                    mods.add(node.module)
                    for a in node.names:
                        # "from pkg.io import sink" imports module pkg.io.sink
                        mods.add(f"{node.module}.{a.name}")
        return mods

    def _module_bindings(self) -> Tuple[Set[str], Set[str], Set[str]]:
        locks: Set[str] = set()
        locals_: Set[str] = set()
        mutables: Set[str] = set()
        for st in self.src.tree.body:
            targets: List[ast.AST] = []
            value: Optional[ast.AST] = None
            if isinstance(st, ast.Assign):
                targets, value = st.targets, st.value
            elif isinstance(st, ast.AnnAssign) and st.value is not None:
                targets, value = [st.target], st.value
            else:
                continue
            names = [t.id for t in targets if isinstance(t, ast.Name)]
            if not names or value is None:
                continue
            if isinstance(value, ast.Call):
                callee = resolve_dotted(value.func, self.aliases)
                if callee in _LOCK_CALLS:
                    locks.update(names)
                    continue
                if callee in _LOCAL_CALLS:
                    locals_.update(names)
                    continue
                if callee in _MUTABLE_CALLS:
                    mutables.update(names)
                    continue
            if isinstance(
                value,
                (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp, ast.SetComp),
            ):
                mutables.update(names)
        return locks, locals_, mutables


def _module_candidates(info: _ModuleInfo) -> Set[str]:
    """Dotted-name suffixes this module answers to, so imports match
    whether written package-absolute or tested from a fixture dir."""
    name = info.src.module_name
    out = {name}
    parts = name.split(".")
    for i in range(1, len(parts)):
        out.add(".".join(parts[i:]))
    if parts[-1] == "__init__":
        pkg = ".".join(parts[:-1])
        if pkg:
            out.add(pkg)
            pp = pkg.split(".")
            for i in range(1, len(pp)):
                out.add(".".join(pp[i:]))
    return out


class _LockResolver:
    """Answers "does this ``with``/decorator/caller hold a lock?" through
    the call graph: lexical locks, @contextmanager lock helpers, lock
    decorators, and per-call-site lock context for guarded callers."""

    def __init__(self, infos: Sequence[_ModuleInfo], graph: CallGraph) -> None:
        self.graph = graph
        self.by_src = {info.src.rel: info for info in infos}
        self._cm_cache: Dict[str, bool] = {}
        self._dec_cache: Dict[str, bool] = {}
        self._guarded_sites: Dict[str, Set[int]] = {}

    # -- lock-expression classification --------------------------------------

    def is_lock_expr(self, expr: ast.AST, src: SourceFile,
                     caller: Optional[FunctionInfo]) -> bool:
        info = self.by_src.get(src.rel)
        lock_names = info.locks if info else set()
        dn = dotted_name(expr)
        if dn is not None:
            head = dn.split(".")[0]
            # Name('_lock'), or conservative: any dotted chain ending in a
            # module-level lock name (cls._lock) or containing 'lock'
            if (
                head in lock_names
                or dn.split(".")[-1] in lock_names
                or "lock" in dn.split(".")[-1].lower()
            ):
                return True
        if isinstance(expr, ast.Call):
            # ``with locked():`` — a @contextmanager helper that holds a
            # module lock across its yield counts as taking that lock
            callees, _ = self.graph.resolve_call(expr.func, src, caller)
            return any(self._cm_lock_helper(k) for k in callees)
        return False

    def _cm_lock_helper(self, key: str) -> bool:
        if key in self._cm_cache:
            return self._cm_cache[key]
        self._cm_cache[key] = False  # cut recursion
        fn = self.graph.functions.get(key)
        ok = False
        if fn is not None and self._is_contextmanager(fn):
            ok = self._contains_lock_with(fn)
        self._cm_cache[key] = ok
        return ok

    def _is_contextmanager(self, fn: FunctionInfo) -> bool:
        aliases = self.by_src.get(fn.src.rel)
        aliases = aliases.aliases if aliases else {}
        for dec in fn.node.decorator_list:
            if resolve_dotted(dec, aliases) in _CONTEXTMANAGER:
                return True
        return False

    def _contains_lock_with(self, fn: FunctionInfo) -> bool:
        for node in ast.walk(fn.node):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                if any(
                    self.is_lock_expr(item.context_expr, fn.src, fn)
                    for item in node.items
                ):
                    return True
        return False

    # -- decorator locks -----------------------------------------------------

    def decorator_locked(self, fn_node: ast.FunctionDef,
                         src: SourceFile) -> bool:
        """A decorator that resolves to a project def whose body takes a
        lock (the @synchronized wrapper pattern) serializes every call."""
        for dec in fn_node.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            callees, _ = self.graph.resolve_call(target, src, None)
            for k in callees:
                if self._decorator_lock(k):
                    return True
        return False

    def _decorator_lock(self, key: str) -> bool:
        if key in self._dec_cache:
            return self._dec_cache[key]
        self._dec_cache[key] = False
        fn = self.graph.functions.get(key)
        ok = fn is not None and self._contains_lock_with(fn)
        self._dec_cache[key] = ok
        return ok

    # -- guarded callers -----------------------------------------------------

    def _locked_call_ids(self, caller_key: str) -> Set[int]:
        """ids of Call nodes lexically under a lock inside ``caller``."""
        if caller_key in self._guarded_sites:
            return self._guarded_sites[caller_key]
        out: Set[int] = set()
        fn = self.graph.functions.get(caller_key)
        if fn is not None:
            def walk(node: ast.AST, locked: bool) -> None:
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    locked = locked or any(
                        self.is_lock_expr(item.context_expr, fn.src, fn)
                        for item in node.items
                    )
                if locked and isinstance(node, ast.Call):
                    out.add(id(node))
                for child in ast.iter_child_nodes(node):
                    if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        continue
                    walk(child, locked)

            walk(fn.node, self.decorator_locked(fn.node, fn.src))
        self._guarded_sites[caller_key] = out
        return out

    def all_callers_locked(self, key: str) -> bool:
        """True when the function is only ever entered with a lock held:
        every resolved call site sits under a ``with <lock>`` in its
        caller (module-body call sites are import-time, serialized by the
        import lock). Spawn targets and ``__call__`` (reachable through
        unresolvable bare calls) never qualify."""
        fn = self.graph.functions.get(key)
        if fn is None:
            return False
        if key in self.graph.thread_entries():
            return False
        if fn.name == "__call__" and self.graph.unresolved_callers:
            return False
        sites = self.graph.callers.get(key, [])
        if not sites:
            return False
        for site in sites:
            if site.caller.endswith("::"):
                continue  # module body: import lock serializes
            if id(site.node) not in self._locked_call_ids(site.caller):
                return False
        return True


def check(sources: Sequence[SourceFile], graph: CallGraph) -> List[Finding]:
    infos = [_ModuleInfo(s) for s in sources]
    by_suffix: Dict[str, _ModuleInfo] = {}
    for info in infos:
        for cand in _module_candidates(info):
            by_suffix.setdefault(cand, info)

    def resolve_import(mod: str) -> Optional[_ModuleInfo]:
        # longest-suffix match: "video_features_tpu.io.sink" and "io.sink"
        # both land on io/sink.py
        parts = mod.split(".")
        for i in range(len(parts)):
            hit = by_suffix.get(".".join(parts[i:]))
            if hit is not None:
                return hit
        return None

    # edges in both directions of interest
    imports_of: Dict[int, Set[int]] = {}
    for idx, info in enumerate(infos):
        tgt: Set[int] = set()
        for mod in info.imports:
            hit = resolve_import(mod)
            if hit is not None and hit is not info:
                tgt.add(infos.index(hit))
        imports_of[idx] = tgt

    roots = {i for i, info in enumerate(infos) if info.src.is_thread_root}
    # (1) everything the roots call into
    reachable = set(roots)
    frontier = set(roots)
    while frontier:
        nxt = set()
        for i in frontier:
            nxt |= imports_of[i] - reachable
        reachable |= nxt
        frontier = nxt
    # (2) modules that run on the threads by importing a root (extractor
    # subclasses etc.), closed over THEIR imports too
    importers = {
        i for i in range(len(infos)) if imports_of[i] & roots
    }
    frontier = importers - reachable
    reachable |= importers
    while frontier:
        nxt = set()
        for i in frontier:
            nxt |= imports_of[i] - reachable
        reachable |= nxt
        frontier = nxt

    resolver = _LockResolver(infos, graph)
    thread_side = graph.thread_side()
    findings: List[Finding] = []
    for i in sorted(reachable):
        findings.extend(_check_module(infos[i], graph, resolver, thread_side))
    return findings


def _chain_trace(
    graph: CallGraph, chain: Tuple[str, ...]
) -> List[str]:
    out = []
    for j, key in enumerate(chain):
        fn = graph.functions.get(key)
        if fn is None:
            continue
        what = "thread entry" if j == 0 else "called from the step above"
        out.append(f"{fn.src.path}:{fn.node.lineno}: {fn.name}() — {what}")
    return out


def _check_module(
    info: _ModuleInfo,
    graph: CallGraph,
    resolver: _LockResolver,
    thread_side: Dict[str, Tuple[str, ...]],
) -> List[Finding]:
    src = info.src
    findings: List[Finding] = []
    module_names = info.mutables | {
        n
        for fn in _functions(src.tree)
        for n in _global_decls(fn)
    }
    if not module_names and not info.mutables:
        return findings

    for fn in _functions(src.tree):
        globals_here = _global_decls(fn)
        watched = (info.mutables | globals_here) - info.locals_
        if not watched:
            continue
        key = graph.key_of(fn)
        fn_info = graph.functions.get(key) if key else None
        chain = thread_side.get(key) if key else None
        if key is not None and chain is None:
            # interprocedural exemption #1: not reachable from any thread
            # entry — an init-only / config-set-once path cannot race
            continue
        if resolver.decorator_locked(fn, src):
            # interprocedural exemption #2: a lock-wrapping decorator
            # serializes every call of this function
            continue
        callers_locked: Optional[bool] = None  # lazy: costs graph walks
        for write_line, write_col, name, how, guarded in _writes(
            fn, watched, globals_here, info, resolver, fn_info
        ):
            if guarded:
                continue
            if callers_locked is None:
                # interprocedural exemption #3: every resolved call site
                # of this function already holds a lock
                callers_locked = (
                    resolver.all_callers_locked(key) if key else False
                )
            if callers_locked:
                break
            findings.append(
                Finding(
                    src.path, write_line, write_col, RULE,
                    f"{how} of module-level {name!r} in {fn.name!r} without "
                    f"holding a module lock",
                    "guard with `with <module lock>:` (directly, via a "
                    "@contextmanager helper, a lock decorator, or in every "
                    "caller), make it threading.local(), or waive with "
                    "`# graftcheck: unlocked — <why it is safe>`",
                    trace=_chain_trace(graph, chain) if chain else [],
                )
            )
    return findings


def _functions(tree: ast.AST) -> List[ast.FunctionDef]:
    return [
        n
        for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]


def _global_decls(fn: ast.FunctionDef) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Global):
            out.update(node.names)
    return out


def _writes(
    fn,
    watched: Set[str],
    globals_here: Set[str],
    info: _ModuleInfo,
    resolver: _LockResolver,
    fn_info: Optional[FunctionInfo],
):
    """(line, col, name, kind, guarded) for every write to a watched
    module-level name in ``fn``. Guarded = lexically inside a ``with``
    over a module-level lock or a @contextmanager lock helper."""
    src = info.src

    def walk(node: ast.AST, under_lock: bool):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            locked = under_lock or any(
                resolver.is_lock_expr(item.context_expr, src, fn_info)
                for item in node.items
            )
            for st in node.body:
                yield from walk(st, locked)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node is not fn:
            # nested defs: visited by _functions in their own right; their
            # lock context comes from their call sites (guarded callers)
            return
        if isinstance(node, ast.Assign):
            for t in node.targets:
                yield from _target_writes(t, node, under_lock)
        elif isinstance(node, ast.AugAssign):
            yield from _target_writes(node.target, node, under_lock)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            yield from _target_writes(node.target, node, under_lock)
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if (
                node.func.attr in _MUTATING_METHODS
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in watched
            ):
                yield (
                    node.lineno, node.col_offset, node.func.value.id,
                    f".{node.func.attr}() mutation", under_lock,
                )
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            yield from walk(child, under_lock)

    def _target_writes(t: ast.AST, node: ast.AST, under_lock: bool):
        if isinstance(t, ast.Name):
            # a plain rebind counts only when the name is module-global
            # here (declared ``global``); otherwise it's a local shadow
            if t.id in globals_here and t.id in watched | globals_here:
                yield (node.lineno, node.col_offset, t.id, "rebind", under_lock)
        elif isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name):
            if t.value.id in watched:
                yield (
                    node.lineno, node.col_offset, t.value.id,
                    "item assignment", under_lock,
                )
        elif isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                yield from _target_writes(el, node, under_lock)

    for st in fn.body:
        yield from walk(st, False)
