"""Project call graph for graftcheck's interprocedural passes (v2).

One :class:`CallGraph` is built per ``run_checks`` sweep and shared by the
taint pass (hostsync GC10x), the thread-safety pass (GC301), and the
sharding-contract pass (GC50x). Resolution is deliberately conservative —
static Python call resolution is undecidable, so unresolvable edges err
toward *more* reachability (a bare call through a variable fans out to
every project ``__call__``; ``self.prepare(...)`` fans out to every method
named ``prepare``) so the thread-safety walk never silently exempts a
function that might really run on a worker thread.

The graph also locates *thread entries*: functions handed to
``threading.Thread(target=...)``, ``pool.submit(fn, ...)``,
``executor.map(fn, ...)``, ``threading.Timer(_, fn)`` or
``_thread.start_new_thread(fn, ...)``. Files carrying the
``# graftcheck: thread-root`` marker but containing NO resolvable spawn
site (the test-fixture contract) treat every function they define as an
entry — a marker says "this file's code runs on threads" when the spawn
site itself is out of view.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from video_features_tpu_torch.analysis.core import (
    SourceFile,
    import_aliases,
    resolve_dotted,
)


@dataclasses.dataclass
class FunctionInfo:
    key: str  # unique: "<rel>::<qualpath>"
    name: str  # bare name
    src: SourceFile
    node: ast.FunctionDef
    cls: Optional[str]  # enclosing class name, if a method
    parent: Optional[str]  # enclosing function's key, for closures


@dataclasses.dataclass
class CallSite:
    caller: str  # FunctionInfo.key, or "<rel>::" for module body
    callee: str  # resolved FunctionInfo.key
    node: ast.Call
    src: SourceFile


def module_suffixes(src: SourceFile) -> Set[str]:
    """Dotted-name suffixes this module answers to (mirrors the
    thread-safety import matcher): ``io/sink.py`` answers to
    ``io.sink`` and ``sink``; ``native/__init__.py`` also to ``native``."""
    name = src.module_name
    out = {name}
    parts = name.split(".")
    for i in range(1, len(parts)):
        out.add(".".join(parts[i:]))
    if parts[-1] == "__init__":
        pkg = ".".join(parts[:-1])
        if pkg:
            pp = pkg.split(".")
            for i in range(len(pp)):
                out.add(".".join(pp[i:]))
    return out


# spawn shapes: (attribute-or-name the call resolves to, how the target
# function rides the call)
_THREAD_CTORS = ("threading.Thread", "Thread")
_TIMER_CTORS = ("threading.Timer", "Timer")
_START_NEW = ("_thread.start_new_thread", "thread.start_new_thread",
              "start_new_thread")


class CallGraph:
    def __init__(self, sources: Sequence[SourceFile]) -> None:
        self.sources = list(sources)
        self.functions: Dict[str, FunctionInfo] = {}
        self.by_name: Dict[str, List[str]] = {}
        self.methods_of: Dict[Tuple[str, str, str], str] = {}  # (rel, cls, name)
        self.classes: Dict[Tuple[str, str], List[str]] = {}  # (rel, cls) -> keys
        self._module_by_suffix: Dict[str, SourceFile] = {}
        self._aliases: Dict[str, Dict[str, str]] = {}
        self.calls: Dict[str, List[CallSite]] = {}
        self.callers: Dict[str, List[CallSite]] = {}
        self.unresolved_callers: Set[str] = set()  # callers with a bare
        # call through a variable (fan out to __call__ methods)
        self._node_key: Dict[int, str] = {}  # id(FunctionDef) -> key
        self._spawn_targets: Dict[str, List[str]] = {}  # rel -> entry keys
        self._spawned_rels: Set[str] = set()  # rels with >=1 resolvable spawn

        for src in sources:
            for suf in module_suffixes(src):
                self._module_by_suffix.setdefault(suf, src)
            self._aliases[src.rel] = import_aliases(src.tree)
        for src in sources:
            self._index(src)
        for src in sources:
            self._link(src)

    # --- indexing -----------------------------------------------------------

    def _index(self, src: SourceFile) -> None:
        def visit(node, cls, fn_stack):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    visit(child, child.name, fn_stack)
                elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    path = list(fn_stack) + [child.name]
                    key = f"{src.rel}::{'.'.join(([cls] if cls else []) + path)}"
                    # disambiguate re-defs (mesh/solo factory branches)
                    base, n = key, 2
                    while key in self.functions:
                        key = f"{base}#{n}"
                        n += 1
                    info = FunctionInfo(
                        key=key, name=child.name, src=src, node=child,
                        cls=cls,
                        parent=(fn_stack_keys[-1] if fn_stack_keys else None),
                    )
                    self.functions[key] = info
                    self._node_key[id(child)] = key
                    self.by_name.setdefault(child.name, []).append(key)
                    if cls and not fn_stack:  # a direct method, not a
                        # def nested inside one
                        self.methods_of.setdefault((src.rel, cls, child.name), key)
                        self.classes.setdefault((src.rel, cls), []).append(key)
                    fn_stack.append(child.name)
                    fn_stack_keys.append(key)
                    visit(child, cls, fn_stack)
                    fn_stack.pop()
                    fn_stack_keys.pop()
                else:
                    visit(child, cls, fn_stack)

        fn_stack_keys: List[str] = []
        visit(src.tree, None, [])

    def key_of(self, fn_node: ast.AST) -> Optional[str]:
        return self._node_key.get(id(fn_node))

    # --- resolution ---------------------------------------------------------

    def module_function(self, src: SourceFile, name: str) -> Optional[str]:
        key = f"{src.rel}::{name}"
        return key if key in self.functions else None

    def resolve_module(self, dotted: str) -> Optional[SourceFile]:
        parts = dotted.split(".")
        for i in range(len(parts)):
            hit = self._module_by_suffix.get(".".join(parts[i:]))
            if hit is not None:
                return hit
        return None

    def _class_init(self, src: SourceFile, cls: str) -> List[str]:
        key = self.methods_of.get((src.rel, cls, "__init__"))
        return [key] if key else []

    def _local_classes(self, src: SourceFile) -> Set[str]:
        return {
            n.name for n in src.tree.body if isinstance(n, ast.ClassDef)
        }

    def resolve_call(
        self, func: ast.AST, src: SourceFile, caller: Optional[FunctionInfo]
    ) -> Tuple[List[str], bool]:
        """Resolved callee keys for a call through ``func``, plus a flag
        for "bare call through a variable" (unresolvable — the caller
        conservatively reaches every project ``__call__``)."""
        aliases = self._aliases[src.rel]
        if isinstance(func, ast.Name):
            name = func.id
            # nested def in an enclosing function
            info = caller
            while info is not None:
                hits = [
                    k for k in self.by_name.get(name, ())
                    if self.functions[k].parent == info.key
                ]
                if hits:
                    return hits, False
                info = (
                    self.functions.get(info.parent) if info.parent else None
                )
            hit = self.module_function(src, name)
            if hit:
                return [hit], False
            if name in self._local_classes(src):
                return self._class_init(src, name), False
            target = aliases.get(name)
            if target:
                mod, _, attr = target.rpartition(".")
                m = self.resolve_module(mod) if attr else None
                if m is not None:
                    hit = self.module_function(m, attr)
                    if hit:
                        return [hit], False
                    if attr in self._local_classes(m):
                        return self._class_init(m, attr), False
                # imported from outside the project: external, resolved-empty
                return [], False
            # a variable holding a callable: unresolvable
            return [], True
        if isinstance(func, ast.Attribute):
            attr = func.attr
            base = func.value
            rd = resolve_dotted(base, aliases)
            if rd is not None:
                m = self.resolve_module(rd)
                if m is not None:
                    hit = self.module_function(m, attr)
                    if hit:
                        return [hit], False
                    if attr in self._local_classes(m):
                        return self._class_init(m, attr), False
            if (
                isinstance(base, ast.Name)
                and base.id in ("self", "cls")
                and caller is not None
                and caller.cls is not None
            ):
                own = self.methods_of.get((src.rel, caller.cls, attr))
                if own:
                    return [own], False
            # conservative by-name: every project def with this name
            return list(self.by_name.get(attr, ())), False
        if isinstance(func, ast.Call):
            # functools.partial(fn, ...) and friends: resolve the head arg
            rd = resolve_dotted(func.func, aliases)
            if rd in ("functools.partial", "partial") and func.args:
                return self.resolve_call(func.args[0], src, caller)
        return [], False

    # --- linking ------------------------------------------------------------

    def _enclosing(self, src: SourceFile, stack: List[str]) -> Optional[FunctionInfo]:
        return self.functions.get(stack[-1]) if stack else None

    def _link(self, src: SourceFile) -> None:
        spawn_keys: List[str] = []

        def visit(node, stack: List[str]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    key = self.key_of(child)
                    visit(child, stack + ([key] if key else []))
                    continue
                if isinstance(child, ast.Call):
                    caller_info = self._enclosing(src, stack)
                    caller_key = (
                        caller_info.key if caller_info else f"{src.rel}::"
                    )
                    callees, bare = self.resolve_call(
                        child.func, src, caller_info
                    )
                    if bare:
                        self.unresolved_callers.add(caller_key)
                    for ck in callees:
                        site = CallSite(caller_key, ck, child, src)
                        self.calls.setdefault(caller_key, []).append(site)
                        self.callers.setdefault(ck, []).append(site)
                    spawn_keys.extend(
                        self._spawn_target_keys(child, src, caller_info)
                    )
                visit(child, stack)

        visit(src.tree, [])
        if spawn_keys:
            self._spawned_rels.add(src.rel)
            self._spawn_targets[src.rel] = spawn_keys

    def _spawn_target_keys(
        self, call: ast.Call, src: SourceFile, caller: Optional[FunctionInfo]
    ) -> List[str]:
        aliases = self._aliases[src.rel]
        rd = resolve_dotted(call.func, aliases)
        target: Optional[ast.AST] = None
        if rd in _THREAD_CTORS or (rd or "").endswith("threading.Thread"):
            for kw in call.keywords:
                if kw.arg == "target":
                    target = kw.value
        elif rd in _TIMER_CTORS and len(call.args) >= 2:
            target = call.args[1]
        elif rd in _START_NEW and call.args:
            target = call.args[0]
        elif isinstance(call.func, ast.Attribute) and call.func.attr in (
            "submit", "map", "apply_async",
        ) and call.args:
            target = call.args[0]
        if target is None:
            return []
        keys, _ = self.resolve_call(target, src, caller)
        return keys

    # --- thread reachability ------------------------------------------------

    def thread_entries(self) -> Set[str]:
        entries: Set[str] = set()
        for keys in self._spawn_targets.values():
            entries.update(keys)
        for src in self.sources:
            if "thread-root" in src.markers and src.rel not in self._spawned_rels:
                # marker fixture with no visible spawn site: every def in
                # the file runs on threads by declaration
                entries.update(
                    k for k, f in self.functions.items() if f.src is src
                )
        return entries

    def thread_side(self) -> Dict[str, Tuple[str, ...]]:
        """key -> reachability chain (entry-first list of keys) for every
        function reachable from a thread entry, closed over calls. A bare
        call through a variable inside thread-side code fans out to every
        project ``__call__`` method."""
        chains: Dict[str, Tuple[str, ...]] = {}
        frontier: List[str] = []
        for e in sorted(self.thread_entries()):
            if e not in chains:
                chains[e] = (e,)
                frontier.append(e)
        call_methods = [
            k for k, f in self.functions.items() if f.name == "__call__"
        ]
        while frontier:
            nxt: List[str] = []
            for key in frontier:
                succ = [s.callee for s in self.calls.get(key, ())]
                if key in self.unresolved_callers:
                    succ.extend(call_methods)
                for s in succ:
                    if s not in chains:
                        chains[s] = chains[key] + (s,)
                        nxt.append(s)
            frontier = nxt
        return chains
