"""Interprocedural device-taint for the GC10x host-sync lint (v2).

Counterpart of ``video_features_tpu/analysis/taint.py``, with its device
facts rewritten for PyTorch (the engine is the JAX package's):

- **sources**: a tensor made with a device ``device=`` keyword
  (``torch.zeros(n, device=dev)``), ``.to(<device>)`` and ``.cuda()``;
  the parameters of an ``nn.Module``'s ``forward`` (the torch form of a
  jitted function's parameters) and a submodule call ``self.<layer>(x)``
  inside one; and a call of a kernel wrapper (a def declared
  ``# graftcheck: cuda-kernel``);
- **host cuts**: ``.cpu()``, ``.numpy()``, ``.tolist()``, ``.item()``,
  ``.to("cpu")``, ``np.asarray``/``np.array`` and the port's
  ``HostCopy`` (``extract/ingest.py``: its D2H is issued without a wait,
  and ``HostCopy.numpy`` is the one wait) return host values;
- the ``torch.distributed`` collectives of ``parallel/distributed.py``
  that agree a host value between processes (``broadcast_one_to_all``,
  ``all_gather_int``, ``process_index``, ...) take the place of the JAX
  package's ``multihost_utils`` facts.

A ``torch.*`` call is not a source by itself: eager PyTorch puts a
result where its inputs are, so such a call carries the union of its
arguments' taint (the engine's default), and ``torch.from_numpy(host)``
stays on the host.

v1's taint was intra-function: a device array returned through a helper
and ``.item()``'d in the caller was invisible (ROADMAP residual). v2
computes per-function *taint summaries* over the project call graph and
propagates device-ness in both directions:

- **returns**: a helper whose return value is device-tainted taints the
  call expression in every caller (``h = helper(x); float(h)`` flags in
  the caller);
- **parameters**: a device value passed into a helper taints the matching
  parameter inside the helper, and a helper that returns one of its
  parameters propagates the argument's taint back to the call site.

Every device fact carries a provenance chain — (path, line, description)
steps from the origin to the sync site — surfaced as ``Finding.trace``
and printed by the CLI's ``--explain``.

Call resolution for taint is *exact-only* (module functions, imported
project functions, ``self.method`` on the caller's own class): the
thread-safety walk wants conservative fan-out, but taint powering a lint
on hot files must not let one project function named ``get`` taint every
``obj.get()`` in the tree. Unresolvable calls fall back to v1 semantics:
the call is tainted iff an argument is.

Summaries are a fixpoint over the call graph (taint only grows, so
recursion converges), then a second fixpoint pushes caller-argument
taint into callees. The project graph is a few hundred functions; the
whole pass stays inside bench.py's ``analysis_overhead`` budget.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from video_features_tpu_torch.analysis.callgraph import CallGraph, FunctionInfo
from video_features_tpu_torch.analysis.core import (
    SourceFile,
    dotted_name,
    import_aliases,
    param_names,
    resolve_dotted,
)

# calls whose results are HOST values (never taint): the device queries,
# and the collectives of parallel/distributed.py whose JOB is a
# host-level agreement between processes — the result is a Python value
# every process holds, and flagging the ``bool()`` around it would teach
# nothing (the JAX package's multihost_utils facts)
_HOST_RESULTS = frozenset(
    {
        "torch.cuda.device_count",
        "torch.cuda.is_available",
        "torch.cuda.current_device",
        "torch.cuda.get_device_name",
        "torch.cuda.get_device_properties",
        "torch.cuda.mem_get_info",
        "torch.cuda.memory_allocated",
        "torch.cuda.memory_reserved",
        "torch.distributed.get_rank",
        "torch.distributed.get_world_size",
        "torch.distributed.is_initialized",
        "torch.distributed.is_available",
        "len",
        "isinstance",
        "hasattr",
    }
)
_HOST_COLLECTIVES = frozenset(
    {
        "broadcast_one_to_all",
        "all_gather_int",
        "process_index",
        "process_count",
        "multihost",
        "barrier",
    }
)
# host fetches of a device value: numpy's wrappers and the tensor
# methods that copy to the host (GC103 flags them on a device value)
_FETCHERS = frozenset({"numpy.asarray", "numpy.array"})
_FETCH_METHODS = frozenset({"cpu", "numpy", "tolist"})
# methods whose result is a host value whatever the receiver: the
# fetches, the scalar read, and the metadata queries
_HOST_METHODS = _FETCH_METHODS | frozenset(
    {"item", "size", "dim", "numel", "element_size", "stride", "data_ptr",
     "is_contiguous", "get_device", "nelement"}
)
# the port's deferred D2H: constructing one issues the copy without a
# wait; its ``numpy()`` is the fetch boundary's one wait
HOST_COPY = "HostCopy"
KERNEL_MARKER = "cuda-kernel"
# the attributes through which a tainted value's taint flows: a tensor's
# own tensor-valued views and a module's parameters. Any other field of a
# tainted object (``model.cfg``, ``layer.time_pads``, a handle's metadata)
# is host state or of a type the AST cannot see, and the lint does not
# guess — the JAX engine's union over attribute access would make every
# config int of a module moved ``.to(device)`` a device value
_TENSOR_ATTRS = frozenset(
    {"T", "mT", "H", "mH", "data", "real", "imag", "grad", "weight", "bias"}
)


def is_cpu_expr(node: ast.AST, aliases: Dict[str, str]) -> bool:
    """``"cpu"``, ``torch.device("cpu")``: a device expression naming
    the host."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":")[0] == "cpu"
    if isinstance(node, ast.Call) and node.args:
        rd = resolve_dotted(node.func, aliases)
        if rd == "torch.device":
            return is_cpu_expr(node.args[0], aliases)
    return False


def is_device_expr(node: ast.AST, aliases: Dict[str, str]) -> bool:
    """A device expression naming an accelerator: ``"cuda"``/``"cuda:0"``,
    ``torch.device("cuda", i)``, or a name/attribute that holds a device
    by the port's naming (``device``, ``dev``, ``self.device``)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":")[0] == "cuda"
    if isinstance(node, ast.Call):
        rd = resolve_dotted(node.func, aliases)
        if rd == "torch.device" and node.args:
            return not is_cpu_expr(node.args[0], aliases)
        return False
    dn = dotted_name(node)
    if dn is None:
        return False
    last = dn.rsplit(".", 1)[-1].lower()
    return last in ("dev", "device") or last.endswith("_device")


def module_classes(sources: Sequence[SourceFile]) -> Set[Tuple[str, str]]:
    """(rel, class name) of every ``nn.Module`` subclass in the sweep: a
    base that resolves into ``torch.nn`` (``nn.Module``, ``nn.LayerNorm``,
    ``nn.Sequential``) or, transitively, a project class that is one."""
    classes: List[Tuple[SourceFile, ast.ClassDef, Dict[str, str]]] = []
    for src in sources:
        aliases = import_aliases(src.tree)
        for node in ast.walk(src.tree):
            if isinstance(node, ast.ClassDef):
                classes.append((src, node, aliases))
    found: Set[Tuple[str, str]] = set()
    names: Set[str] = set()
    for _ in range(4):  # inheritance chains in the port are a few deep
        grew = False
        for src, node, aliases in classes:
            if (src.rel, node.name) in found:
                continue
            for base in node.bases:
                rd = resolve_dotted(base, aliases) or ""
                bare = rd.rsplit(".", 1)[-1]
                if (rd.startswith("torch.nn.") and ".functional" not in rd) or (
                    bare in names
                ):
                    found.add((src.rel, node.name))
                    names.add(node.name)
                    grew = True
                    break
        if not grew:
            break
    return found


Step = Tuple[str, int, str]  # (path, line, description)


@dataclasses.dataclass(frozen=True)
class Taint:
    """Taint of one value: device-ness (with provenance) plus which of
    the enclosing function's parameters flow into it (for summaries)."""

    device: bool = False
    params: frozenset = frozenset()
    chain: Tuple[Step, ...] = ()

    def __or__(self, other: "Taint") -> "Taint":
        return Taint(
            device=self.device or other.device,
            params=self.params | other.params,
            chain=self.chain if self.device else other.chain,
        )


EMPTY = Taint()


def _device(chain: Tuple[Step, ...]) -> Taint:
    return Taint(device=True, chain=chain)


@dataclasses.dataclass
class Summary:
    """What a function's RETURN value carries: device taint (with the
    chain back to its origin) and/or parameter indices that flow out."""

    returns: Taint = EMPTY


class ProjectTaint:
    """Shared taint state over one ``run_checks`` source set."""

    def __init__(self, sources: Sequence[SourceFile], graph: CallGraph) -> None:
        self.sources = list(sources)
        self.graph = graph
        self.summaries: Dict[str, Summary] = {}
        # externally induced param taint: key -> {param index: chain}
        self.param_taint: Dict[str, Dict[int, Tuple[Step, ...]]] = {}
        # post-fixpoint name envs (closures inherit; hostsync flags from)
        self._env: Dict[str, Dict[str, Taint]] = {}
        self._module_env: Dict[str, Dict[str, Taint]] = {}
        self._aliases = {s.rel: import_aliases(s.tree) for s in sources}
        self.module_classes = module_classes(self.sources)
        self._compute()

    # --- public API ---------------------------------------------------------

    def env_for(self, key: str) -> Dict[str, Taint]:
        return self._env.get(key, {})

    def module_env(self, src: SourceFile) -> Dict[str, Taint]:
        return self._module_env.get(src.rel, {})

    def expr_taint(
        self,
        node: ast.AST,
        env: Dict[str, Taint],
        src: SourceFile,
        info: Optional[FunctionInfo],
    ) -> Taint:
        return self._expr(node, env, src, info)

    # --- fixpoints ----------------------------------------------------------

    def _compute(self) -> None:
        order = self._definition_order()
        for _ in range(5):  # summary fixpoint
            self._scan_modules()
            changed = False
            for info in order:
                taints, ret = self._scan(info)
                self._env[info.key] = taints
                old = self.summaries.get(info.key)
                if old is None or old.returns != ret:
                    self.summaries[info.key] = Summary(ret)
                    changed = True
            if not changed:
                break
        for _ in range(5):  # caller-arg -> callee-param fixpoint
            pushed = False
            for info in order:
                if self._push_args(info, self._env[info.key]):
                    pushed = True
            if not pushed:
                break
            self._scan_modules()
            for info in order:
                # the summaries stay those of the first fixpoint: a device
                # argument one caller pushes into a shared helper taints
                # the helper's body (its env), but what the helper returns
                # to another caller is that caller's own argument's taint
                # (the summary's parameter flow) — so ingest.stack_group
                # fed device tensors by I3D does not make R(2+1)D's host
                # stacks device values
                taints, _ = self._scan(info)
                self._env[info.key] = taints

    def _definition_order(self) -> List[FunctionInfo]:
        # outer before inner, so closure envs exist when nested defs scan
        return sorted(
            self.graph.functions.values(),
            key=lambda f: (f.src.rel, f.node.lineno, f.node.col_offset),
        )

    def _scan_modules(self) -> None:
        for src in self.sources:
            env = self._module_env.setdefault(src.rel, {})
            flat = flatten_body(src.tree.body)
            for _ in range(2):
                if not self._assign_pass(flat, env, src, None):
                    break

    def _push_args(self, info: FunctionInfo, taints: Dict[str, Taint]) -> bool:
        changed = False
        for site in self.graph.calls.get(info.key, ()):
            callee = self.graph.functions.get(site.callee)
            if callee is None:
                continue
            pnames = param_names(callee.node)
            skip = 1 if callee.cls and pnames and pnames[0] in ("self", "cls") else 0
            for i, arg in enumerate(site.node.args):
                t = self._expr(arg, taints, info.src, info)
                if not t.device:
                    continue
                idx = i + skip
                if idx >= len(pnames):
                    break
                slot = self.param_taint.setdefault(callee.key, {})
                if idx not in slot:
                    slot[idx] = t.chain + (
                        (
                            info.src.path,
                            site.node.lineno,
                            f"passed to {callee.name}() as {pnames[idx]!r}",
                        ),
                    )
                    changed = True
        return changed

    # --- per-function scan --------------------------------------------------

    def initial_taints(self, info: FunctionInfo) -> Dict[str, Taint]:
        taints: Dict[str, Taint] = {}
        names = param_names(info.node)
        # the torch form of a jitted function's parameters: what a
        # module's forward receives is on the module's device
        forward = (
            info.name == "forward"
            and info.parent is None
            and (info.src.rel, info.cls or "") in self.module_classes
        )
        tensorish = _tensor_params(info.node) if forward else set()
        for i, p in enumerate(names):
            t = Taint(params=frozenset({i}))
            if p in tensorish:
                t = t | _device(
                    ((info.src.path, info.node.lineno,
                      f"parameter {p!r} of {info.cls}.forward"),)
                )
            ext = self.param_taint.get(info.key, {}).get(i)
            if ext is not None:
                t = t | _device(ext)
            taints[p] = t
        # closure inheritance: enclosing scope's device taints flow in,
        # minus names this function binds itself (params / assignments)
        outer = (
            self._env.get(info.parent)
            if info.parent
            else self._module_env.get(info.src.rel)
        )
        if outer:
            bound = set(names) | _assigned_names(info.node)
            for n, t in outer.items():
                if n not in bound and t.device:
                    taints[n] = Taint(device=True, chain=t.chain)
        return taints

    def _scan(self, info: FunctionInfo) -> Tuple[Dict[str, Taint], Taint]:
        taints = self.initial_taints(info)
        flat = flatten_body(info.node.body)
        for _ in range(4):
            if not self._assign_pass(flat, taints, info.src, info):
                break
        ret = EMPTY
        for st in flat:
            if isinstance(st, ast.Return) and st.value is not None:
                ret = ret | self._expr(st.value, taints, info.src, info)
        return taints, ret

    def _assign_pass(
        self,
        flat: List[ast.stmt],
        taints: Dict[str, Taint],
        src: SourceFile,
        info: Optional[FunctionInfo],
    ) -> bool:
        changed = False
        for st in flat:
            if not isinstance(st, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                continue
            value = st.value
            if value is None:
                continue
            t = self._expr(value, taints, src, info)
            if not t.device and not t.params:
                continue
            targets = st.targets if isinstance(st, ast.Assign) else [st.target]
            for tgt in targets:
                for n in _target_names(tgt):
                    old = taints.get(n, EMPTY)
                    new = old | (
                        Taint(
                            device=True,
                            params=t.params,
                            chain=t.chain
                            + ((src.path, st.lineno, f"assigned to {n!r}"),),
                        )
                        if t.device
                        else t
                    )
                    if new != old:
                        taints[n] = new
                        changed = True
        return changed

    # --- torch device facts -------------------------------------------------

    def _def_tokens(self, key: str) -> Set[str]:
        """graftcheck tokens on a def's lines or the comment above it."""
        info = self.graph.functions[key]
        fn = info.node
        lines = set(range(fn.lineno, fn.body[0].lineno)) | {
            d.lineno for d in fn.decorator_list
        }
        out: Set[str] = set()
        for ln in lines:
            out |= info.src.waivers.get(ln, set())
        return out

    def _device_source(
        self,
        node: ast.Call,
        aliases: Dict[str, str],
        info: Optional[FunctionInfo],
    ) -> Optional[str]:
        """Why this call makes a device tensor, or None."""
        func = node.func
        if isinstance(func, ast.Attribute):
            if func.attr == "cuda":
                return ".cuda() moves a value to the device"
            if func.attr == "to":
                target = node.args[0] if node.args else None
                for kw in node.keywords:
                    if kw.arg == "device":
                        target = kw.value
                if target is not None and is_device_expr(target, aliases):
                    return ".to(<device>) moves a value to the device"
            if (
                isinstance(func.value, ast.Name)
                and func.value.id == "self"
                and info is not None
                and info.cls is not None
                and (info.src.rel, info.cls) in self.module_classes
                and (info.src.rel, info.cls, func.attr) not in self.graph.methods_of
            ):
                return f"submodule call self.{func.attr}(...) runs on the device"
        for kw in node.keywords:
            if kw.arg == "device" and is_device_expr(kw.value, aliases):
                rd = resolve_dotted(func, aliases) or "call"
                return f"{rd}(..., device=...) creates a device tensor"
        return None

    # --- expression taint ---------------------------------------------------

    def _taint_callees(
        self, func: ast.AST, src: SourceFile, info: Optional[FunctionInfo]
    ) -> List[str]:
        """Exact-only callee resolution (no by-name fan-out): module and
        imported project functions, nested defs, ``self.method`` on the
        caller's own class."""
        graph = self.graph
        if isinstance(func, ast.Name):
            keys, _ = graph.resolve_call(func, src, info)
            return keys
        if isinstance(func, ast.Attribute):
            aliases = self._aliases[src.rel]
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
            return []
        if isinstance(func, ast.Call):
            rd = resolve_dotted(func.func, self._aliases[src.rel])
            if rd in ("functools.partial", "partial") and func.args:
                return self._taint_callees(func.args[0], src, info)
        return []

    def _expr(
        self,
        node: ast.AST,
        taints: Dict[str, Taint],
        src: SourceFile,
        info: Optional[FunctionInfo],
    ) -> Taint:
        """Taint of evaluating ``node``: device origin + param flow."""
        aliases = self._aliases[src.rel]

        if isinstance(node, ast.Name):
            return taints.get(node.id, EMPTY)
        if isinstance(node, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in node.ops
        ):
            return EMPTY  # identity and membership answer a Python bool
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)):
            # the element's taint, with each target bound to its iterable's:
            # ``sum(t.shape[0] for t in parts)`` is host geometry even when
            # ``parts`` holds device tensors
            local = dict(taints)
            for gen in node.generators:
                it = self._expr(gen.iter, local, src, info)
                for n in _target_names(gen.target):
                    local[n] = it
            elts = [node.key, node.value] if isinstance(node, ast.DictComp) else [node.elt]
            out = EMPTY
            for e in elts:
                out = out | self._expr(e, local, src, info)
            return out
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "to"
            and any(
                is_cpu_expr(a, aliases)
                for a in list(node.args[:1])
                + [kw.value for kw in node.keywords if kw.arg == "device"]
            )
        ):
            return EMPTY  # .to("cpu"): the result lives on the host
        if isinstance(node, ast.Attribute) and node.attr not in _TENSOR_ATTRS:
            # metadata (.shape, .device) is host-side even on a device
            # tensor, and other fields are not followed (_TENSOR_ATTRS)
            return EMPTY
        if isinstance(node, ast.Call):
            rd = resolve_dotted(node.func, aliases)
            if rd is not None:
                if (
                    rd in _HOST_RESULTS
                    or rd in _FETCHERS
                    or rd.rsplit(".", 1)[-1] == HOST_COPY
                    or (
                        rd.rsplit(".", 1)[-1] in _HOST_COLLECTIVES
                        and "distributed" in rd
                    )
                ):
                    return EMPTY  # the result lives on the host
            source = self._device_source(node, aliases, info)
            if source is not None:
                return _device(((src.path, node.lineno, source),))
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _HOST_METHODS
            ):
                return EMPTY  # a fetch, a scalar read or a metadata query
            callees = [
                c
                for c in self._taint_callees(node.func, src, info)
                if c in self.summaries
            ]
            for ck in callees:
                if KERNEL_MARKER in self._def_tokens(ck):
                    return _device(
                        ((src.path, node.lineno,
                          f"kernel wrapper {self.graph.functions[ck].name}() "
                          "returns a device tensor"),)
                    )
            if callees:
                out = EMPTY
                for ck in callees:
                    summ = self.summaries[ck].returns
                    callee = self.graph.functions[ck]
                    if summ.device:
                        out = out | _device(
                            summ.chain + (
                                (src.path, node.lineno,
                                 f"device value returned by {callee.name}()"),
                            )
                        )
                    pnames = param_names(callee.node)
                    skip = (
                        1 if callee.cls and pnames
                        and pnames[0] in ("self", "cls") else 0
                    )
                    for idx in summ.params:
                        a = idx - skip
                        if 0 <= a < len(node.args):
                            t = self._expr(node.args[a], taints, src, info)
                            if t.device:
                                out = out | _device(
                                    t.chain + (
                                        (src.path, node.lineno,
                                         f"flows through {callee.name}() "
                                         "back to the caller"),
                                    )
                                )
                            out = out | Taint(params=t.params)
                # a resolved project call: the summary IS the answer
                return out
        # default: union over child expressions (method calls on tainted
        # objects, binops, subscripts, f-strings ... all propagate); a
        # method call carries its receiver's taint (the attribute cut
        # above is for fields, not for ``x.square()``)
        children = list(ast.iter_child_nodes(node))
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            children = [node.func.value] + children[1:]
        out = EMPTY
        for child in children:
            out = out | self._expr(child, taints, src, info)
        return out


# --- shared AST plumbing ----------------------------------------------------

def flatten_body(body: List[ast.stmt]) -> List[ast.stmt]:
    """Every statement in ``body`` transitively, EXCLUDING nested defs
    (separate call-graph nodes with closure-inherited envs). Class bodies
    stay in the enclosing scope, as in v1."""
    flat: List[ast.stmt] = []

    def go(stmts):
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            flat.append(st)
            for field in ("body", "orelse", "finalbody"):
                go(getattr(st, field, []) or [])
            for h in getattr(st, "handlers", []) or []:
                go(h.body)
            for case in getattr(st, "cases", []) or []:
                go(case.body)

    go(body)
    return flat


def _target_names(t: ast.AST) -> List[str]:
    if isinstance(t, ast.Name):
        return [t.id]
    if isinstance(t, (ast.Tuple, ast.List)):
        out: List[str] = []
        for el in t.elts:
            out.extend(_target_names(el))
        return out
    if isinstance(t, ast.Starred):
        return _target_names(t.value)
    return []


def _assigned_names(fn: ast.FunctionDef) -> Set[str]:
    out: Set[str] = set()
    for st in flatten_body(fn.body):
        if isinstance(st, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = st.targets if isinstance(st, ast.Assign) else [st.target]
            for t in targets:
                out.update(_target_names(t))
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            out.update(_target_names(st.target))
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                if item.optional_vars is not None:
                    out.update(_target_names(item.optional_vars))
    return out


def _tensor_params(fn: ast.FunctionDef) -> Set[str]:
    """The parameters of a ``forward`` that carry tensors: all but
    ``self``, those annotated with a non-tensor type (``halo: bool``,
    ``kv_len: Optional[int]``) and those defaulting to a constant other
    than ``None``."""
    a = fn.args
    positional = a.posonlyargs + a.args
    defaults = [None] * (len(positional) - len(a.defaults)) + list(a.defaults)
    pairs = list(zip(positional, defaults)) + list(zip(a.kwonlyargs, a.kw_defaults))
    out: Set[str] = set()
    for arg, default in pairs:
        if arg.arg in ("self", "cls"):
            continue
        if arg.annotation is not None and "Tensor" not in ast.dump(arg.annotation):
            continue
        if (
            isinstance(default, ast.Constant)
            and default.value is not None
        ):
            continue
        out.add(arg.arg)
    if a.vararg is not None:
        out.add(a.vararg.arg)
    return out


def format_chain(chain: Tuple[Step, ...]) -> List[str]:
    return [f"{path}:{line}: {desc}" for path, line, desc in chain]
