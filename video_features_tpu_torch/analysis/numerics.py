"""GC80x — numerics & dtype-flow contracts for the low-precision path.

Counterpart of ``video_features_tpu/analysis/numerics.py``, retargeted at
PyTorch and CUDA. The port's ``--dtype bfloat16`` graphs keep the JAX
package's fp32 islands (the norms' statistics, softmax, RAFT's GRU
carries, PWC's cost volumes), the uint8 wire keeps the H2D bytes down,
and the hand-written kernels accumulate in fp32. Nothing stops a
refactor from dropping a pin; the drift only shows as a slightly worse
feature vector. GC80x makes the contract machine-checked, on the call
graph and the taint fixpoint:

- **GC801 implicit-promotion** — float64 constructs reaching a model's
  forward: ``torch.float64``/``torch.double`` dtypes, ``.double()``,
  ``astype(float64)``, and a dtype-less ``np.linspace``/``np.zeros``/...
  (float64 by default) handed to ``torch.from_numpy``/``torch.as_tensor``/
  ``torch.tensor``. The roots are the torch form of the JAX rule's jit
  entries: every ``nn.Module.forward`` and the extractors' dispatch hooks
  (``forward``, ``dispatch_prepared``, ``dispatch_group``,
  ``transfer_group``, ``extract_prepared``). f64 runs at 1/64 of the
  H100's fp32 rate and doubles the bytes. A helper whose *return value*
  carries an f64 construct is flagged at its caller on the forward side.
- **GC802 accum-dtype** — numerically sensitive reductions (softmax,
  log_softmax, logsumexp, the norms' statistics, mean/var/std/cumsum/
  sum, norm) reachable under a *bf16 entry* must pin fp32 visibly: a
  ``.float()``/``.to(torch.float32)`` operand, ``dtype=torch.float32`` at
  the call, or a ``# graftcheck: fp32-island — <why>`` declaration on the
  def or the line. A bf16 entry is the ``forward`` of an ``nn.Module`` in
  ``models/<family>/model.py`` whose family ``config.py`` admits for
  bfloat16 (the port's models take the dtype their input carries, where
  a Flax module names it in a ``dtype`` field), a def with a ``dtype``
  parameter, a method of a class with a ``dtype`` field, or a
  ``# graftcheck: bf16-entry`` declaration. Matmuls and convolutions are
  not flagged: they run through cuBLAS and cuDNN, which accumulate a
  bf16 GEMM or convolution in fp32 (and ``devices.pin_fp32`` turns off
  cuBLAS's reduced-precision bf16 split-K reduction), so a bf16 operand
  is a deliberate election of the input precision — the torch form of
  the JAX rule's pass for a matmul whose operands are cast to the
  entry's ``self.dtype`` on purpose. Sensitive reductions get no such
  pass.
- **GC803 cast-discipline** — a host-side float32 cast of a frame payload
  (``astype(np.float32)``, ``.float()``, ``.to(torch.float32)`` of a host
  value) in a hot module or an extractor: a float32 frame ships 4x the
  bytes of the uint8 wire. Host-only parity paths carry an
  ``fp32-island`` declaration.
- **GC804 parity-pin-coverage** — ``config.LOW_PRECISION_MODEL_FAMILIES``
  and ``config.PARITY_CEILINGS`` must cover each other (every admitted
  (family, dtype) has a numeric ceiling; no ceiling is orphaned), and
  every admitted pair must be asserted end to end by a case in
  ``tests/test_torch_bfloat16.py`` (``max_rel_drift``/
  ``assert_drift_within`` with the family named). The port keeps its
  ceilings in ``config.py``, not in a ``parity_budget.json``.
- **GC805 kernel-hygiene** — each hand-written kernel's wrapper, declared
  by ``# graftcheck: cuda-kernel`` on its def: its module builds the
  kernel through ``ops/kernels.py`` (``kernels.load("<name>")`` with
  ``csrc/<name>.cu`` present) and keeps a ``launches`` counter
  (``<wrapper>.launches = 0`` and ``kernels.count_launch(<wrapper>)``);
  the wrapper, or the dispatcher that calls it, names a plain twin (a
  ``*_reference``/``*plain*`` def); no ``try`` around the kernel catches
  a build or launch error to call that twin (the port's no-fallback
  rule: a CUDA tensor launches the kernel or raises); a
  ``pytest.mark.cuda`` test names the wrapper and its twin; and where the
  ``.cu`` source instantiates bf16, its accumulators are ``float`` (an
  ``acc``/``sum`` declared in ``T``, ``__nv_bfloat16`` or ``__half`` is a
  finding) — where the JAX rule reads the Pallas body.

Three declaration tokens ride the ``# graftcheck:`` comment syntax but
are NOT waivers — none of them prefix-matches a rule name:
``fp32-island — <why>`` (def or line), ``bf16-entry`` (def or file) and
``cuda-kernel`` (a kernel wrapper's def).

Resolution is exact-only (taint.py semantics); findings carry the
reachability chain in ``trace`` (``--explain GC80``).
"""

from __future__ import annotations

import ast
import fnmatch
import os
import re
import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

from video_features_tpu_torch.analysis.callgraph import CallGraph, FunctionInfo
from video_features_tpu_torch.analysis.concurrency import _exact_callees, _own_nodes
from video_features_tpu_torch.analysis.core import (
    Finding,
    Rule,
    SourceFile,
    import_aliases,
    package_root,
    param_names,
    resolve_dotted,
)
from video_features_tpu_torch.analysis.taint import (
    KERNEL_MARKER,
    ProjectTaint,
    _target_names,
)

RULES = {
    "GC801": Rule(
        "GC801", "implicit-promotion",
        "float64 construct reaches a model's forward or a dispatch hook",
    ),
    "GC802": Rule(
        "GC802", "accum-dtype",
        "sensitive reduction under a bf16 entry lacks an fp32 pin",
    ),
    "GC803": Rule(
        "GC803", "cast-discipline",
        "host-side float32 cast on a frame payload quadruples H2D bytes",
    ),
    "GC804": Rule(
        "GC804", "parity-pin-coverage",
        "config-admitted (family, dtype) lacks a PARITY_CEILINGS entry "
        "or its e2e assertion",
    ),
    "GC805": Rule(
        "GC805", "kernel-hygiene",
        "CUDA kernel build/counter/twin/test/accumulator hygiene violation",
    ),
}

ISLAND_TOKEN = "fp32-island"
BF16_ENTRY_TOKEN = "bf16-entry"

_HINT_801 = (
    "stay in float32/bfloat16 (dtype=np.float32 on the numpy creator, "
    "torch.float32 literals): f64 runs at a sliver of the card's fp32 rate "
    "and doubles the bytes"
)
_HINT_802 = (
    "pin the reduction: .float() / .to(torch.float32) on the operand, "
    "dtype=torch.float32 at the call, or declare "
    "`# graftcheck: fp32-island — <why>` when an upstream contract already "
    "keeps these values fp32"
)
_HINT_803 = (
    "ship uint8 to the wire and cast on the device (--preprocess device, "
    "or the dispatch's .float() after the H2D); a host-only parity path "
    "declares `# graftcheck: fp32-island — <why>`"
)
_HINT_804 = (
    "commit the drift ceiling in config.PARITY_CEILINGS and assert it end "
    "to end in tests/test_torch_bfloat16.py (max_rel_drift / "
    "assert_drift_within from analysis/parity.py)"
)
_HINT_805 = (
    "build through kernels.load(<csrc name>), count launches with "
    "kernels.count_launch(<wrapper>) and <wrapper>.launches = 0, dispatch a "
    "CPU tensor to a *_reference twin without catching a CUDA failure, "
    "hold the kernel against the twin in a pytest.mark.cuda test, and "
    "accumulate in float"
)

# the extractors' dispatch hooks: what runs a model on a payload
DISPATCH_HOOKS = frozenset(
    {"forward", "dispatch_prepared", "dispatch_group", "transfer_group",
     "extract_prepared"}
)
_EXTRACTOR_PATTERNS = ("extract/*.py", "models/*/extract_*.py")


# --- shared dtype / token predicates ----------------------------------------

_F64_NAMES = frozenset(
    {
        "float",
        "builtins.float",
        "numpy.float64",
        "numpy.double",
        "numpy.float_",
        "torch.float64",
        "torch.double",
    }
)
_F64_DEFAULT_CREATORS = frozenset(
    {
        "numpy.zeros",
        "numpy.ones",
        "numpy.empty",
        "numpy.full",
        "numpy.linspace",
        "numpy.eye",
        "numpy.identity",
        "numpy.random.rand",
        "numpy.random.randn",
    }
)
_TORCH_FROM_HOST = frozenset(
    {"torch.from_numpy", "torch.as_tensor", "torch.tensor", "torch.asarray"}
)
_SENSITIVE = frozenset(
    {
        "torch.softmax",
        "torch.log_softmax",
        "torch.logsumexp",
        "torch.nn.functional.softmax",
        "torch.nn.functional.log_softmax",
        "torch.special.logsumexp",
        "torch.mean",
        "torch.var",
        "torch.std",
        "torch.var_mean",
        "torch.std_mean",
        "torch.cumsum",
        "torch.sum",
        "torch.norm",
        "torch.linalg.norm",
        "torch.linalg.vector_norm",
        "torch.nn.functional.layer_norm",
        "torch.nn.functional.group_norm",
        "torch.nn.functional.batch_norm",
        "torch.nn.functional.instance_norm",
        "torch.nn.functional.normalize",
    }
)
_SENSITIVE_METHODS = frozenset(
    {"softmax", "log_softmax", "logsumexp", "mean", "var", "std", "cumsum",
     "sum", "norm"}
)


def _is_f64_dtype(node: ast.AST, aliases: Dict[str, str]) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value in ("float64", "double", "f8", "<f8", ">f8")
    rd = resolve_dotted(node, aliases)
    if rd in _F64_NAMES:
        return True
    if isinstance(node, ast.Call):
        rd = resolve_dotted(node.func, aliases)
        if rd == "numpy.dtype" and node.args:
            return _is_f64_dtype(node.args[0], aliases)
    return False


def _is_f32_dtype(node: ast.AST, aliases: Dict[str, str]) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value in ("float32", "f4", "<f4", ">f4")
    rd = resolve_dotted(node, aliases)
    return rd is not None and (
        rd == "float32" or rd.endswith(".float32") or rd == "torch.float"
    )


def _call_has_pin(call: ast.Call, aliases: Dict[str, str]) -> bool:
    """An fp32 pin attached AT the call site: ``dtype=torch.float32``."""
    return any(
        kw.arg == "dtype" and _is_f32_dtype(kw.value, aliases)
        for kw in call.keywords
    )


def _is_f32_cast(node: ast.AST, aliases: Dict[str, str]) -> bool:
    """``x.float()``, ``x.to(torch.float32)``, ``x.to(dtype=torch.float32)``,
    ``x.type(torch.float32)``, ``x.astype(np.float32)``."""
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
        return False
    attr = node.func.attr
    if attr == "float" and not node.args:
        return True
    if attr in ("to", "type", "astype"):
        args = list(node.args) + [kw.value for kw in node.keywords if kw.arg == "dtype"]
        return any(_is_f32_dtype(a, aliases) for a in args)
    return False


def _def_tokens(src: SourceFile, fn: ast.FunctionDef) -> Set[str]:
    """graftcheck tokens attached to a def: on the def/decorator lines or
    (via core's carry rule) a standalone comment directly above them."""
    lines = set(range(fn.lineno, fn.body[0].lineno))
    lines.add(fn.lineno)
    for dec in fn.decorator_list:
        lines.add(dec.lineno)
    out: Set[str] = set()
    for ln in lines:
        out |= src.waivers.get(ln, set())
    return out


def _islanded(src: SourceFile, info: Optional[FunctionInfo], line: int) -> bool:
    if ISLAND_TOKEN in src.waivers.get(line, ()):
        return True
    return info is not None and ISLAND_TOKEN in _def_tokens(src, info.node)


# --- call-graph plumbing ----------------------------------------------------

class _Ctx:
    """Per-sweep cache: exact call edges, per-function aliases, the
    ``nn.Module`` subclasses."""

    def __init__(self, sources: Sequence[SourceFile], graph: CallGraph,
                 project: ProjectTaint) -> None:
        self.sources = list(sources)
        self.graph = graph
        self.aliases = {s.rel: import_aliases(s.tree) for s in sources}
        self.modules = project.module_classes
        # key -> [(Call node, [callee keys])] over _own_nodes, exact-only
        self.succs: Dict[str, List[Tuple[ast.Call, List[str]]]] = {}
        for key, info in graph.functions.items():
            edges: List[Tuple[ast.Call, List[str]]] = []
            for node in _own_nodes(info.node):
                if isinstance(node, ast.Call):
                    cks = _exact_callees(node.func, info.src, info, graph)
                    if cks:
                        edges.append((node, cks))
            self.succs[key] = edges

    def is_module_forward(self, info: FunctionInfo) -> bool:
        return (
            info.name == "forward"
            and info.parent is None
            and (info.src.rel, info.cls or "") in self.modules
        )

    def reach(self, roots: Sequence[str]) -> Dict[str, Tuple[str, ...]]:
        """key -> root-first chain of keys, closed over exact calls."""
        chains: Dict[str, Tuple[str, ...]] = {}
        frontier: List[str] = []
        for r in sorted(set(roots)):
            chains[r] = (r,)
            frontier.append(r)
        while frontier:
            nxt: List[str] = []
            for key in frontier:
                for _, cks in self.succs.get(key, ()):
                    for ck in cks:
                        if ck not in chains:
                            chains[ck] = chains[key] + (ck,)
                            nxt.append(ck)
            frontier = nxt
        return chains

    def chain_trace(self, chain: Tuple[str, ...], head: str) -> List[str]:
        steps: List[str] = []
        prev: Optional[FunctionInfo] = None
        for i, k in enumerate(chain):
            info = self.graph.functions[k]
            if i == 0:
                steps.append(
                    f"{info.src.path}:{info.node.lineno}: {head} {info.name!r}"
                )
            else:
                steps.append(
                    f"{info.src.path}:{info.node.lineno}: {info.name!r} "
                    f"reachable from {prev.name!r}"
                )
            prev = info
        return steps


# --- GC801 implicit promotion ----------------------------------------------

def _dtypeless_f64_creator(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """``np.linspace(0, 1, 5)`` (no dtype=): the creator's name."""
    if not isinstance(node, ast.Call):
        return None
    rd = resolve_dotted(node.func, aliases)
    if any(kw.arg == "dtype" for kw in node.keywords):
        return None
    if rd in _F64_DEFAULT_CREATORS:
        return rd
    if rd == "numpy.arange" and any(
        isinstance(a, ast.Constant) and isinstance(a.value, float) for a in node.args
    ):
        return rd  # a float step or bound: float64 by default
    return None


def _f64_sites(
    info: FunctionInfo, aliases: Dict[str, str]
) -> List[Tuple[ast.Call, str]]:
    out: List[Tuple[ast.Call, str]] = []
    for node in _own_nodes(info.node):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if isinstance(func, ast.Attribute):
            if func.attr == "double" and not node.args:
                out.append((node, ".double() widens the tensor to float64"))
                continue
            if func.attr in ("astype", "to", "type") and node.args and _is_f64_dtype(
                node.args[0], aliases
            ):
                out.append((node, f".{func.attr}(float64) widens the value"))
                continue
        rd = resolve_dotted(func, aliases)
        if rd in _TORCH_FROM_HOST and node.args:
            creator = _dtypeless_f64_creator(node.args[0], aliases)
            if creator is not None and not any(
                kw.arg == "dtype" and not _is_f64_dtype(kw.value, aliases)
                for kw in node.keywords
            ):
                out.append(
                    (node, f"{rd}({creator}(...)) makes a float64 tensor "
                           "(the creator has no dtype=)")
                )
                continue
        dtype_kw = next((kw for kw in node.keywords if kw.arg == "dtype"), None)
        if dtype_kw is not None and _is_f64_dtype(dtype_kw.value, aliases):
            out.append((node, "dtype= selects float64"))
    return out


def _forward_roots(ctx: _Ctx) -> Set[str]:
    """Every ``nn.Module.forward`` and the extractors' dispatch hooks."""
    roots: Set[str] = set()
    for key, info in ctx.graph.functions.items():
        if ctx.is_module_forward(info):
            roots.add(key)
        elif (
            info.name in DISPATCH_HOOKS
            and info.cls is not None
            and info.parent is None
            and any(fnmatch.fnmatch(info.src.rel, p) for p in _EXTRACTOR_PATTERNS)
        ):
            roots.add(key)
    return roots


def _check_promotion(ctx: _Ctx, roots: Set[str]) -> List[Finding]:
    graph = ctx.graph
    chains = ctx.reach(sorted(roots))
    # f64 constructs sitting in a function's RETURN path, for every
    # function in the project (the interprocedural leg needs them even
    # when the helper itself would not be swept)
    returning: Dict[str, List[Tuple[ast.Call, str]]] = {}
    for key, info in graph.functions.items():
        aliases = ctx.aliases[info.src.rel]
        in_return: Set[int] = set()
        for node in _own_nodes(info.node):
            if isinstance(node, ast.Return) and node.value is not None:
                for sub in ast.walk(node.value):
                    in_return.add(id(sub))
        hits = [
            (n, d) for n, d in _f64_sites(info, aliases) if id(n) in in_return
        ]
        if hits:
            returning[key] = hits

    out: List[Finding] = []
    seen: Set[Tuple[str, int, int, str]] = set()

    def emit(src, node, msg, trace):
        k = (src.path, node.lineno, node.col_offset, msg)
        if k in seen:
            return
        seen.add(k)
        out.append(
            Finding(src.path, node.lineno, node.col_offset, RULES["GC801"],
                    msg, _HINT_801, trace)
        )

    for key, chain in chains.items():
        info = graph.functions[key]
        src = info.src
        aliases = ctx.aliases[src.rel]
        ret_ids = {id(n) for n, _ in returning.get(key, ())}
        for node, desc in _f64_sites(info, aliases):
            if _islanded(src, info, node.lineno):
                continue
            if key not in roots and id(node) in ret_ids:
                # reported at the forward-side caller below, where the
                # f64 value actually meets the model
                continue
            emit(
                src, node,
                f"{desc} inside forward-reachable {info.name!r}",
                ctx.chain_trace(chain, "forward entry"),
            )
        # interprocedural: calls whose exact callee RETURNS an f64 value
        for call, cks in ctx.succs.get(key, ()):
            for ck in cks:
                hits = returning.get(ck)
                if not hits or (ck in roots):
                    continue
                if _islanded(src, info, call.lineno):
                    continue
                callee = graph.functions[ck]
                for n, desc in hits:
                    emit(
                        src, call,
                        f"call to {callee.name!r} returns float64 into "
                        f"forward-reachable {info.name!r}",
                        [f"{callee.src.path}:{n.lineno}: {desc}"]
                        + ctx.chain_trace(chain, "forward entry"),
                    )
    return out


# --- GC802 accumulation dtype ----------------------------------------------

def _dtype_field_classes(src: SourceFile) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for st in node.body:
            if (
                isinstance(st, ast.AnnAssign)
                and isinstance(st.target, ast.Name)
                and st.target.id == "dtype"
            ):
                out.add(node.name)
            elif isinstance(st, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "dtype" for t in st.targets
            ):
                out.add(node.name)
    return out


def _bf16_families(sources: Sequence[SourceFile]) -> Set[str]:
    """The families config.py's LOW_PRECISION_MODEL_FAMILIES admits for a
    dtype other than float32."""
    cfg = next((s for s in sources if s.rel == "config.py"), None)
    if cfg is None:
        return set()
    fams: Set[str] = set()
    for st in cfg.tree.body:
        if isinstance(st, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == ADMISSION_TABLE_NAME
            for t in st.targets
        ):
            for dtype, names in _parse_admissions(st).items():
                if dtype != "float32":
                    fams.update(names)
    return fams


def _bf16_entries(ctx: _Ctx) -> Dict[str, str]:
    """entry key -> why it runs under bf16."""
    entries: Dict[str, str] = {}
    dtype_classes = {s.rel: _dtype_field_classes(s) for s in ctx.sources}
    admitted = _bf16_families(ctx.sources)
    for key, info in ctx.graph.functions.items():
        src = info.src
        if BF16_ENTRY_TOKEN in src.markers:
            entries[key] = "bf16-entry file marker"
            continue
        if BF16_ENTRY_TOKEN in _def_tokens(src, info.node):
            entries[key] = "bf16-entry declaration"
            continue
        if info.cls and info.cls in dtype_classes.get(src.rel, ()):
            entries[key] = f"method of dtype-polymorphic class {info.cls!r}"
            continue
        if "dtype" in param_names(info.node):
            entries[key] = "takes a dtype parameter"
            continue
        parts = src.rel.split("/")
        if (
            len(parts) == 3
            and parts[0] == "models"
            and parts[2] == "model.py"
            and parts[1] in admitted
            and ctx.is_module_forward(info)
        ):
            entries[key] = f"forward of a {parts[1]!r} module (--dtype bfloat16)"
    return entries


def _pinning_expr(
    node: ast.AST,
    aliases: Dict[str, str],
    pinned: Set[str],
    pin_calls: Set[int] = frozenset(),
) -> bool:
    """Does evaluating ``node`` visibly produce an fp32 value? A call in
    ``pin_calls`` (ids of calls to a helper whose every return is pinned,
    like attention's ``_scores``) counts as a pin."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in pinned:
            return True
        if isinstance(sub, ast.Call) and (
            id(sub) in pin_calls
            or _is_f32_cast(sub, aliases)
            or _call_has_pin(sub, aliases)
        ):
            return True
    return False


def _pinned_names(
    fn: ast.FunctionDef,
    aliases: Dict[str, str],
    seed: Optional[Set[str]] = None,
    pin_calls: Set[int] = frozenset(),
) -> Set[str]:
    """Local names visibly assigned from fp32-pinned expressions,
    propagated through simple chains (3 passes)."""
    pinned: Set[str] = set(seed or ())
    stmts = [
        st
        for st in _own_nodes(fn)
        if isinstance(st, (ast.Assign, ast.AnnAssign, ast.AugAssign))
    ]
    for _ in range(3):
        changed = False
        for st in stmts:
            if st.value is None:
                continue
            if not _pinning_expr(st.value, aliases, pinned, pin_calls):
                continue
            targets = st.targets if isinstance(st, ast.Assign) else [st.target]
            for tgt in targets:
                for n in _target_names(tgt):
                    if n not in pinned:
                        pinned.add(n)
                        changed = True
        if not changed:
            break
    return pinned


def _pin_returning(ctx: _Ctx, keys: Sequence[str]) -> Set[str]:
    """Those of ``keys`` whose every ``return`` value is visibly fp32 (a
    helper like ``_scores`` that ends in ``.float()``), closed over helpers
    returning such a helper's result (3 passes)."""
    found: Set[str] = set()
    for _ in range(3):
        grew = False
        for key in keys:
            info = ctx.graph.functions[key]
            if key in found:
                continue
            aliases = ctx.aliases[info.src.rel]
            calls = _calls_into(ctx, key, found)
            pinned = _pinned_names(info.node, aliases, pin_calls=calls)
            rets = [
                st.value for st in _own_nodes(info.node)
                if isinstance(st, ast.Return) and st.value is not None
            ]
            if rets and all(_pinning_expr(r, aliases, pinned, calls) for r in rets):
                found.add(key)
                grew = True
        if not grew:
            break
    return found


def _calls_into(ctx: _Ctx, key: str, targets: Set[str]) -> Set[int]:
    """ids of the calls in ``key``'s body whose exact callee is in
    ``targets``."""
    return {
        id(call) for call, cks in ctx.succs.get(key, ())
        if any(c in targets for c in cks)
    }


def _check_accum(ctx: _Ctx) -> List[Finding]:
    graph = ctx.graph
    entries = _bf16_entries(ctx)
    chains = ctx.reach(sorted(entries))
    # the chains are closed over exact calls: every callee a reduction's
    # operand can come from is in them
    pin_returning = _pin_returning(ctx, sorted(chains))
    out: List[Finding] = []
    for key, chain in chains.items():
        info = graph.functions[key]
        src = info.src
        aliases = ctx.aliases[src.rel]
        if ISLAND_TOKEN in _def_tokens(src, info.node):
            continue
        pin_calls = _calls_into(ctx, key, pin_returning)
        pinned = _pinned_names(info.node, aliases, pin_calls=pin_calls)
        entry = graph.functions[chain[0]]
        trace = ctx.chain_trace(chain, "bf16 entry")
        for node in _own_nodes(info.node):
            if not isinstance(node, ast.Call):
                continue
            rd = resolve_dotted(node.func, aliases)
            kind: Optional[str] = None
            operands: List[ast.AST] = []
            if rd in _SENSITIVE:
                kind = rd.rsplit(".", 1)[-1]
                operands = list(node.args[:1])
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _SENSITIVE_METHODS
                and isinstance(node.func.value, (ast.Name, ast.Attribute, ast.Call,
                                                 ast.Subscript, ast.BinOp))
                and rd not in _SENSITIVE
                and not (rd or "").startswith(("numpy.", "math."))
            ):
                kind = f".{node.func.attr}()"
                operands = [node.func.value]
            if kind is None:
                continue
            if _islanded(src, None, node.lineno):
                continue
            if _call_has_pin(node, aliases):
                continue
            if any(_pinning_expr(a, aliases, pinned, pin_calls) for a in operands):
                continue
            out.append(
                Finding(
                    src.path, node.lineno, node.col_offset, RULES["GC802"],
                    f"{kind} under bf16 entry {entry.name!r} without an fp32 pin",
                    _HINT_802, trace,
                )
            )
    return out


# --- GC803 cast discipline --------------------------------------------------

_CAST_SCOPE_PATTERNS = ("models/*/extract_*.py",)
_FRAME_PIECES = frozenset(
    {
        "frame", "frames", "clip", "clips", "img", "imgs", "image", "images",
        "video", "videos", "rgb", "flow", "pair", "pairs", "pixels", "stack",
        "stacks", "crop", "crops",
    }
)
_NP_WRAPPERS = frozenset(
    {
        "numpy.asarray", "numpy.array", "numpy.stack", "numpy.concatenate",
        "numpy.ascontiguousarray",
    }
)


def _frameish(name: str) -> bool:
    return any(p in _FRAME_PIECES for p in name.lower().split("_"))


def _is_host_f32(node: ast.AST, aliases: Dict[str, str]) -> bool:
    """float32 spelled as a dtype: ``np.float32``, ``torch.float32``, a
    string."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value in ("float32", "f4", "<f4", ">f4")
    rd = resolve_dotted(node, aliases)
    return rd in ("numpy.float32", "numpy.single", "float32", "torch.float32",
                  "torch.float")


def _frameish_locals(fn: ast.FunctionDef) -> Set[str]:
    local: Set[str] = {p for p in param_names(fn) if _frameish(p)}

    def mentions(node: ast.AST) -> bool:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) and (
                _frameish(sub.id) or sub.id in local
            ):
                return True
            if isinstance(sub, ast.Attribute) and _frameish(sub.attr):
                return True
        return False

    for _ in range(2):
        changed = False
        for node in _own_nodes(fn):
            targets: List[ast.AST] = []
            if isinstance(node, (ast.For, ast.AsyncFor)):
                if mentions(node.iter):
                    targets = [node.target]
            elif isinstance(node, ast.comprehension):
                if mentions(node.iter):
                    targets = [node.target]
            elif isinstance(node, ast.Assign):
                if node.value is not None and mentions(node.value):
                    targets = list(node.targets)
            for tgt in targets:
                for n in _target_names(tgt):
                    if n not in local:
                        local.add(n)
                        changed = True
        if not changed:
            break
    return local


def _check_cast_discipline(
    ctx: _Ctx, project: ProjectTaint, model_reach: Set[str]
) -> List[Finding]:
    out: List[Finding] = []
    for src in ctx.sources:
        in_scope = src.is_hot or any(
            fnmatch.fnmatch(src.rel, p) for p in _CAST_SCOPE_PATTERNS
        )
        if not in_scope:
            continue
        aliases = ctx.aliases[src.rel]
        for key, info in ctx.graph.functions.items():
            if info.src is not src or key in model_reach:
                continue  # a module's forward side casts on the card
            if ISLAND_TOKEN in _def_tokens(src, info.node):
                continue
            frameish = _frameish_locals(info.node)
            env = project.env_for(key)

            def is_frame_expr(node: ast.AST) -> bool:
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Name) and (
                        _frameish(sub.id) or sub.id in frameish
                    ):
                        return True
                    if isinstance(sub, ast.Attribute) and _frameish(sub.attr):
                        return True
                return False

            for node in _own_nodes(info.node):
                if not isinstance(node, ast.Call):
                    continue
                recv: Optional[ast.AST] = None
                func = node.func
                if isinstance(func, ast.Attribute) and (
                    (func.attr == "float" and not node.args)
                    or (
                        func.attr in ("astype", "to", "type")
                        and any(
                            _is_host_f32(a, aliases)
                            for a in list(node.args[:1])
                            + [kw.value for kw in node.keywords if kw.arg == "dtype"]
                        )
                    )
                ):
                    recv = func.value
                else:
                    rd = resolve_dotted(func, aliases)
                    if rd in _NP_WRAPPERS and node.args:
                        dt = next(
                            (kw.value for kw in node.keywords if kw.arg == "dtype"),
                            node.args[1] if len(node.args) > 1 else None,
                        )
                        if dt is not None and _is_host_f32(dt, aliases):
                            recv = node.args[0]
                if recv is None or not is_frame_expr(recv):
                    continue
                if _islanded(src, None, node.lineno):
                    continue
                if project.expr_taint(recv, env, src, info).device:
                    continue  # device value: the cast runs on the card
                out.append(
                    Finding(
                        src.path, node.lineno, node.col_offset, RULES["GC803"],
                        "host-side float32 cast on a frame payload in "
                        f"{info.name!r}: 4x the uint8 wire bytes over H2D",
                        _HINT_803,
                    )
                )
    return out


# --- GC804 parity-pin coverage ----------------------------------------------

ADMISSION_TABLE_NAME = "LOW_PRECISION_MODEL_FAMILIES"
CEILINGS_TABLE_NAME = "PARITY_CEILINGS"
E2E_TEST_BASENAME = "test_torch_bfloat16.py"
_PARITY_ASSERT_TOKENS = ("assert_drift_within", "max_rel_drift")


def _parse_admissions(st: ast.Assign) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    if not isinstance(st.value, ast.Dict):
        return out
    for k, v in zip(st.value.keys, st.value.values):
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
            continue
        fams: List[str] = []
        if isinstance(v, (ast.Tuple, ast.List, ast.Set)):
            for el in v.elts:
                if isinstance(el, ast.Constant) and isinstance(el.value, str):
                    fams.append(el.value)
        out[k.value] = fams
    return out


def _parse_ceilings(st: ast.Assign) -> Dict[Tuple[str, str, str], object]:
    """``{(family, dtype, kind): max_rel}`` from the literal dict."""
    out: Dict[Tuple[str, str, str], object] = {}
    if not isinstance(st.value, ast.Dict):
        return out
    for k, v in zip(st.value.keys, st.value.values):
        if not (isinstance(k, ast.Tuple) and len(k.elts) == 3):
            continue
        parts = [e.value for e in k.elts if isinstance(e, ast.Constant)]
        if len(parts) != 3 or not all(isinstance(p, str) for p in parts):
            continue
        out[tuple(parts)] = v.value if isinstance(v, ast.Constant) else None
    return out


def _tests_dirs(anchor: str) -> List[str]:
    cands = [
        os.path.join(anchor, "tests"),
        os.path.normpath(os.path.join(anchor, "..", "tests")),
        os.path.normpath(os.path.join(package_root(), "..", "tests")),
    ]
    # nearest existing dir only: a project that carries its own tests/
    # next to the analyzed file is judged by those tests
    for c in cands:
        if os.path.isdir(c):
            return [c]
    return []


_TESTS_TEXT_CACHE: Dict[str, List[Tuple[str, str]]] = {}
_TESTS_TEXT_LOCK = threading.Lock()


def _tests_texts(dirs: Sequence[str]) -> List[Tuple[str, str]]:
    """(basename, text) of every .py file under ``dirs``."""
    texts: List[Tuple[str, str]] = []
    with _TESTS_TEXT_LOCK:
        for d in dirs:
            if d not in _TESTS_TEXT_CACHE:
                blobs: List[Tuple[str, str]] = []
                try:
                    names = sorted(os.listdir(d))
                except OSError:
                    names = []
                for fn in names:
                    if not fn.endswith(".py"):
                        continue
                    try:
                        with open(
                            os.path.join(d, fn), "r", encoding="utf-8"
                        ) as fh:
                            blobs.append((fn, fh.read()))
                    except OSError:
                        continue
                _TESTS_TEXT_CACHE[d] = blobs
            texts.extend(_TESTS_TEXT_CACHE[d])
    return texts


def _check_parity_coverage(sources: Sequence[SourceFile]) -> List[Finding]:
    cfg = next((s for s in sources if s.rel == "config.py"), None)
    if cfg is None:
        return []
    table: Optional[ast.Assign] = None
    ceilings_st: Optional[ast.Assign] = None
    admitted: Dict[str, List[str]] = {}
    for st in cfg.tree.body:
        if not isinstance(st, ast.Assign):
            continue
        names = {t.id for t in st.targets if isinstance(t, ast.Name)}
        if ADMISSION_TABLE_NAME in names:
            table = st
            admitted = _parse_admissions(st)
        if CEILINGS_TABLE_NAME in names:
            ceilings_st = st
    out: List[Finding] = []

    def emit(line: int, msg: str) -> None:
        out.append(Finding(cfg.path, line, 0, RULES["GC804"], msg, _HINT_804))

    if table is None:
        # only meaningful for a config that really carries the dtype axis
        if "--dtype" in cfg.text:
            emit(
                1,
                f"config.py admits --dtype values but declares no "
                f"{ADMISSION_TABLE_NAME} table for GC804 to check",
            )
        return out
    if ceilings_st is None:
        emit(
            table.lineno,
            f"{ADMISSION_TABLE_NAME} admits low-precision dtypes but config.py "
            f"declares no {CEILINGS_TABLE_NAME}",
        )
        return out
    ceilings = _parse_ceilings(ceilings_st)
    tests = [
        txt for name, txt in _tests_texts(_tests_dirs(os.path.dirname(cfg.path)))
        if name == E2E_TEST_BASENAME
    ]
    for dtype, fams in admitted.items():
        for fam in fams:
            bounded = any(
                f == fam and d == dtype and isinstance(v, (int, float))
                and not isinstance(v, bool)
                for (f, d, _), v in ceilings.items()
            )
            if not bounded:
                emit(
                    table.lineno,
                    f"admitted ({fam!r}, {dtype!r}) has no numeric ceiling in "
                    f"{CEILINGS_TABLE_NAME}",
                )
                continue
            asserted = any(
                any(tok in txt for tok in _PARITY_ASSERT_TOKENS)
                and (f'"{fam}"' in txt or f"'{fam}'" in txt)
                for txt in tests
            )
            if not asserted:
                emit(
                    table.lineno,
                    f"admitted ({fam!r}, {dtype!r}) has a ceiling but no case "
                    f"of tests/{E2E_TEST_BASENAME} asserts it "
                    f"({'/'.join(_PARITY_ASSERT_TOKENS)})",
                )
    for (fam, dtype, kind) in sorted(ceilings):
        if fam not in admitted.get(dtype, ()):
            emit(
                ceilings_st.lineno,
                f"orphan ceiling ({fam!r}, {dtype!r}, {kind!r}): "
                f"{ADMISSION_TABLE_NAME} no longer admits it",
            )
    return out


# --- GC805 kernel hygiene ---------------------------------------------------

_ACCUM_NAME = re.compile(r"^(acc\w*|\w*_acc|sum\w*|\w*_sum)$")
_CU_DECL = re.compile(
    r"\b(float|double|__nv_bfloat16|__half|half|nv_bfloat16|T)\s+"
    r"(\w+)\s*(\[|=|;|\{)"
)
_NARROW = ("__nv_bfloat16", "__half", "half", "nv_bfloat16", "T")


def _marked_wrappers(ctx: _Ctx) -> List[FunctionInfo]:
    return [
        info for info in ctx.graph.functions.values()
        if KERNEL_MARKER in _def_tokens(info.src, info.node)
    ]


def _is_twin_name(name: str) -> bool:
    low = name.lower()
    return low.endswith("_reference") or "plain" in low or low.endswith("_ref")


def _module_kernel_names(src: SourceFile, aliases: Dict[str, str]) -> List[Tuple[str, int]]:
    """(csrc name, line) of every ``kernels.load("<name>")`` in the file."""
    out: List[Tuple[str, int]] = []
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call):
            continue
        rd = resolve_dotted(node.func, aliases) or ""
        if (
            rd.endswith("kernels.load")
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            out.append((node.args[0].value, node.lineno))
    return out


def _counts_launches(src: SourceFile, aliases: Dict[str, str], name: str) -> bool:
    """``<name>.launches = 0`` at module level and a
    ``kernels.count_launch(<name>)`` (or ``<name>.launches += 1``)."""
    declared = counted = False
    for st in src.tree.body:
        if isinstance(st, ast.Assign):
            for t in st.targets:
                if (
                    isinstance(t, ast.Attribute)
                    and t.attr == "launches"
                    and isinstance(t.value, ast.Name)
                    and t.value.id == name
                ):
                    declared = True
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Call):
            rd = resolve_dotted(node.func, aliases) or ""
            if (
                rd.endswith("count_launch")
                and node.args
                and isinstance(node.args[0], ast.Name)
                and node.args[0].id == name
            ):
                counted = True
        elif isinstance(node, ast.AugAssign):
            t = node.target
            if (
                isinstance(t, ast.Attribute)
                and t.attr == "launches"
                and isinstance(t.value, ast.Name)
                and t.value.id == name
            ):
                counted = True
    return declared and counted


def _scan_cu(text: str) -> Tuple[bool, List[Tuple[int, str, str]]]:
    """(instantiates bf16, [(line, type, name)] of narrow accumulators)."""
    bf16 = "__nv_bfloat16" in text or "nv_bfloat16" in text
    narrow: List[Tuple[int, str, str]] = []
    floats = 0
    for i, line in enumerate(text.splitlines(), 1):
        code = line.split("//", 1)[0]
        for m in _CU_DECL.finditer(code):
            typ, name = m.group(1), m.group(2)
            if not _ACCUM_NAME.match(name):
                continue
            if typ in _NARROW:
                narrow.append((i, typ, name))
            elif typ == "float":
                floats += 1
    if bf16 and not floats and not narrow:
        narrow.append((0, "", ""))  # bf16 with no float accumulator at all
    return bf16, narrow


def _check_kernels(ctx: _Ctx) -> List[Finding]:
    out: List[Finding] = []
    graph = ctx.graph
    texts_cache: Dict[str, List[Tuple[str, str]]] = {}
    for wrapper in _marked_wrappers(ctx):
        src = wrapper.src
        aliases = ctx.aliases[src.rel]
        node = wrapper.node

        def emit(msg: str, trace: Optional[List[str]] = None) -> None:
            out.append(Finding(src.path, node.lineno, node.col_offset,
                               RULES["GC805"], msg, _HINT_805, trace or []))

        # (1) built through ops/kernels.py from a csrc source
        loads = _module_kernel_names(src, aliases)
        csrc = os.path.join(os.path.dirname(os.path.dirname(src.path)), "csrc")
        if not loads:
            emit(f"kernel wrapper {wrapper.name!r}'s module builds no kernel "
                 "through kernels.load(<csrc name>)")
        for name, line in loads:
            cu = os.path.join(csrc, f"{name}.cu")
            if not os.path.isfile(cu):
                emit(f"kernels.load({name!r}) names no csrc/{name}.cu",
                     [f"{src.path}:{line}: kernels.load({name!r})"])
                continue
            try:
                with open(cu, "r", encoding="utf-8") as fh:
                    text = fh.read()
            except OSError as e:
                emit(f"unreadable csrc/{name}.cu: {e}")
                continue
            bf16, narrow = _scan_cu(text)
            for ln, typ, var in narrow:
                if not ln:
                    emit(f"csrc/{name}.cu instantiates bf16 but declares no float "
                         "accumulator", [f"{cu}:1: no float acc*/sum* declaration"])
                else:
                    emit(f"csrc/{name}.cu accumulates {var!r} in {typ}"
                         + (" (the bf16 instantiation's input dtype)" if typ == "T"
                            else ""),
                         [f"{cu}:{ln}: {typ} {var}"])
        # (2) a launches counter
        if not _counts_launches(src, aliases, wrapper.name):
            emit(f"kernel wrapper {wrapper.name!r} keeps no launches counter "
                 f"({wrapper.name}.launches = 0 and "
                 f"kernels.count_launch({wrapper.name}))")
        # (3) a plain twin, named by the wrapper or by a dispatcher calling it
        dispatchers = [wrapper.key] + [
            site.caller for site in graph.callers.get(wrapper.key, ())
            if site.caller in graph.functions
        ]
        twins: Set[str] = set()
        for d in dispatchers:
            for _, cks in ctx.succs.get(d, ()):
                for ck in cks:
                    if _is_twin_name(graph.functions[ck].name):
                        twins.add(ck)
        if not twins:
            emit(f"kernel wrapper {wrapper.name!r} names no plain twin "
                 "(a *_reference def its dispatcher calls on a CPU tensor)")
        # (4) no fallback: a try around the kernel that calls the twin
        for d in dispatchers + [c for _, cks in ctx.succs.get(wrapper.key, ())
                                for c in cks]:
            info = graph.functions.get(d)
            if info is None:
                continue
            for st in _own_nodes(info.node):
                if not isinstance(st, ast.Try):
                    continue
                for h in st.handlers:
                    for sub in ast.walk(h):
                        if not isinstance(sub, ast.Call):
                            continue
                        cks = _exact_callees(sub.func, info.src, info, graph)
                        if any(c in twins for c in cks):
                            out.append(Finding(
                                info.src.path, sub.lineno, sub.col_offset,
                                RULES["GC805"],
                                f"{info.name!r} catches a kernel failure to call "
                                f"the plain twin: a CUDA tensor must launch "
                                f"{wrapper.name!r} or raise",
                                _HINT_805,
                                [f"{info.src.path}:{st.lineno}: try around the kernel"],
                            ))
        # (5) a cuda-marked test holding the kernel against its twin
        dirs = _tests_dirs(os.path.dirname(src.path))
        key = "|".join(dirs)
        if key not in texts_cache:
            texts_cache[key] = _tests_texts(dirs)
        twin_names = {graph.functions[t].name for t in twins}
        tested = any(
            "mark.cuda" in txt and wrapper.name in txt
            and any(t in txt for t in twin_names)
            for _, txt in texts_cache[key]
        )
        if twins and not tested:
            emit(f"no pytest.mark.cuda test holds {wrapper.name!r} against "
                 f"{sorted(twin_names)[0]!r} under tests/")
    return out


# --- family entry -----------------------------------------------------------

def check(
    sources: Sequence[SourceFile], graph: CallGraph, project: ProjectTaint
) -> List[Finding]:
    ctx = _Ctx(sources, graph, project)
    findings: List[Finding] = []
    findings.extend(_check_promotion(ctx, _forward_roots(ctx)))
    findings.extend(_check_accum(ctx))
    forwards = [k for k, f in graph.functions.items() if ctx.is_module_forward(f)]
    findings.extend(_check_cast_discipline(ctx, project, set(ctx.reach(forwards))))
    findings.extend(_check_parity_coverage(sources))
    findings.extend(_check_kernels(ctx))
    return findings
