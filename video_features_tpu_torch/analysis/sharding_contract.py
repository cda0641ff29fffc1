"""GC505 — mesh admission coverage for the port's ``--sharding mesh``.

Counterpart of the GC505 rule of
``video_features_tpu/analysis/sharding_contract.py``, retargeted at the
port's mesh path. Every feature type that the port's ``config.py``
admits for ``--sharding mesh`` (the config admits the mesh for every
type in ``FEATURE_TYPES``, and ``MESH_DEVICE_PREPROCESS_FEATURE_TYPES``
also under ``--preprocess device``) must map, through
``extract/registry.py``'s dispatch chain, to an extractor module (or a
module of ``models/`` it directly imports) that reaches the port's mesh
path: ``parallel/sharding.py``'s ``split_rows``, ``halo_split``,
``temporal_halo`` or ``replicate``, ``I3D.forward_sharded``, or
``ShardedVisionTransformer``. Admitting a type whose extractor never
touches the mesh would let ``sanity_check`` wave through a config the
runtime runs on one device.

GC501-504 are left out: they read the ``in_shardings``/``out_shardings``
of ``jax.jit`` applications, and the port has no jit; its mesh is the
explicit row split above.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence

from video_features_tpu_torch.analysis.callgraph import CallGraph
from video_features_tpu_torch.analysis.core import (
    Finding,
    Rule,
    SourceFile,
    import_aliases,
    resolve_dotted,
)

RULES = {
    "GC505": Rule(
        "GC505", "mesh-admission-coverage",
        "a feature type admitted for --sharding mesh has an extractor "
        "module that never reaches the port's mesh path",
    ),
}

# the mesh path: parallel/sharding.py's row splits and replication, and
# the two models with a sharded forward of their own
_MESH_FUNCTIONS = ("split_rows", "halo_split", "temporal_halo", "replicate")
_MESH_ATTRS = ("forward_sharded",)
_MESH_CLASSES = ("ShardedVisionTransformer",)


def check(sources: Sequence[SourceFile], graph: CallGraph) -> List[Finding]:
    return _check_admission(sources, graph)


def _eval_strings(expr: ast.AST,
                  consts: Dict[str, List[str]]) -> Optional[List[str]]:
    """Mini-evaluator for the config string-list idiom: literal lists,
    ``A + B`` concatenation, ``list(NAME)`` copies, and names bound to
    earlier string lists. None when any part is dynamic."""
    if isinstance(expr, (ast.List, ast.Tuple)):
        out: List[str] = []
        for e in expr.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                out.append(e.value)
            else:
                return None
        return out
    if isinstance(expr, ast.Name):
        return consts.get(expr.id)
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        left = _eval_strings(expr.left, consts)
        right = _eval_strings(expr.right, consts)
        if left is not None and right is not None:
            return left + right
        return None
    if (
        isinstance(expr, ast.Call)
        and isinstance(expr.func, ast.Name)
        and expr.func.id == "list"
        and len(expr.args) == 1
        and not expr.keywords
    ):
        return _eval_strings(expr.args[0], consts)
    return None


def _string_consts(src: SourceFile) -> Dict[str, List[str]]:
    consts: Dict[str, List[str]] = {}
    for st in src.tree.body:
        if (
            isinstance(st, ast.Assign)
            and len(st.targets) == 1
            and isinstance(st.targets[0], ast.Name)
        ):
            val = _eval_strings(st.value, consts)
            if val is not None:
                consts[st.targets[0].id] = val
    return consts


def _admitted_types(cfg: SourceFile,
                    consts: Dict[str, List[str]]) -> tuple:
    """The types admitted for ``--sharding mesh``, and the line to
    report at: ``MESH_FEATURE_TYPES`` where config.py declares one, else
    every type of ``FEATURE_TYPES``; with those admitted under
    ``--preprocess device`` (``MESH_DEVICE_PREPROCESS_FEATURE_TYPES``)."""
    lines: Dict[str, int] = {}
    for st in cfg.tree.body:
        if (
            isinstance(st, ast.Assign)
            and len(st.targets) == 1
            and isinstance(st.targets[0], ast.Name)
        ):
            lines[st.targets[0].id] = st.lineno
    out: List[str] = []
    line = 0
    for name in ("MESH_FEATURE_TYPES" if "MESH_FEATURE_TYPES" in lines
                 else "FEATURE_TYPES", "MESH_DEVICE_PREPROCESS_FEATURE_TYPES"):
        for ft in consts.get(name, []):
            if ft not in out:
                out.append(ft)
        if name in lines and not line:
            line = lines[name]
    return out, line


def _test_feature_types(test: ast.AST,
                        consts: Dict[str, List[str]]) -> List[str]:
    """Feature strings admitted by one registry dispatch test:
    ``ft == "raft"``, ``ft in CLIP_FEATURE_TYPES``, or an ``or`` of those."""
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.Or):
        out: List[str] = []
        for v in test.values:
            out.extend(_test_feature_types(v, consts))
        return out
    if isinstance(test, ast.Compare) and len(test.ops) == 1:
        right = test.comparators[0]
        if (
            isinstance(test.ops[0], ast.Eq)
            and isinstance(right, ast.Constant)
            and isinstance(right.value, str)
        ):
            return [right.value]
        if isinstance(test.ops[0], ast.In):
            return _eval_strings(right, consts) or []
    return []


def _registry_modules(reg: SourceFile,
                      consts: Dict[str, List[str]]) -> Dict[str, str]:
    """feature type -> extractor module dotted path, from the lazy-import
    dispatch chain in extract/registry.py."""
    out: Dict[str, str] = {}
    for node in ast.walk(reg.tree):
        if not isinstance(node, ast.If):
            continue
        fts = _test_feature_types(node.test, consts)
        if not fts:
            continue
        mod = None
        for st in node.body:
            if isinstance(st, ast.ImportFrom) and st.module:
                mod = st.module
                break
        if mod is None:
            continue
        for ft in fts:
            out.setdefault(ft, mod)
    return out


def _direct_imports(src: SourceFile, graph: CallGraph) -> List[SourceFile]:
    out: List[SourceFile] = []
    seen = {src.rel}
    for node in ast.walk(src.tree):
        mods: List[str] = []
        if isinstance(node, ast.ImportFrom) and node.module:
            mods.append(node.module)
        elif isinstance(node, ast.Import):
            mods.extend(a.name for a in node.names)
        for m in mods:
            hit = graph.resolve_module(m)
            if hit is not None and hit.rel not in seen:
                seen.add(hit.rel)
                out.append(hit)
    return out


def _reaches_mesh(src: SourceFile, cache: Dict[str, bool]) -> bool:
    """Whether the module names the mesh path: a ``parallel.sharding``
    split or ``replicate``, ``forward_sharded``, or the sharded ViT."""
    hit = cache.get(src.rel)
    if hit is None:
        aliases = import_aliases(src.tree)
        hit = False
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Attribute) and node.attr in _MESH_ATTRS:
                hit = True
            elif isinstance(node, (ast.Name, ast.Attribute)):
                rd = resolve_dotted(node, aliases) or ""
                head, _, last = rd.rpartition(".")
                if (last in _MESH_FUNCTIONS and head.endswith("sharding")) or (
                    last in _MESH_CLASSES
                ):
                    hit = True
            if hit:
                break
        cache[src.rel] = hit
    return hit


def _check_admission(sources: Sequence[SourceFile],
                     graph: CallGraph) -> List[Finding]:
    by_rel = {s.rel: s for s in sources}
    cfg = by_rel.get("config.py")
    reg = by_rel.get("extract/registry.py")
    if cfg is None or reg is None:
        return []  # single-file run: the admission facts are out of view
    consts = _string_consts(cfg)
    admitted, line = _admitted_types(cfg, consts)
    if not admitted:
        return []
    consts.update(_string_consts(reg))
    mapping = _registry_modules(reg, consts)
    cache: Dict[str, bool] = {}
    findings: List[Finding] = []
    for ft in admitted:
        mod = mapping.get(ft)
        if mod is None:
            continue  # dispatch not statically resolvable — never guess
        target = graph.resolve_module(mod)
        if target is None:
            continue  # extractor module outside this sweep
        if _reaches_mesh(target, cache) or any(
            _reaches_mesh(m, cache)
            for m in _direct_imports(target, graph)
            if m.rel.startswith("models/")
        ):
            continue
        findings.append(
            Finding(
                cfg.path, line, 0, RULES["GC505"],
                f"feature type {ft!r} is admitted for --sharding mesh but its "
                f"extractor module {mod!r} never reaches the mesh path "
                f"(split_rows/halo_split/temporal_halo/replicate, "
                f"forward_sharded, ShardedVisionTransformer) — sanity_check "
                f"would wave through a config the runtime runs on one device",
                "split the family's rows over the mesh (parallel/sharding.py) "
                "before admitting it, or refuse it for --sharding mesh in "
                "config.py",
            )
        )
    return findings
