"""GC70x — observability contracts: every signal is real, end to end.

The serving story leans on three cross-module naming contracts that
nothing enforced statically:

- **GC701 metric-exposition-contract** — registry series names
  (``metrics.inc("frames_decoded")``, ``set_gauge(f"queue_depth.{q}")``)
  must map onto a curated exposition family in
  ``telemetry/exposition.py::families_from_snapshot`` — matched against
  the conventions that function itself encodes (``name.startswith(...)``
  prefixes, ``name == ...`` exacts, ``name in _PLAIN_*`` tables). A name
  that only hits the sanitized fallback renders with auto-generated
  HELP/TYPE — /metrics shows it, but no dashboard was ever told it
  exists. The reverse direction is checked too: a convention with no
  producer anywhere in the sweep is an orphaned family (dead dashboards,
  or a producer renamed out from under them). Producers resolve through
  constant strings, f-strings with constant heads, name-building helpers
  (``group_service_metric``) and single-registry-call forwarders
  (``self._count("requests_admitted")``).
- **GC702 fault-stage-contract** — every constant-stage ``fire("...")``
  site must name a stage declared in ``runtime/faults.py::STAGES``, and
  every declared stage must have at least one fire site: a dead stage
  rots the chaos matrix (drills "cover" a stage no code path can hit).
- **GC703 config-flag-contract** — ``config.py``: every ``add_argument``
  dest is a field of some config dataclass (or consumed by a module
  function), every field is settable (a flag dest, or an explicit
  constructor kwarg in a parse wrapper), every free-form flag (no
  ``choices``, no non-str ``type``, not boolean) is touched by a
  ``sanity_check*`` function, and every attribute a sanity function
  touches is a real field — the typo direction.

All three are pure-AST and cross-module: a contract side missing from
the sweep (running graftcheck on a subdirectory without exposition.py /
faults.py / config.py) skips that rule rather than reporting one-sided
orphans. Findings carry the contract's defining line in ``trace``
(``--explain GC701``).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from video_features_tpu_torch.analysis.core import (
    Finding,
    Rule,
    SourceFile,
    dotted_name,
    import_aliases,
    resolve_dotted,
)

RULES = {
    "GC701": Rule(
        "GC701", "metric-exposition-contract",
        "a registry metric name maps to no curated exposition family "
        "(sanitized-fallback HELP/TYPE), or a family has no producer",
    ),
    "GC702": Rule(
        "GC702", "fault-stage-contract",
        "a fire() site uses an undeclared fault stage, or a declared "
        "stage has no fire site (dead chaos coverage)",
    ),
    "GC703": Rule(
        "GC703", "config-flag-contract",
        "an argparse flag, config dataclass field, and sanity check "
        "disagree: orphan flag/field, unvalidated free-form flag, or a "
        "sanity touch on a non-field",
    ),
}

_REGISTRY_METHODS = ("inc", "set_gauge", "observe")


# -- name specs ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Spec:
    """A statically-known metric name: exact, or a constant prefix of an
    f-string (``f"stage_s.{stage}"`` -> prefix ``stage_s.``)."""

    text: str
    is_prefix: bool

    def matches_token(self, token: str, token_is_prefix: bool) -> bool:
        if not self.is_prefix and not token_is_prefix:
            return self.text == token
        if not self.is_prefix:  # exact name vs prefix convention
            return token_is_prefix and self.text.startswith(token)
        if not token_is_prefix:  # prefix producer vs exact convention
            return token.startswith(self.text)
        return self.text.startswith(token) or token.startswith(self.text)


def _spec_of(expr: ast.AST) -> Optional[_Spec]:
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return _Spec(expr.value, False)
    if isinstance(expr, ast.JoinedStr) and expr.values:
        head = expr.values[0]
        if isinstance(head, ast.Constant) and isinstance(head.value, str):
            if len(expr.values) == 1:
                return _Spec(head.value, False)
            return _Spec(head.value, True)
    return None


def _return_spec(fn: ast.FunctionDef) -> Optional[_Spec]:
    """The spec of a helper that builds metric names: a single constant
    or constant-headed f-string return."""
    specs = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and node.value is not None:
            specs.append(_spec_of(node.value))
    live = [s for s in specs if s is not None]
    return live[0] if len(live) == len(specs) == 1 else None


# -- GC701 ---------------------------------------------------------------


def _find_exposition(sources: Sequence[SourceFile]) -> Optional[
    Tuple[SourceFile, ast.FunctionDef]
]:
    for src in sources:
        for node in src.tree.body:
            if isinstance(node, ast.FunctionDef) and node.name == "families_from_snapshot":
                return src, node
    return None


def _module_str_collections(src: SourceFile) -> Dict[str, List[Tuple[str, int]]]:
    """Module-level ``NAME = {...}/(...)`` literals of string keys, for
    ``name in _PLAIN_COUNTERS`` membership conventions."""
    out: Dict[str, List[Tuple[str, int]]] = {}
    for st in src.tree.body:
        if not (isinstance(st, ast.Assign) and len(st.targets) == 1):
            continue
        target = st.targets[0]
        if not isinstance(target, ast.Name):
            continue
        keys: List[Tuple[str, int]] = []
        if isinstance(st.value, ast.Dict):
            elts = st.value.keys
        elif isinstance(st.value, (ast.Set, ast.Tuple, ast.List)):
            elts = st.value.elts
        else:
            continue
        for el in elts:
            if isinstance(el, ast.Constant) and isinstance(el.value, str):
                keys.append((el.value, el.lineno))
        if keys:
            out[target.id] = keys
    return out


def _conventions(
    src: SourceFile, fn: ast.FunctionDef
) -> List[Tuple[str, bool, int]]:
    """(token, is_prefix, defining line) for every naming convention the
    exposition mapper encodes — startswith prefixes, == exacts, and
    membership in a module-level string table."""
    tables = _module_str_collections(src)
    out: List[Tuple[str, bool, int]] = []
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "startswith"
            and isinstance(node.func.value, ast.Name)
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            out.append((node.args[0].value, True, node.lineno))
        elif isinstance(node, ast.Compare) and len(node.ops) == 1:
            left, op, right = node.left, node.ops[0], node.comparators[0]
            if not isinstance(left, ast.Name):
                continue
            if isinstance(op, ast.Eq) and isinstance(right, ast.Constant) and isinstance(right.value, str):
                out.append((right.value, False, node.lineno))
            elif isinstance(op, ast.In) and isinstance(right, ast.Name):
                for key, line in tables.get(right.id, ()):
                    out.append((key, False, line))
    return out


def _receiver_text(func: ast.Attribute) -> str:
    parts: List[str] = []
    node: ast.AST = func.value
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(parts)


def _name_helpers(sources: Sequence[SourceFile]) -> Dict[str, _Spec]:
    """Project functions (unique by bare name) whose return is a metric
    name spec — ``group_service_metric`` style builders."""
    defs: Dict[str, List[ast.FunctionDef]] = {}
    for src in sources:
        for node in src.tree.body:
            if isinstance(node, ast.FunctionDef):
                defs.setdefault(node.name, []).append(node)
    out: Dict[str, _Spec] = {}
    for name, fns in defs.items():
        if len(fns) != 1:
            continue
        spec = _return_spec(fns[0])
        if spec is not None:
            out[name] = spec
    return out


def _forwarders(sources: Sequence[SourceFile]) -> Dict[str, int]:
    """Functions whose body forwards a parameter straight into a registry
    call (``def _count(self, name): ...metrics.inc(name)``): bare name ->
    positional index of the forwarded parameter at the call site."""
    defs: Dict[str, List[Tuple[ast.FunctionDef, int]]] = {}
    for src in sources:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.FunctionDef):
                continue
            params = [a.arg for a in node.args.args]
            for sub in ast.walk(node):
                if (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in _REGISTRY_METHODS
                    and sub.args
                    and isinstance(sub.args[0], ast.Name)
                    and sub.args[0].id in params
                ):
                    idx = params.index(sub.args[0].id)
                    if params[:1] == ["self"]:
                        idx -= 1
                    if idx >= 0:
                        defs.setdefault(node.name, []).append((node, idx))
    return {
        name: hits[0][1] for name, hits in defs.items() if len(hits) == 1
    }


def _check_metrics(sources: Sequence[SourceFile]) -> List[Finding]:
    hit = _find_exposition(sources)
    if hit is None:
        return []
    expo_src, expo_fn = hit
    conventions = _conventions(expo_src, expo_fn)
    if not conventions:
        return []
    helpers = _name_helpers(sources)
    forwarders = _forwarders(sources)

    producers: List[Tuple[_Spec, SourceFile, ast.Call]] = []
    for src in sources:
        if src.rel.startswith("analysis/"):
            continue
        for node in ast.walk(src.tree):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
                continue
            spec: Optional[_Spec] = None
            if node.func.attr in _REGISTRY_METHODS and node.args:
                if (
                    node.func.attr == "observe"
                    and "metrics" not in _receiver_text(node.func)
                ):
                    continue  # .observe() on a non-registry object
                arg = node.args[0]
                spec = _spec_of(arg)
                if spec is None and isinstance(arg, ast.Call):
                    inner = arg.func
                    iname = inner.attr if isinstance(inner, ast.Attribute) else (
                        inner.id if isinstance(inner, ast.Name) else None
                    )
                    if iname is not None:
                        spec = helpers.get(iname)
            else:
                fname = node.func.attr
                if fname in forwarders:
                    idx = forwarders[fname]
                    if idx < len(node.args):
                        spec = _spec_of(node.args[idx])
            if spec is not None:
                producers.append((spec, src, node))

    findings: List[Finding] = []
    for spec, src, node in producers:
        if src is expo_src:
            continue  # the mapper's own branches are not producers
        if not any(spec.matches_token(t, p) for t, p, _ in conventions):
            shown = f"{spec.text}*" if spec.is_prefix else spec.text
            findings.append(
                Finding(
                    src.path, node.lineno, node.col_offset, RULES["GC701"],
                    f"metric {shown!r} maps to no exposition family — "
                    "/metrics renders it through the sanitized fallback "
                    "with auto-generated HELP/TYPE",
                    "add a family convention for it in telemetry/"
                    "exposition.py families_from_snapshot (a _PLAIN_* "
                    "entry with real HELP text, or a labelled prefix "
                    "branch), or rename the series into an existing family",
                    trace=[
                        f"{expo_src.path}:{expo_fn.lineno}: conventions "
                        "extracted from families_from_snapshot",
                    ],
                )
            )
    if producers:
        for token, is_prefix, line in conventions:
            if not any(
                s.matches_token(token, is_prefix) for s, psrc, _ in producers
                if psrc is not expo_src
            ):
                shown = f"{token}*" if is_prefix else token
                findings.append(
                    Finding(
                        expo_src.path, line, 0, RULES["GC701"],
                        f"exposition family convention {shown!r} has no "
                        "producer anywhere in the sweep — an orphaned "
                        "family (dashboards chart a series nothing emits)",
                        "delete the dead branch, or wire the producer that "
                        "was renamed out from under it",
                    )
                )
    return findings


# -- GC702 ---------------------------------------------------------------


def _find_stages(sources: Sequence[SourceFile]) -> Optional[
    Tuple[SourceFile, ast.Assign, List[str]]
]:
    for src in sources:
        for st in src.tree.body:
            if (
                isinstance(st, ast.Assign)
                and len(st.targets) == 1
                and isinstance(st.targets[0], ast.Name)
                and st.targets[0].id == "STAGES"
                and isinstance(st.value, (ast.Tuple, ast.List))
            ):
                stages = [
                    el.value for el in st.value.elts
                    if isinstance(el, ast.Constant) and isinstance(el.value, str)
                ]
                if stages:
                    return src, st, stages
    return None


def _check_stages(sources: Sequence[SourceFile]) -> List[Finding]:
    hit = _find_stages(sources)
    if hit is None:
        return []
    stages_src, assign, stages = hit
    declared = set(stages)
    fired: Set[str] = set()
    findings: List[Finding] = []
    for src in sources:
        if src.rel.startswith("analysis/"):
            continue
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fname = None
            if isinstance(node.func, ast.Attribute):
                fname = node.func.attr
            elif isinstance(node.func, ast.Name):
                fname = node.func.id
            if fname != "fire":
                continue
            arg = node.args[0]
            if not (isinstance(arg, ast.Constant) and isinstance(arg.value, str)):
                continue
            stage = arg.value
            fired.add(stage)
            if stage not in declared:
                findings.append(
                    Finding(
                        src.path, node.lineno, node.col_offset, RULES["GC702"],
                        f"fire({stage!r}) uses a stage not declared in "
                        "STAGES — --fault_inject can never drill it and "
                        "parse-time validation rejects it",
                        "declare the stage in runtime/faults.py STAGES (and "
                        "give it chaos-drill coverage), or use an existing "
                        "stage name",
                        trace=[
                            f"{stages_src.path}:{assign.lineno}: STAGES "
                            "declared here",
                        ],
                    )
                )
    if fired:
        for stage in stages:
            if stage not in fired:
                findings.append(
                    Finding(
                        stages_src.path, assign.lineno, assign.col_offset,
                        RULES["GC702"],
                        f"stage {stage!r} is declared in STAGES but has no "
                        "fire() site — the chaos matrix claims coverage no "
                        "code path can hit",
                        "remove the dead stage, or add the fire() site at "
                        "the boundary it is supposed to drill",
                    )
                )
    return findings


# -- GC703 ---------------------------------------------------------------


@dataclasses.dataclass
class _Flag:
    flag: str
    dest: str
    node: ast.Call
    validated: bool  # parser-side constraint: choices / bool / non-str type


def _dataclass_defs(src: SourceFile, aliases) -> Dict[str, ast.ClassDef]:
    out: Dict[str, ast.ClassDef] = {}
    for st in src.tree.body:
        if not isinstance(st, ast.ClassDef):
            continue
        for dec in st.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            rd = resolve_dotted(target, aliases)
            if rd in ("dataclasses.dataclass", "dataclass"):
                out[st.name] = st
                break
    return out


def _class_fields(cls: ast.ClassDef) -> Dict[str, int]:
    fields: Dict[str, int] = {}
    for st in cls.body:
        if isinstance(st, ast.AnnAssign) and isinstance(st.target, ast.Name):
            fields[st.target.id] = st.lineno
    return fields


def _flags_of(src: SourceFile) -> List[_Flag]:
    out: List[_Flag] = []
    for node in ast.walk(src.tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "add_argument"
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
            and node.args[0].value.startswith("--")
        ):
            continue
        flag = node.args[0].value
        dest = flag[2:].replace("-", "_")
        validated = False
        for kw in node.keywords:
            if kw.arg == "dest" and isinstance(kw.value, ast.Constant):
                dest = str(kw.value.value)
            elif kw.arg == "choices":
                validated = True
            elif kw.arg == "action" and isinstance(kw.value, ast.Constant):
                if kw.value.value in ("store_true", "store_false", "count"):
                    validated = True
            elif kw.arg == "type":
                tname = dotted_name(kw.value)
                if tname is not None and tname != "str":
                    validated = True
        out.append(_Flag(flag, dest, node, validated))
    return out


def _check_config(sources: Sequence[SourceFile]) -> List[Finding]:
    src = next(
        (s for s in sources if s.rel.rsplit("/", 1)[-1] == "config.py"), None
    )
    if src is None:
        return []
    aliases = import_aliases(src.tree)
    dclasses = _dataclass_defs(src, aliases)
    flags = _flags_of(src)
    if not dclasses or not flags:
        return []

    all_fields: Dict[str, int] = {}
    methods: Set[str] = {"replace"}  # dataclasses.replace idiom
    for cls in dclasses.values():
        all_fields.update(_class_fields(cls))
        methods.update(
            st.name for st in cls.body
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef))
        )

    # attribute reads on any local/param name inside module functions —
    # the "consumed somewhere" evidence for leg (a)
    referenced: Set[str] = set()
    # attrs touched on the first param of sanity_check* functions, with
    # witness lines for the typo leg (d)
    sanity_touched: Dict[str, int] = {}
    ctor_kwargs: Set[str] = set()
    for fn in ast.walk(src.tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        params = [a.arg for a in fn.args.args]
        sanity_param = (
            params[0] if fn.name.startswith("sanity_check") and params else None
        )
        for node in ast.walk(fn):
            if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
                referenced.add(node.attr)
                if sanity_param is not None and node.value.id == sanity_param:
                    sanity_touched.setdefault(node.attr, node.lineno)
            elif isinstance(node, ast.Call):
                cname = None
                if isinstance(node.func, ast.Name):
                    cname = node.func.id
                elif isinstance(node.func, ast.Attribute):
                    cname = node.func.attr
                rd = resolve_dotted(node.func, aliases)
                if cname in dclasses or rd in ("dataclasses.replace",):
                    ctor_kwargs.update(
                        kw.arg for kw in node.keywords if kw.arg
                    )

    findings: List[Finding] = []
    dests = {f.dest for f in flags}
    for f in flags:
        if f.dest not in all_fields and f.dest not in referenced:
            findings.append(
                Finding(
                    src.path, f.node.lineno, f.node.col_offset, RULES["GC703"],
                    f"flag {f.flag} parses into dest {f.dest!r}, which is "
                    "neither a config dataclass field nor consumed by any "
                    "function in config.py — a flag users can set that "
                    "goes nowhere",
                    "add the matching dataclass field (and a sanity touch), "
                    "or delete the dead flag",
                )
            )
        elif f.dest in all_fields and not f.validated and f.dest not in sanity_touched:
            findings.append(
                Finding(
                    src.path, f.node.lineno, f.node.col_offset, RULES["GC703"],
                    f"free-form flag {f.flag} has no parser-side constraint "
                    "(choices/type/boolean action) and no sanity_check "
                    "touch — any junk value flows straight into the run",
                    "validate it in the sanity_check covering its dataclass "
                    "(even an empty-string/format guard), or constrain it "
                    "at the parser",
                )
            )
    for field, line in sorted(all_fields.items()):
        if field not in dests and field not in ctor_kwargs:
            findings.append(
                Finding(
                    src.path, line, 0, RULES["GC703"],
                    f"dataclass field {field!r} is neither any flag's dest "
                    "nor explicitly constructed in a parse wrapper — it "
                    "can never be set from the CLI",
                    "add the --flag for it, or construct it explicitly in "
                    "the parse wrapper so the wiring is visible",
                )
            )
    for attr, line in sorted(sanity_touched.items()):
        if attr not in all_fields and attr not in methods:
            findings.append(
                Finding(
                    src.path, line, 0, RULES["GC703"],
                    f"sanity check reads cfg.{attr}, which is not a field "
                    "or method of any config dataclass — a typo that makes "
                    "the check always crash or never run",
                    "fix the attribute name to the real field",
                )
            )
    return findings


# -- entry ---------------------------------------------------------------


def check(sources: Sequence[SourceFile]) -> List[Finding]:
    findings: List[Finding] = []
    findings.extend(_check_metrics(sources))
    findings.extend(_check_stages(sources))
    findings.extend(_check_config(sources))
    return findings
