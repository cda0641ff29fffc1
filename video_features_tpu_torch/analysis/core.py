"""graftcheck core: findings, waivers, the source-file model, the runner.

Counterpart of ``video_features_tpu/analysis/core.py``. The suite is
AST-based and import-free: every checker works on parsed source
(``ast`` + ``tokenize``), so ``python -m video_features_tpu_torch.analysis``
never executes the code it audits (a sweep of the port takes seconds).

Waiver contract: a ``# graftcheck: <token>[, <token>...] — reason``
comment on the offending line (or on a standalone comment line directly
above it) suppresses matching findings. A token matches a rule when it
equals the rule id (``GC301``) or is a prefix of the rule name
(``unlocked`` waives ``unlocked-global``; ``host-sync`` waives the whole
GC10x family). ``git grep 'graftcheck:'`` audits every waiver in one
sweep — that greppability is the reason waivers are inline comments and
not a config file.

File-level markers ride the same comment syntax (they declare facts,
they never waive findings — no marker token prefix-matches a rule name):

- ``# graftcheck: hot-module`` — opt a file into the host-sync lint's
  hot set beyond the built-in path patterns (used by test fixtures).
- ``# graftcheck: thread-root`` — declare a file a thread-spawning root
  for the thread-safety reachability walk.
- ``# graftcheck: cuda-kernel`` — on a kernel wrapper's def line (or
  the comment line above it): the def launches a hand-written CUDA
  kernel of ``csrc/``, and GC805 holds it to the port's kernel hygiene.
  The port's form of the JAX package's ``pallas-kernel`` marker.
- ``# graftcheck: bf16-entry`` — declare every def in the file (or, on
  a def line, that one def) a bf16-polymorphic entry for GC802.

The GC80x numerics family additionally reads the line/def-scoped
``# graftcheck: fp32-island — <why>`` declaration (docs/analysis.md).

Left out of the port's catalogue, with the modules that hold them in the
JAX package: GC20x (``jit_hygiene.py``; the port has no jit), GC401
(``compile_budget.py``; eager PyTorch compiles no shape) and GC501-504
(they read ``jax.jit`` shardings, which the port has none of).
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import io
import os
import tokenize
from typing import Dict, List, Optional, Sequence, Set


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str  # "GC101"
    name: str  # "host-sync-item"
    summary: str

    def matches_token(self, token: str) -> bool:
        t = token.strip().lower()
        if not t:
            return False
        return t == self.id.lower() or self.name.startswith(t)


@dataclasses.dataclass
class Finding:
    path: str
    line: int
    col: int
    rule: Rule
    message: str
    hint: str = ""
    # interprocedural provenance: "path:line: description" steps from the
    # origin (device creation, lock-free entry) to this finding's line.
    # ``--explain`` prints it; ``--json`` always carries it (may be []).
    trace: List[str] = dataclasses.field(default_factory=list)

    def format(self) -> str:
        s = f"{self.path}:{self.line}:{self.col}: {self.rule.id} {self.rule.name}: {self.message}"
        if self.hint:
            s += f"\n    fix: {self.hint}"
        return s

    def format_trace(self) -> str:
        lines = [self.format()]
        for step in self.trace:
            lines.append(f"    via: {step}")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, object]:
        return {
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "rule": self.rule.id,
            "name": self.rule.name,
            "message": self.message,
            "hint": self.hint,
            "trace": list(self.trace),
        }


# Paths (relative to the package root) the host-sync lint treats as the
# per-video hot loop: a device->host sync here stalls the dispatch
# pipeline once per video (or worse, once per frame batch). The JAX
# package's list, each entry matched against the port's tree.
HOT_MODULE_PATTERNS = (
    # the extraction loop: prepare, dispatch, the completion queue's
    # drain, the copy stream and HostCopy (ingest.py), the feature cache
    "extract/*.py",
    # the device preprocess, the attention cores and both kernel
    # wrappers, called once per frame batch or per layer
    "ops/*.py",
    # every family's forward, called once per group or stack
    "models/*/model.py",
    # the extractors' dispatch and fetch hooks, once per group: in the
    # port they place, preprocess and run on the card themselves (where
    # the JAX package's jit hides such work from a sync), and their
    # fetch_* side is the allowlisted boundary
    "models/*/extract_*.py",
    # telemetry records inside the per-video loops; a device sync or
    # unguarded global here would tax every video
    "runtime/telemetry.py",
    # the daemon's per-request path: admission, dispatch glue, lifecycle
    # writes — all on the serving fast path
    "serve/*.py",
    # the preflight probe runs once per admitted request/ingested video —
    # on the fast path by construction
    "io/probe.py",
)

# Thread-spawning roots for the thread-safety reachability walk: the
# modules that create or run on worker threads.
THREAD_ROOT_PATTERNS = (
    # queue mode's one worker thread per device
    "parallel/scheduler.py",
    # the decode pool, the retry timers and the pipelined loop
    "extract/base.py",
    # the copy stream's stager (extract/ingest.py::_Stager), shared by
    # the queue workers of one device, and HostCopy's events read by the
    # loop while decode workers run
    "extract/ingest.py",
    # the mesh's process group: initialize/shutdown and the collectives
    # run on the loop thread of a queue worker as well as the main one
    "parallel/distributed.py",
    "runtime/faults.py",
    # the telemetry drain thread
    "runtime/telemetry.py",
    # the cost ledger's memory sampler thread (MemorySampler)
    "telemetry/ledger.py",
    "io/sink.py",
    # the native libraries' one-shot build and load, reached from the
    # decode workers
    "native/__init__.py",
    "utils/profiling.py",
    # the serve daemon: batcher dispatcher thread, HTTP handler threads,
    # spool watcher thread all mutate shared admission/lifecycle state;
    # serve/preemptor.py runs on the dispatcher and the sweep thread
    "serve/*.py",
    "serve/preemptor.py",
    # the probe runs on HTTP handler threads (serve admission) and the
    # batch main thread concurrently; it must hold no mutable globals
    "io/probe.py",
    # the content-addressed store's hash memo is shared by every serve
    # handler thread, and the shared frame cache's LRU + in-flight
    # latches are mutated from concurrent extractor/decode threads
    "extract/cache.py",
    "extract/plan.py",
)


class SourceFile:
    """One parsed module: AST + waiver map + file-level markers."""

    def __init__(self, path: str, text: str, rel: Optional[str] = None) -> None:
        self.path = path
        self.text = text
        # rel: package-relative posix path ("extract/base.py") used for
        # hot/root pattern matching; falls back to the basename.
        self.rel = rel if rel is not None else os.path.basename(path)
        self.tree = ast.parse(text, filename=path)
        # line -> waiver tokens on that line; a standalone waiver comment
        # also registers for the next line.
        self.waivers: Dict[int, Set[str]] = {}
        self.markers: Set[str] = set()
        self._scan_comments()

    def _scan_comments(self) -> None:
        try:
            tokens = tokenize.generate_tokens(io.StringIO(self.text).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                body = tok.string.lstrip("#").strip()
                if not body.lower().startswith("graftcheck:"):
                    continue
                spec = body[len("graftcheck:"):].strip()
                # strip a trailing "— reason" / "- reason" clause
                for dash in ("—", " - ", " -- "):
                    if dash in spec:
                        spec = spec.split(dash, 1)[0]
                tokens_ = {t.strip().lower() for t in spec.split(",") if t.strip()}
                if not tokens_:
                    continue
                self.markers |= {
                    t
                    for t in tokens_
                    if t in ("hot-module", "thread-root", "cuda-kernel",
                             "bf16-entry")
                }
                line = tok.start[0]
                self.waivers.setdefault(line, set()).update(tokens_)
                # a comment-only line waives the statement it precedes:
                # the reason clause may wrap onto further comment lines,
                # so carry the waiver to the first following code line
                lines = self.text.splitlines()
                prefix = lines[line - 1][: tok.start[1]]
                if not prefix.strip():
                    nxt = line  # 0-based index of the line after the comment
                    while nxt < len(lines) and (
                        not lines[nxt].strip() or lines[nxt].lstrip().startswith("#")
                    ):
                        nxt += 1
                    self.waivers.setdefault(nxt + 1, set()).update(tokens_)
        except tokenize.TokenError:
            pass

    def waived(self, line: int, rule: Rule) -> bool:
        return any(rule.matches_token(t) for t in self.waivers.get(line, ()))

    @property
    def is_hot(self) -> bool:
        if "hot-module" in self.markers:
            return True
        return any(fnmatch.fnmatch(self.rel, pat) for pat in HOT_MODULE_PATTERNS)

    @property
    def is_thread_root(self) -> bool:
        if "thread-root" in self.markers:
            return True
        return any(fnmatch.fnmatch(self.rel, pat) for pat in THREAD_ROOT_PATTERNS)

    @property
    def module_name(self) -> str:
        return self.rel[:-3].replace("/", ".") if self.rel.endswith(".py") else self.rel


# the package directory as it appears in a path: the JAX package's
# "video_features_tpu/" is not a prefix of it, so a tree holding both
# packages keys each file on its own package
PACKAGE_DIR = "video_features_tpu_torch/"


def package_root() -> str:
    """The installed video_features_tpu_torch package directory."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def collect_sources(paths: Optional[Sequence[str]] = None) -> List[SourceFile]:
    """Load every .py under ``paths`` (default: the package itself) into
    SourceFiles with package-relative names for pattern matching."""
    roots = [package_root()] if not paths else [os.path.abspath(p) for p in paths]
    out: List[SourceFile] = []
    for root in roots:
        if os.path.isfile(root):
            out.append(_load(root, _pattern_rel(root, os.path.basename(root))))
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "_build")]
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                full = os.path.join(dirpath, fn)
                rel = os.path.relpath(full, root).replace(os.sep, "/")
                out.append(_load(full, _pattern_rel(full, rel)))
    return out


def _pattern_rel(full: str, fallback: str) -> str:
    # explicit file/dir args may point INSIDE the package
    # (``graftcheck video_features_tpu_torch/extract/base.py``): the
    # hot/root patterns are package-relative, so recover the tail from the
    # full path whenever it names the package dir
    posix = full.replace(os.sep, "/")
    return posix if PACKAGE_DIR in posix else fallback


def _load(path: str, rel: str) -> SourceFile:
    # checks run equally from the package dir or the repo root: pattern
    # matching always sees the package-relative tail
    if PACKAGE_DIR in rel:
        rel = rel.rsplit(PACKAGE_DIR, 1)[1]
    with open(path, "r", encoding="utf-8") as f:
        return SourceFile(path, f.read(), rel)


# --- shared AST helpers -----------------------------------------------------

def import_aliases(tree: ast.AST) -> Dict[str, str]:
    """name -> dotted module/attr it refers to, from every import in the
    tree (module- and function-level): ``import numpy as np`` -> np:
    numpy; ``import torch.nn.functional as F`` -> F: torch.nn.functional.
    Computed once per tree (every pass asks for it)."""
    cached = getattr(tree, "_graftcheck_aliases", None)
    if cached is not None:
        return cached
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    tree._graftcheck_aliases = aliases
    return aliases


def dotted_name(node: ast.AST) -> Optional[str]:
    """'jax.jit' for Attribute(Name('jax'), 'jit'); None for anything
    not a plain dotted chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def resolve_dotted(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """Dotted name with the import-alias head expanded: ``_np.asarray``
    -> ``numpy.asarray`` when ``import numpy as _np``."""
    dn = dotted_name(node)
    if dn is None:
        return None
    head, _, rest = dn.partition(".")
    base = aliases.get(head, head)
    return f"{base}.{rest}" if rest else base


def param_names(fn: ast.FunctionDef) -> List[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


# --- runner -----------------------------------------------------------------

def run_checks(
    paths: Optional[Sequence[str]] = None,
    rules: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """Run every static checker over ``paths`` (default: the installed
    package), drop waived findings, return the rest sorted by location.
    ``rules`` filters to findings whose rule id/name matches any token."""
    from video_features_tpu_torch.analysis import (
        concurrency,
        durability,
        hostsync,
        numerics,
        obs_contract,
        sharding_contract,
        thread_safety,
    )
    from video_features_tpu_torch.analysis.callgraph import CallGraph
    from video_features_tpu_torch.analysis.taint import ProjectTaint

    sources = collect_sources(paths)
    # one call graph + taint context per sweep, shared by the
    # interprocedural passes (GC10x, GC301, GC31x, GC505, GC60x, GC80x)
    graph = CallGraph(sources)
    project = ProjectTaint(sources, graph)
    findings: List[Finding] = []
    for src in sources:
        if src.is_hot:
            findings.extend(hostsync.check(src, project))
    findings.extend(thread_safety.check(sources, graph))
    findings.extend(concurrency.check(sources, graph, project))
    findings.extend(sharding_contract.check(sources, graph))
    findings.extend(durability.check(sources, graph, project))
    findings.extend(obs_contract.check(sources))
    findings.extend(numerics.check(sources, graph, project))

    kept = []
    for f in findings:
        src = next((s for s in sources if s.path == f.path), None)
        if src is not None and src.waived(f.line, f.rule):
            continue
        if rules and not any(f.rule.matches_token(t) for t in rules):
            continue
        kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule.id))
    return kept


def all_rules() -> List[Rule]:
    from video_features_tpu_torch.analysis import (
        concurrency,
        durability,
        hostsync,
        numerics,
        obs_contract,
        sharding_contract,
        thread_safety,
    )

    return [
        *hostsync.RULES.values(),
        thread_safety.RULE,
        *concurrency.RULES.values(),
        *sharding_contract.RULES.values(),
        *durability.RULES.values(),
        *obs_contract.RULES.values(),
        *numerics.RULES.values(),
    ]
