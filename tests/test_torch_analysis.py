"""graftcheck for the port (``video_features_tpu_torch/analysis``) against
the JAX package's suite (``video_features_tpu/analysis``).

- The copied families (GC301, GC31x, GC60x, GC70x): one corpus of source
  snippets, written once under ``video_features_tpu/`` and once under
  ``video_features_tpu_torch/``, gives both analyzers the same set of
  (rule, path, line), a case per family.
- The retargeted families (GC10x, GC801-803): a JAX idiom and its torch
  idiom at the same lines give the same rule ids; the fetch/drain/sink
  names quiet both.
- The port's own rules without a JAX twin (GC104's blocking upload, GC505
  on the port's mesh path, GC804 on ``config.PARITY_CEILINGS``, GC805 on
  the CUDA kernels) fire on seeded faults and pass the repaired shapes.
- The port sweeps clean, and a copy with every waiver and declaration of
  this slice stripped, and every repair reverted, fires each finding
  again at its line.
- The repairs hold on their own: ``--profile_dir`` refuses what the JAX
  ``sanity_check`` refuses, a failed native decision is not sticky, and
  ``device_vector`` rounds as ``torch.tensor`` does.
- The CLI: exit codes 0/1/2, ``--json`` against the port's schema,
  ``--rule``, ``--diff``, ``--explain`` and ``--sarif``.

Pure AST work apart from the few repair checks; the two whole-package
sweeps run once each.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from video_features_tpu.analysis import run_checks as jax_run_checks
from video_features_tpu_torch.analysis import all_rules, collect_sources, run_checks
from video_features_tpu_torch.analysis.__main__ import main as cli_main
from video_features_tpu_torch.analysis.hostsync import sync_site_verdict

pytestmark = [pytest.mark.quick, pytest.mark.analysis]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "video_features_tpu_torch")
HOT = "# graftcheck: hot-module\n"
ROOT = "# graftcheck: thread-root\n"


def _write_tree(root, package, files):
    base = os.path.join(str(root), package)
    for rel, text in files.items():
        path = os.path.join(base, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(_dedent(text))
    return base


def _dedent(text):
    """Marker lines (``HOT``/``ROOT`` prefixes) at column 0, then the
    indented snippet."""
    lines = text.split("\n")
    n = 0
    while n < len(lines) and lines[n].startswith("# graftcheck:"):
        n += 1
    return "\n".join(lines[:n]) + ("\n" if n else "") + textwrap.dedent(
        "\n".join(lines[n:])).lstrip("\n")


def _keyed(findings, base, ids):
    return {
        (f.rule.id, os.path.relpath(f.path, base), f.line)
        for f in findings if f.rule.id in ids
    }


def _both(tmp_path, files, ids):
    jax_base = _write_tree(tmp_path / "jax", "video_features_tpu", files)
    port_base = _write_tree(tmp_path / "port", "video_features_tpu_torch", files)
    return (_keyed(jax_run_checks([jax_base]), jax_base, ids),
            _keyed(run_checks([port_base]), port_base, ids))


# --- the copied families: identical (rule, path, line) sets ------------------

CORPUS = {
    "GC301": ({"GC301"}, {
        "parallel/workers.py": ROOT + """
            import threading

            _CACHE = {}
            _LOCK = threading.Lock()
            _TLS = threading.local()
            _MODE = "auto"

            def remember(k, v):
                _CACHE[k] = v

            def remember_locked(k, v):
                with _LOCK:
                    _CACHE[k] = v

            def stash(v):
                _TLS.value = v

            def set_mode(v):
                global _MODE
                _MODE = v  # graftcheck: unlocked — config-set-once before threads

            def rebind(v):
                global _MODE
                _MODE = v
        """,
        "io/spawner.py": """
            import threading

            _STATE = {}
            _SEEN = []

            def configure(k, v):
                _STATE[k] = v

            def _worker():
                _SEEN.append(1)

            def start():
                threading.Thread(target=_worker, daemon=True).start()
        """,
        "runtime/root_mod.py": ROOT + """
            from video_features_tpu.runtime import helper

            def run():
                helper.poke("k", 1)
        """,
        "runtime/helper.py": """
            _STATE = {}

            def poke(k, v):
                _STATE[k] = v
        """,
    }),
    "GC31x": ({"GC311", "GC312", "GC313"}, {
        "serve/locks.py": HOT + ROOT + """
            import queue
            import subprocess
            import threading
            import time

            _A = threading.Lock()
            _B = threading.Lock()
            _LOCK = threading.Lock()
            _COND = threading.Condition()
            _Q = queue.Queue()
            _ITEMS = []

            def forward():
                with _A:
                    with _B:
                        pass

            def backward():
                with _B:
                    with _A:
                        pass

            def drain():
                with _LOCK:
                    item = _Q.get()
                    time.sleep(0.5)
                    with open("x") as f:
                        f.read()
                    subprocess.run(["true"])
                return item

            def timed():
                with _LOCK:
                    return _Q.get(timeout=1.0)

            def consume():
                with _COND:
                    while not _ITEMS:
                        _COND.wait()
                    return _ITEMS.pop()

            def fetch_group(handle):
                time.sleep(0.01)
                return handle

            def _pull_group(handle):
                time.sleep(0.01)
                return handle

            def publish(handle):
                with _LOCK:
                    return fetch_group(handle)

            def publish_leaky(handle):
                with _LOCK:
                    return _pull_group(handle)

            def spawn():
                t = threading.Thread(target=print)
                t.start()

            def probe(cmd):
                p = subprocess.Popen(cmd)
                return None

            def peek(path):
                f = open(path)
                line = f.readline()
                return len(line)

            def handoff(path):
                f = open(path)
                return f
        """,
    }),
    "GC60x": ({"GC601", "GC602", "GC603"}, {
        "io/publish.py": """
            import json
            import os
            import tempfile

            def publish(root, doc):
                path = os.path.join(root, "_manifest", "summary.json")
                with open(path, "w") as fh:
                    json.dump(doc, fh)

            def write_doc(path, doc):
                with open(path, "w") as fh:
                    json.dump(doc, fh)

            def publish_request(root, doc):
                write_doc(root + "/_requests/rec.json", doc)

            def atomic_write(path, doc):
                tmp = path + ".tmp"
                with open(tmp, "w") as fh:
                    json.dump(doc, fh)
                os.replace(tmp, path)

            def publish_atomic(root, doc):
                atomic_write(os.path.join(root, "_manifest", "summary.json"), doc)

            def bare(src, dst):
                os.rename(src, dst)

            def stage(doc, dst):
                fd, tmp = tempfile.mkstemp()
                with os.fdopen(fd, "w") as fh:
                    fh.write(doc)
                os.replace(tmp, dst)

            def stage_here(doc, dst):
                fd, tmp = tempfile.mkstemp(dir=os.path.dirname(dst))
                with os.fdopen(fd, "w") as fh:
                    fh.write(doc)
                os.replace(tmp, dst)
        """,
        "serve/claims.py": """
            import os

            def claim_excl(path):
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.close(fd)

            def claim_rename(spool, name, rid):
                os.rename(spool + "/" + name, spool + "/" + name + ".claim." + rid)
        """,
        "serve/leases.py": """
            import os

            def _lease_pass(claims):
                for c in claims:
                    try:
                        os.utime(c)
                    except OSError:
                        pass

            def poll_once(spool, rid, claims):
                _lease_pass(claims)
                src = spool + "/job.json"
                try:
                    os.rename(src, src + ".claim." + rid)
                except OSError:
                    return None
                return src
        """,
    }),
    "GC70x": ({"GC701", "GC702", "GC703"}, {
        "telemetry/exposition.py": """
            _PLAIN_COUNTERS = {"frames_seen": "Frames seen.", "dead_series": "Nobody."}

            def families_from_snapshot(snap):
                out = []
                for name, value in snap.get("counters", {}).items():
                    if name.startswith("requests_"):
                        out.append(("requests_total", value))
                    elif name == "lease_expired":
                        out.append(("lease_expired_total", value))
                    elif name in _PLAIN_COUNTERS:
                        out.append((name, value))
                return out
        """,
        "serve/producer.py": """
            class Worker:
                def tick(self, status):
                    self.metrics.inc("ghost_series")
                    self.metrics.inc("frames_seen")
                    self.metrics.inc(f"requests_{status}")
                    self.metrics.inc("lease_expired")
        """,
        "runtime/faults.py": """
            STAGES = ("decode", "ghost", "sink")

            def drill(fire):
                fire("decode")
                fire("typo")
                fire("sink")
        """,
        "config.py": """
            import argparse
            import dataclasses

            @dataclasses.dataclass
            class Cfg:
                alpha: str = ""
                hidden: int = 0

            def build():
                p = argparse.ArgumentParser()
                p.add_argument("--alpha")
                p.add_argument("--ghost")
                return p

            def sanity_check(cfg):
                if not cfg.alhpa:
                    raise ValueError("alpha required")
                return cfg
        """,
    }),
}


@pytest.mark.parametrize("family", sorted(CORPUS))
def test_copied_family_matches_the_jax_suite(tmp_path, family):
    ids, files = CORPUS[family]
    jax_found, port_found = _both(tmp_path, files, ids)
    assert port_found == jax_found
    # the corpus exercises every rule of the family, with clean shapes beside
    assert {rule for rule, _, _ in port_found} == ids, port_found


# --- the retargeted families: the same rule ids at the same lines ------------

PAIRS = {
    "GC101": ("""
        import jax.numpy as jnp

        def hot(x):
            y = jnp.square(x)
            a = y.item()
            return a
        """, """
        import torch

        def hot(x, device):
            y = torch.square(x.to(device))
            a = y.item()
            return a
        """),
    "GC102": ("""
        import jax.numpy as jnp

        def _score(x):
            return jnp.square(x).mean()

        def hot(x):
            y = jnp.square(x)
            b = float(y)
            c = int(jnp.sum(y))
            d = int(x.shape[0])
            return b + c + d + float(_score(x))
        """, """
        import torch

        def _score(x):
            return x.cuda().square().mean()

        def hot(x):
            y = x.cuda()
            b = float(y)
            c = int(torch.sum(y))
            d = int(x.shape[0])
            return b + c + d + float(_score(x))
        """),
    "GC103": ("""
        import jax
        import numpy as np
        import jax.numpy as jnp

        def hot(x):
            y = jnp.square(x)
            h = np.asarray(y)
            g = jax.device_get(y)
            k = np.asarray(x)
            return h, g, k
        """, """
        import torch
        import numpy as np
        import torch.nn.functional as F

        def hot(x):
            y = F.relu(torch.zeros(3, device="cuda") + x)
            h = np.asarray(y)
            g = y.to("cpu")
            k = np.asarray(x)
            return h, g, k
        """),
    "GC104": ("""
        import jax.numpy as jnp

        def hot(x):
            y = jnp.square(x)
            y.block_until_ready()
            return y
        """, """
        import torch

        def hot(x):
            y = torch.square(x)
            torch.cuda.synchronize()
            return y
        """),
    "GC801": ("""
        import jax
        import jax.numpy as jnp
        import numpy as np


        @jax.jit
        def fwd(x):
            y = x.astype(jnp.float64)
            g = np.linspace(0.0, 1.0, 5)
            z = jnp.zeros(3, dtype=jnp.float32)
            return y * g + z
        """, """
        import numpy as np
        import torch
        from torch import nn


        class M(nn.Module):
            def forward(self, x):
                y = x.double()
                g = torch.from_numpy(np.linspace(0.0, 1.0, 5))
                z = torch.zeros(3, dtype=torch.float32)
                return y * g + z
        """),
    "GC802": ("""
        import jax
        import jax.numpy as jnp

        def core(x, dtype):
            p = jax.nn.softmax(x)
            q = jax.nn.softmax(x.astype(jnp.float32))
            m = jnp.mean(x)
            return p + q + m
        """, """
        import torch
        import torch.nn.functional as F

        def core(x, dtype):
            p = torch.softmax(x, -1)
            q = F.softmax(x.float(), -1)
            m = torch.mean(x)
            return p + q + m
        """),
    "GC803": ("""
        import numpy as np
        import jax.numpy as jnp

        def ship(frames):
            a = frames.astype(np.float32)
            b = np.asarray(frames, dtype=np.float32)
            return a, b

        # graftcheck: fp32-island — a host-only parity reference
        def reference(frames):
            return frames.astype(np.float32)
        """, """
        import numpy as np
        import torch

        def ship(frames):
            a = torch.from_numpy(frames).float()
            b = np.asarray(frames, dtype=np.float32)
            return a, b

        # graftcheck: fp32-island — a host-only parity reference
        def reference(frames):
            return torch.from_numpy(frames).to(torch.float32)
        """),
}


def _pair_ids(tmp_path, rule, name=None):
    jax_src, torch_src = PAIRS[rule]
    if name is not None:
        jax_src = jax_src.replace("def hot(", f"def {name}(")
        torch_src = torch_src.replace("def hot(", f"def {name}(")
    out = []
    for package, src, check in (("video_features_tpu", jax_src, jax_run_checks),
                                ("video_features_tpu_torch", torch_src, run_checks)):
        base = _write_tree(tmp_path / package, package,
                           {"extract/hot.py": HOT + _dedent(src)})
        out.append([(f.rule.id, f.line) for f in check([base])
                    if f.rule.id.startswith(rule[:4])])
    return out


@pytest.mark.parametrize("rule", sorted(PAIRS))
def test_retargeted_idioms_match_the_jax_suite(tmp_path, rule):
    jax_found, port_found = _pair_ids(tmp_path, rule)
    assert port_found == jax_found
    assert jax_found and {r for r, _ in jax_found} == {rule}, jax_found


@pytest.mark.parametrize("name", ["fetch_group", "_fetch_rows", "drain_completed",
                                  "_drain", "to_sink"])
def test_allowlisted_names_quiet_both_suites(tmp_path, name):
    for rule in ("GC101", "GC102", "GC103", "GC104"):
        jax_found, port_found = _pair_ids(tmp_path / rule, rule, name=name)
        assert jax_found == port_found == [], (rule, jax_found, port_found)


# --- the port's own facts ----------------------------------------------------

def _port(tmp_path, files):
    base = _write_tree(tmp_path, "video_features_tpu_torch", files)
    return base, run_checks([base])


def test_gc10x_torch_facts(tmp_path):
    """A blocking host-data upload, a branch on a device tensor, a fetch
    through ``.to("cpu")`` and a module's forward parameters fire;
    HostCopy, metadata, a non-tensor parameter, the fetched copy and the
    host collectives stay host values."""
    base, fs = _port(tmp_path, {"models/x/model.py": """
        import torch
        from torch import nn
        from video_features_tpu_torch.extract.ingest import HostCopy
        from video_features_tpu_torch.parallel import distributed

        class Net(nn.Module):
            def forward(self, x, halo: bool = False):
                s = torch.tensor([1.0, 2.0], device=x.device)
                if x.sum() > 0:
                    x = x * s
                if halo:
                    x = x + 1
                n = int(x.shape[0]) + int(distributed.broadcast_one_to_all(1))
                h = HostCopy(x).numpy()
                c = x.to("cpu")
                return float(c.sum()) + n + h.sum() + self.head(x).item()
        """})
    got = [(f.rule.id, f.line) for f in fs]
    assert got == [("GC104", 8), ("GC102", 9), ("GC103", 15), ("GC101", 16)], got


def test_gc505_mesh_admission(tmp_path):
    files = {
        "config.py": """
            CLIP_FEATURE_TYPES = ["CLIP-ViT-B/32"]
            FEATURE_TYPES = CLIP_FEATURE_TYPES + ["raft", "vggish"]
            MESH_DEVICE_PREPROCESS_FEATURE_TYPES = CLIP_FEATURE_TYPES + ["raft"]
        """,
        "extract/registry.py": """
            from video_features_tpu_torch.config import CLIP_FEATURE_TYPES

            def build_extractor(cfg):
                if cfg.feature_type in CLIP_FEATURE_TYPES:
                    from video_features_tpu_torch.models.clip.extract_clip import X
                    return X(cfg)
                if cfg.feature_type == "raft":
                    from video_features_tpu_torch.models.raft.extract_raft import X
                    return X(cfg)
                if cfg.feature_type == "vggish":
                    from video_features_tpu_torch.models.vggish.extract_vggish import X
                    return X(cfg)
        """,
        "models/clip/extract_clip.py": """
            from video_features_tpu_torch.models.clip.model import ShardedVisionTransformer
            X = ShardedVisionTransformer
        """,
        "models/clip/model.py": "class ShardedVisionTransformer:\n    pass\n",
        "models/raft/extract_raft.py": """
            from video_features_tpu_torch.models.common.flow_extract import X
        """,
        "models/common/flow_extract.py": """
            from video_features_tpu_torch.parallel.sharding import halo_split

            def X(cfg):
                return halo_split
        """,
        "parallel/sharding.py": "def halo_split(x, mesh):\n    return x\n",
        "models/vggish/extract_vggish.py": "def X(cfg):\n    return cfg\n",
    }
    base, fs = _port(tmp_path, files)
    gc505 = [f for f in fs if f.rule.id == "GC505"]
    assert len(gc505) == 1 and "'vggish'" in gc505[0].message
    files["models/vggish/extract_vggish.py"] = """
        from video_features_tpu_torch.parallel.sharding import replicate

        def X(cfg):
            return replicate
    """
    files["parallel/sharding.py"] += "\ndef replicate(build, device):\n    return build\n"
    shutil.rmtree(base)
    _, fs = _port(tmp_path, files)
    assert [f for f in fs if f.rule.id == "GC505"] == []


_ADMIT = """
    LOW_PRECISION_MODEL_FAMILIES = {
        "bfloat16": ("clip", "resnet"),
    }
    PARITY_CEILINGS = {
        ("clip", "bfloat16", "model"): 0.03,
        ("pwc", "bfloat16", "model"): 0.02,
    }
"""


def test_gc804_ceilings_and_e2e_assertions(tmp_path):
    tests = tmp_path / "video_features_tpu_torch" / "tests"
    tests.mkdir(parents=True)
    (tests / "test_torch_bfloat16.py").write_text(
        'def test_clip():\n    assert max_rel_drift("clip", "bfloat16", "model")\n')
    _, fs = _port(tmp_path, {"config.py": _ADMIT})
    msgs = sorted(f.message for f in fs if f.rule.id == "GC804")
    assert len(msgs) == 2, msgs
    assert "('resnet', 'bfloat16') has no numeric ceiling" in msgs[0]
    assert "orphan ceiling ('pwc', 'bfloat16', 'model')" in msgs[1]
    fixed = _ADMIT.replace('("pwc", "bfloat16", "model"): 0.02',
                           '("resnet", "bfloat16", "model"): 0.02')
    _, fs = _port(tmp_path, {"config.py": fixed})
    msgs = [f.message for f in fs if f.rule.id == "GC804"]
    assert len(msgs) == 1 and "no case of tests/test_torch_bfloat16.py" in msgs[0]


_KERNEL = {
    "csrc/toy.cu": """
        template <typename T>
        __global__ void toy(const T* x, T* y, int n) {
          T acc = 0;
          for (int i = 0; i < n; ++i) acc += x[i];
          y[0] = acc;
        }
        template __global__ void toy<__nv_bfloat16>(const __nv_bfloat16*, __nv_bfloat16*, int);
    """,
    "ops/toy.py": """
        import torch
        from video_features_tpu_torch.ops import kernels

        def toy_reference(x):
            return x.sum()

        # graftcheck: cuda-kernel
        def toy(x):
            if x.device.type == "cpu":
                return toy_reference(x)
            try:
                fn = kernels.load("toy").toy
                out = fn(x)
            except RuntimeError:
                return toy_reference(x)
            return out
    """,
    "ops/kernels.py": "def load(name):\n    return None\n\ndef count_launch(fn):\n    fn.launches += 1\n",
}


def test_gc805_kernel_hygiene(tmp_path):
    (tmp_path / "bad" / "video_features_tpu_torch" / "tests").mkdir(parents=True)
    _, fs = _port(tmp_path / "bad", _KERNEL)
    msgs = " | ".join(f.message for f in fs if f.rule.id == "GC805")
    assert "accumulates 'acc' in T" in msgs
    assert "keeps no launches counter" in msgs
    assert "catches a kernel failure to call the plain twin" in msgs
    assert "no pytest.mark.cuda test holds 'toy'" in msgs
    good = dict(_KERNEL)
    good["csrc/toy.cu"] = _KERNEL["csrc/toy.cu"].replace("T acc = 0;", "float acc = 0.f;")
    good["ops/toy.py"] = """
        import torch
        from video_features_tpu_torch.ops import kernels

        def toy_reference(x):
            return x.sum()

        # graftcheck: cuda-kernel
        def toy(x):
            if x.device.type == "cpu":
                return toy_reference(x)
            out = kernels.load("toy").toy(x)
            kernels.count_launch(toy)
            return out

        toy.launches = 0
    """
    tests = tmp_path / "good" / "video_features_tpu_torch" / "tests"
    tests.mkdir(parents=True)
    (tests / "test_toy.py").write_text(
        "import pytest\n\n@pytest.mark.cuda\ndef test_toy():\n"
        "    assert toy(1) == toy_reference(1)\n")
    _, fs = _port(tmp_path / "good", good)
    assert [f.message for f in fs if f.rule.id == "GC805"] == []


def test_declaration_tokens_are_not_waivers():
    for token in ("fp32-island", "bf16-entry", "cuda-kernel", "hot-module",
                  "thread-root"):
        assert not any(r.matches_token(token) for r in all_rules()), token


# --- the port itself ---------------------------------------------------------

@pytest.fixture(scope="module")
def port_sweep():
    """One sweep of the whole package (the CLI's default), with the
    sources it parsed."""
    return run_checks(), collect_sources()


def test_port_is_clean(port_sweep):
    """No finding survives its waivers."""
    fs, _ = port_sweep
    assert fs == [], "\n".join(f.format() for f in fs)


def test_port_sweep_covers_the_package(port_sweep):
    """Every .py file of the port, the analysis package included, keyed
    on its package-relative path (so the hot and thread-root patterns
    see the port's tree), and none of the JAX package."""
    _, sources = port_sweep
    want = sorted(
        os.path.relpath(os.path.join(d, n), PORT).replace(os.sep, "/")
        for d, dirs, names in os.walk(PORT)
        if "__pycache__" not in d and "_build" not in d
        for n in names if n.endswith(".py"))
    assert sorted(s.rel for s in sources) == want
    assert "analysis/taint.py" in want and "extract/base.py" in want
    hot = {s.rel for s in sources if s.is_hot}
    roots = {s.rel for s in sources if s.is_thread_root}
    assert {"extract/ingest.py", "models/pwc/model.py", "models/clip/extract_clip.py",
            "serve/daemon.py"} <= hot
    assert {"extract/ingest.py", "parallel/distributed.py", "telemetry/ledger.py",
            "serve/preemptor.py", "native/__init__.py"} <= roots


# every ``# graftcheck:`` waiver or declaration in the port, and every
# repair of this slice reverted: (file, text on the finding's line, how
# to revert it in a copy, the rule that must fire there)
_STRIP = ("graftcheck:", "stripped:")
REFIRES = [
    ("extract/ingest.py", "self._event.synchronize()", None, "GC104"),
    ("ops/preprocess.py", "return tuple(torch.tensor(v, dtype=torch.float32", None, "GC104"),
    ("ops/preprocess.py", "return np.transpose(img, (2, 0, 1)).astype(np.float32)", None,
     "GC803"),
    ("telemetry/exposition.py", '"compiles": (', None, "GC701"),
    ("models/r21d/extract_r21d.py", "return stacks.astype(np.float32)", None, "GC803"),
    ("models/i3d/extract_i3d.py", "return [pil_resize(f, MIN_SIDE_SIZE).astype(np.float32)",
     None, "GC803"),
    ("models/i3d/extract_i3d.py", "imgs = np.stack([", None, "GC803"),
    # the repairs, reverted
    ("config.py", 'p.add_argument("--profile_dir"',
     ('        ("profile_dir", cfg.profile_dir),\n', ""), "GC703"),
    ("parallel/distributed.py", "_group.clear()",
     ("    with _group_lock:\n        _group.clear()", "    _group.clear()"), "GC301"),
    ("models/pwc/model.py", "norm = torch.tensor(",
     ("norm = device_vector([(W - 1.0) / 2.0, (H - 1.0) / 2.0], flow)",
      "norm = torch.tensor([(W - 1.0) / 2.0, (H - 1.0) / 2.0], device=flow.device)"),
     "GC104"),
    ("models/raft/model.py", "scale = torch.tensor(",
     ("scale = device_vector([2.0 / (w - 1), 2.0 / (h - 1)], pts)",
      "scale = torch.tensor([2.0 / (w - 1), 2.0 / (h - 1)], device=pts.device)"), "GC104"),
    ("models/r21d/extract_r21d.py", "mean = torch.tensor(",
     ("mean = device_vector(KINETICS_MEAN, x)",
      "mean = torch.tensor(KINETICS_MEAN, dtype=x.dtype, device=x.device)"), "GC104"),
    ("extract/base.py", "self._decide_native()",
     ("        if self._use_native is None:\n            self._decide_native()",
      "        with self._native_lock:\n            if self._use_native is None:\n"
      "                self._decide_native()"), "GC312"),
]
# the extractor's lock, put back with the reverted _native_decided
_BASE_LOCK = ("        self._taps_lock = threading.Lock()\n",
              "        self._taps_lock = threading.Lock()\n"
              "        self._native_lock = threading.Lock()\n")


def test_stripped_waivers_and_reverted_repairs_refire(tmp_path):
    """One sweep of a copy with every waiver and declaration stripped (the
    ``cuda-kernel`` markers stay: GC805 reads them) and every repair
    reverted: each finding is back at its line."""
    copy = tmp_path / "video_features_tpu_torch"
    shutil.copytree(PORT, copy, ignore=shutil.ignore_patterns("__pycache__", "_build"))
    comments = []
    for dirpath, _, names in os.walk(copy):
        if os.path.basename(dirpath) == "analysis":
            continue
        for name in names:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                text = f.read()
            for line in text.splitlines():
                if "# graftcheck:" in line and "cuda-kernel" not in line:
                    comments.append((os.path.relpath(path, copy), line.strip()))
            text = "\n".join(
                line if "cuda-kernel" in line else line.replace(*_STRIP)
                for line in text.split("\n"))
            with open(path, "w") as f:
                f.write(text)
    # every waiver or declaration of the port has its case below
    assert sorted({rel for rel, _ in comments}) == sorted(
        {rel for rel, _, revert, _ in REFIRES if revert is None}), comments
    assert len(comments) == sum(1 for *_, revert, _ in REFIRES if revert is None)

    for rel, _, revert, _ in REFIRES:
        if revert is not None:
            path = copy / rel
            text = path.read_text()
            assert text.count(revert[0]) == 1, (rel, revert[0])
            path.write_text(text.replace(*revert))
    base = copy / "extract" / "base.py"
    base.write_text(base.read_text().replace(*_BASE_LOCK))

    found = {(os.path.relpath(f.path, copy), f.line, f.rule.id) for f in run_checks([str(copy)])}
    missing = []
    for rel, needle, _, rule in REFIRES:
        lines = (copy / rel).read_text().splitlines()
        (line,) = [i for i, text in enumerate(lines, 1) if needle in text]
        if (rel, line, rule) not in found:
            missing.append((rel, line, rule))
    assert not missing, (missing, sorted(found))


# --- the repairs on their own -------------------------------------------------

@pytest.mark.parametrize("value", ["", " "])
def test_profile_dir_refused_like_jax(value):
    """``--profile_dir`` is one of the JAX ``sanity_check``'s non-empty
    paths; the port refuses the same values with the same message."""
    from video_features_tpu.config import ExtractionConfig as JaxConfig
    from video_features_tpu.config import sanity_check as jax_sanity
    from video_features_tpu_torch.config import ExtractionConfig, sanity_check

    kw = dict(feature_type="resnet50", video_paths=["a.mp4"], profile_dir=value)
    with pytest.raises(ValueError) as jax_err:
        jax_sanity(JaxConfig(**kw))
    with pytest.raises(ValueError) as port_err:
        sanity_check(ExtractionConfig(**kw))
    assert str(port_err.value) == str(jax_err.value) == "--profile_dir must be a non-empty path"


def test_native_decision_failure_is_not_sticky(monkeypatch, tmp_path):
    """An unavailable native library fails every decision, not only the
    first: the decision is published after the build's answer."""
    from video_features_tpu_torch import native
    from video_features_tpu_torch.config import ExtractionConfig
    from video_features_tpu_torch.extract.registry import build_extractor

    video = tmp_path / "a.mp4"
    video.write_bytes(b"")
    ex = build_extractor(ExtractionConfig(feature_type="resnet18", video_paths=[str(video)],
                                          allow_random_init=True), external_call=True)
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "build_error", lambda: "no g++ here")
    ex.config.host_preprocess = "native"
    ex._use_native = None
    for _ in range(2):
        with pytest.raises(RuntimeError, match="no g\\+\\+ here"):
            ex._native_decided()
        assert ex._use_native is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_device_vector_rounds_as_torch_tensor(dtype):
    from video_features_tpu_torch.models.common.layers import device_vector

    values = [2.0 / 333, 1.0 / 3.0, (250 - 1.0) / 2.0, 1e-8]
    like = torch.zeros(1, dtype=dtype)
    got = device_vector(values, like)
    want = torch.tensor(values, dtype=dtype)
    assert got.dtype == dtype and got.shape == (4,)
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


def test_sync_site_verdict():
    ingest = os.path.join(PORT, "extract", "ingest.py")
    lines = open(ingest).read().splitlines()
    (wait,) = [i for i, t in enumerate(lines, 1) if "self._event.synchronize()" in t]
    assert sync_site_verdict(ingest, wait) == "waived"
    base = os.path.join(PORT, "extract", "base.py")
    lines = open(base).read().splitlines()
    (drain,) = [i for i, t in enumerate(lines, 1) if "def drain_completed" in t]
    assert sync_site_verdict(base, drain + 2) == "allowlisted"
    assert sync_site_verdict(os.path.join(PORT, "cli.py"), 1) == "cold"
    pwc = os.path.join(PORT, "models", "pwc", "model.py")
    lines = open(pwc).read().splitlines()
    (norm,) = [i for i, t in enumerate(lines, 1) if "norm = device_vector(" in t]
    assert sync_site_verdict(pwc, norm) == "unaccounted"


# --- the CLI ------------------------------------------------------------------

def _bad(tmp_path):
    bad = tmp_path / "video_features_tpu_torch" / "extract" / "bad.py"
    bad.parent.mkdir(parents=True, exist_ok=True)
    bad.write_text(
        "import torch\n\n"
        "def _score(x):\n    return x.cuda().square().mean()\n\n"
        "def hot(x):\n    y = x.cuda()\n    return float(_score(x)), y.item()\n"
    )
    return bad


def test_cli_exit_codes_rule_json_schema(tmp_path, capsys):
    import jsonschema

    bad = _bad(tmp_path)
    assert cli_main([str(bad)]) == 1
    out = capsys.readouterr().out
    assert f"{bad}:8:" in out and "GC102" in out and "GC101" in out and "fix:" in out

    assert cli_main(["--json", "--rule", "GC101", str(bad)]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert [d["rule"] for d in doc] == ["GC101"] and doc[0]["line"] == 8
    assert cli_main(["--json", "--rule", "GC101,host-sync-cast", str(bad)]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert sorted(d["rule"] for d in doc) == ["GC101", "GC102"]
    with open(os.path.join(PORT, "analysis", "findings_schema.json")) as f:
        jsonschema.validate(doc, json.load(f))
    assert any(d["trace"] for d in doc)

    assert cli_main(["--explain", "GC102", str(bad)]) == 1
    assert "via:" in capsys.readouterr().out

    clean = tmp_path / "ok.py"
    clean.write_text("x = 1\n")
    assert cli_main([str(clean)]) == 0
    assert "clean" in capsys.readouterr().out
    assert cli_main(["--sarif", str(bad)]) == 1
    sarif = json.loads(capsys.readouterr().out)
    assert [r["id"] for r in sarif["runs"][0]["tool"]["driver"]["rules"]] == [
        r.id for r in all_rules()]

    broken = tmp_path / "broken.py"
    broken.write_text("def f(:\n")
    assert cli_main([str(broken)]) == 2
    assert "cannot analyze" in capsys.readouterr().err

    assert cli_main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    for rid in ("GC101", "GC104", "GC301", "GC312", "GC505", "GC601", "GC701", "GC805"):
        assert rid in listed
    for gone in ("GC201", "GC401", "GC501"):
        assert gone not in listed


def test_cli_diff_and_module_entry(tmp_path):
    """``python -m``: ``--diff BASE`` keeps the findings on changed lines
    only; a bad ref is exit 2."""
    def git(*args):
        subprocess.run(["git", "-c", "user.email=t@t", "-c", "user.name=t", *args],
                       cwd=str(tmp_path), check=True, capture_output=True)

    def cli(*args):
        return subprocess.run([sys.executable, "-m", "video_features_tpu_torch.analysis",
                               *args], capture_output=True, text=True, cwd=str(tmp_path),
                              env=dict(os.environ, PYTHONPATH=REPO))

    git("init", "-q")
    mod = tmp_path / "mod.py"
    mod.write_text(HOT + "import torch\n\ndef hot(x):\n    return float(x.cuda())\n")
    git("add", "mod.py")
    git("commit", "-q", "-m", "seed")
    r = cli("--diff", "HEAD", str(mod))
    assert r.returncode == 0, r.stdout + r.stderr
    mod.write_text(mod.read_text() + "\ndef hotter(x):\n    return x.cuda().item()\n")
    r = cli("--diff", "HEAD", str(mod))
    assert r.returncode == 1
    assert "GC101" in r.stdout and "GC102" not in r.stdout
    r = cli("--diff", "no-such-ref", str(mod))
    assert r.returncode == 2 and "--diff" in r.stderr
