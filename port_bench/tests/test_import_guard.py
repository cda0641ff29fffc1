"""The import guard: whole top-level names, so the port's own name (which
starts with the JAX package's) passes; and no file of the benchmark imports
JAX or the JAX package, nor does the reference import the port."""

import ast
import pathlib

import pytest

from port_bench.harness import spec
from port_bench.harness.guard import forbidden_loaded

FILES = sorted(p for p in spec.BENCH_DIR.rglob("*.py") if "tests" not in p.parts)


def test_guard_compares_whole_top_level_names():
    assert forbidden_loaded(["video_features_tpu_torch", "video_features_tpu_torch.cli",
                             "jaxtyping", "torch"]) == []
    assert forbidden_loaded(["video_features_tpu.cli", "jax.numpy", "flax", "jaxlib.xla",
                             "torch"]) == ["flax", "jax", "jaxlib", "video_features_tpu"]


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(spec.BENCH_DIR)))
def test_no_benchmark_file_imports_jax(path):
    assert not set(_imports(path)) & {"jax", "jaxlib", "flax", "video_features_tpu"}


@pytest.mark.parametrize("path", sorted((spec.BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "video_features_tpu_torch" not in set(_imports(path))


def test_a_cpu_run_of_the_program_loads_no_jax(tmp_path):
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r)\n"
            "import video_features_tpu_torch.models.i3d.extract_i3d, port_bench.harness.cell\n"
            "from port_bench.harness.guard import forbidden_loaded\n"
            "print(forbidden_loaded())\n" % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
