"""A run with no card, or fewer cards than the cell asks for, fails and
prints no result: it never falls back to the CPU. So does a run in a
directory that holds only the benchmark's files."""

import os
import shutil
import subprocess
import sys

from port_bench.harness import spec

CMD = ["--workload", "i3d_pwc.k400_devprep", "--seed", str(2 ** 31 + 7), "--seconds", "1",
       "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "port_bench/run.py", *CMD], capture_output=True,
                          text=True, cwd=cwd, env=env, timeout=300)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(spec.ROOT, env)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "needs 1 CUDA device" in out.stderr


def test_benchmark_files_alone_do_not_make_a_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert "{" not in out.stdout
