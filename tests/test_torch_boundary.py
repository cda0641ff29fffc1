"""The port stands alone: no JAX, no Flax, nothing of ``video_features_tpu``.

``video_features_tpu_torch`` starts with ``video_features_tpu``, so the
scan matches that name only as a whole module name or with a trailing
``.``.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from video_features_tpu_torch import cli
from video_features_tpu_torch.ops import kernels

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "video_features_tpu_torch"
FORBIDDEN = ("jax", "flax", "video_features_tpu")


def _port_files():
    return sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    return [
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in sorted(PACKAGE.rglob("*.py"))
    ]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_scan_catches_the_reference_but_not_the_port():
    assert _forbidden("video_features_tpu") and _forbidden("video_features_tpu.io.sink")
    assert _forbidden("jax.numpy") and _forbidden("flax")
    assert not _forbidden("video_features_tpu_torch.io.sink") and not _forbidden("jaxtyping")


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0 or node.module is None or not _forbidden(node.module)
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.relative_to(ROOT)}:{node.lineno} imports {bad}"


def test_every_module_imports_without_jax():
    code = (
        "import sys, importlib\n"
        "for name in ('jax', 'jaxlib', 'flax', 'video_features_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"for mod in {_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(mod)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


@pytest.mark.parametrize("args", [
    ["--feature_type", "CLIP-ViT-B/32", "--extract_method", "uni_3"],
    ["--feature_type", "i3d", "--flow_type", "pwc"],
    ["--feature_type", "pwc"],
    ["--feature_type", "raft"],
    ["--feature_type", "i3d", "--flow_type", "raft"],
    ["--feature_type", "resnet50"],
    ["--feature_type", "r21d_rgb"],
], ids=["clip", "i3d", "pwc", "raft", "i3d-raft", "resnet50", "r21d"])
def test_cli_without_cpu_needs_cuda(monkeypatch, sample_video, tmp_path, args):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([
            *args, "--allow_random_init", "--video_paths", sample_video,
            "--output_path", str(tmp_path / "out"), "--tmp_path", str(tmp_path / "tmp"),
        ])


def test_kernel_build_is_keyed_by_source_and_needs_nvcc(monkeypatch, tmp_path):
    assert kernels.sources() == ["flash_attention", "local_correlation"]
    lib = kernels.library_path("flash_attention")
    assert lib.parent == kernels.BUILD_DIR and lib == kernels.library_path("flash_attention")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.nvcc()
