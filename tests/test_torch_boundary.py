"""The port stands alone: no JAX, no Flax, nothing of ``video_features_tpu``.

``video_features_tpu_torch`` starts with ``video_features_tpu``, so the
scan matches that name only as a whole module name or with a trailing
``.``. Nor does a port module name a path under ``video_features_tpu/``
in its code (docstrings may cite the JAX package's files): a loader that
reused the JAX package's ``native/_build/*.so`` would.
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


def _jax_paths(tree) -> list:
    """(line, text) of the string constants outside docstrings that name
    a path under the JAX package: ``video_features_tpu/...``, or the bare
    ``video_features_tpu`` as a path component."""
    docstrings = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docstrings.add(id(body[0].value))
    hits = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docstrings):
            text = node.value.replace("\\", "/")
            if any(part == "video_features_tpu" for part in text.split("/")) and (
                    "/" in text or text == "video_features_tpu"):
                hits.append((node.lineno, text))
    return hits


def test_path_scan_catches_the_reference_but_not_the_port():
    tree = ast.parse('"""cites video_features_tpu/native/decoder.cpp"""\n'
                     'A = "video_features_tpu/native/_build"\n'
                     'B = os.path.join(ROOT, "video_features_tpu", "native")\n'
                     'C = "video_features_tpu_torch/_build"\n')
    assert [line for line, _ in _jax_paths(tree)] == [2, 3]


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_port_module_names_a_jax_package_path(path):
    hits = _jax_paths(ast.parse(path.read_text(), str(path)))
    assert not hits, f"{path.relative_to(ROOT)} names {hits}"


def test_native_libraries_build_inside_the_port():
    from video_features_tpu_torch import native

    assert native.BUILD_DIR == PACKAGE / "_build"
    for name in ("preprocess", "decoder"):
        assert native.library_path(name).is_relative_to(PACKAGE / "_build")
        assert (PACKAGE / "native" / f"{name}.cpp").exists()


@pytest.mark.parametrize("module", [
    "video_features_tpu_torch.native",
    "video_features_tpu_torch.serve",
    "video_features_tpu_torch.serve.daemon",
    "video_features_tpu_torch.serve.server",
    "video_features_tpu_torch.serve.sources",
    "video_features_tpu_torch.extract.cache",
    "video_features_tpu_torch.extract.plan",
    "video_features_tpu_torch.telemetry.exposition",
])
def test_serve_cache_and_exposition_are_scanned(module):
    """The scan and the import check below reach the daemon's subpackage
    (its ``__init__.py`` makes it a package) and its companions."""
    assert module in _modules()
    path = ROOT.joinpath(*module.split("."))
    assert (path / "__init__.py" if path.is_dir() else path.with_suffix(".py")) in _port_files()


def test_every_module_imports_without_jax(tmp_path):
    """Every port module imports with JAX, Flax, msgpack, orbax,
    tensorstore and zstandard hidden, and a ``.msgpack`` and an orbax
    directory still load: the port reads Flax's format and orbax's with
    its own codecs."""
    code = (
        "import sys, importlib\n"
        "for name in ('jax', 'jaxlib', 'flax', 'video_features_tpu', 'msgpack', 'orbax',\n"
        "             'orbax.checkpoint', 'tensorstore', 'zstandard'):\n"
        "    sys.modules[name] = None\n"
        f"for mod in {_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(mod)\n"
        "import numpy as np\n"
        "from video_features_tpu_torch.models.common.flax_msgpack import save_msgpack\n"
        "from video_features_tpu_torch.models.common.orbax import save_orbax\n"
        "from video_features_tpu_torch.models.common.weights import load_params\n"
        f"path = {str(tmp_path / 'w.msgpack')!r}\n"
        "save_msgpack({'params': {'dense': {'kernel': np.eye(3, dtype=np.float32)}}}, path)\n"
        "tree = load_params(path, None, lambda t: t)\n"
        "assert np.array_equal(tree['dense']['kernel'], np.eye(3)), tree\n"
        f"path = {str(tmp_path / 'w_orbax')!r}\n"
        "save_orbax({'dense': {'kernel': np.eye(3, dtype=np.float32)}}, path)\n"
        "tree = load_params(path, None, lambda t: t)\n"
        "assert np.array_equal(tree['dense']['kernel'], np.eye(3)), tree\n"
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
    ["--feature_type", "vggish"],
], ids=["clip", "i3d", "pwc", "raft", "i3d-raft", "resnet50", "r21d", "vggish"])
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
