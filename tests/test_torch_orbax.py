"""orbax checkpoint directories read and written by the port's own codec
(``models/common/orbax.py``), with ``tensorstore``, ``orbax`` and
``zstandard`` hidden in ``sys.modules`` while the port's code runs; the
JAX package and orbax write or read before or after.

- The reader against the JAX package's ``save_orbax``, one case a family:
  the state dict after ``params_from_jax`` equal to the seeded one bit for
  bit (tolerance 0: the converters only move layout).
- The reader against stores that tensorstore and orbax write here: a leaf
  out of line, a 0-d leaf, fp16 and bf16 leaves, an array of several
  chunks with cropped edge chunks and an absent chunk at its fill value,
  arrays sharded over a CPU mesh (a chunk a shard), a b-tree with
  interior nodes, a store of two commits; a corrupted node is refused by
  its CRC-32C, naming the file.
- The writer: orbax's ``StandardCheckpointer().restore``, the JAX
  package's ``load_params`` and its ``load_orbax`` onto a 4 x 2 CPU mesh
  under ``clip_vit_param_specs`` read the port's directory bit for bit,
  and the port reads back every dtype it writes.
- ``python -m video_features_tpu_torch.convert_weights --format orbax``
  against ``scripts/convert_weights.py --format orbax``, leaf for leaf.
- The refusals: a dtype the reader does not take, an orbax layout it does
  not take, an existing ``dst``, and a zstd library that does not load.
"""

import contextlib
import functools
import importlib.util
import json
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from video_features_tpu.models.common import weights as jax_weights
from video_features_tpu.models.resnet import convert as jax_resnet_convert
from video_features_tpu.parallel.sharding import clip_vit_param_specs, make_mesh
from video_features_tpu_torch import convert_weights
from video_features_tpu_torch.models.clip import convert as clip_convert
from video_features_tpu_torch.models.common import orbax
from video_features_tpu_torch.models.common.weights import load_params

from test_torch_resnet import seeded_resnet
from test_torch_weights_formats import FAMILIES, _clip, _equal_state, _fail_convert, _numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]
HIDDEN = ("tensorstore", "orbax", "orbax.checkpoint", "zstandard")


@contextlib.contextmanager
def port_alone():
    """``tensorstore``, ``orbax`` and ``zstandard`` unimportable while the
    block runs: the port's code reads and writes without them."""
    saved = {name: sys.modules.get(name) for name in HIDDEN}
    for name in HIDDEN:
        sys.modules[name] = None
    try:
        yield
    finally:
        for name, module in saved.items():
            if module is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module


def _same(got, want, path=""):
    """``got`` (the port's) equals ``want`` leaf for leaf: keys, shapes,
    dtypes and bytes; a bf16 leaf of the port is a ``torch.bfloat16``
    tensor, of the JAX side an ml_dtypes or jax array."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
        return
    want = np.asarray(want)
    if isinstance(got, torch.Tensor):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16, path
        got = got.view(torch.int16).numpy()
    else:
        got = np.asarray(got)
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
    assert got.shape == want.shape and got.tobytes() == want.tobytes(), path


def _orbax_save(tree, path):
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(os.path.abspath(path), tree)
    ckptr.wait_until_finished()


def _metadata(path, leaves):
    """orbax's ``_METADATA`` for a directory whose store tensorstore wrote."""
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": {str(tuple(keys)): {
            "key_metadata": [{"key": k, "key_type": 2} for k in keys],
            "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False}}
            for keys in leaves}, "use_ocdbt": True, "use_zarr3": False}, f)


def _zarr(path, name, arr, chunks, config=None, fill_value=None):
    """``arr`` as the zarr v2 array ``name`` of the OCDBT store at ``path``,
    written by tensorstore in chunks of ``chunks``."""
    kvstore = {"driver": "ocdbt", "base": f"file://{os.path.abspath(path)}/", "path": name}
    if config:
        kvstore["config"] = config
    store = ts.open({"driver": "zarr", "kvstore": kvstore, "metadata": {
        "shape": list(arr.shape), "chunks": chunks, "dtype": arr.dtype.str,
        "fill_value": fill_value, "compressor": {"id": "zstd", "level": 1}}},
        create=True).result()
    store.write(arr).result()


# --- the reader against the JAX package's save_orbax, a family a case ---------------

@pytest.fixture(scope="module")
def seeded_states():
    """Each family's seeded state dict, made once for the module."""
    return {family: spec[0]().state_dict() for family, spec in FAMILIES.items()}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_reader_reads_the_jax_packages_save_orbax_bitwise(tmp_path, seeded_states, family):
    _, _, from_jax, jax_convert, reference_layout = FAMILIES[family]
    sd = seeded_states[family]
    path = tmp_path / family
    jax_weights.save_orbax(jax_convert(reference_layout(_numpy(sd))), str(path))
    with port_alone():
        got = load_params(str(path), _fail_convert, from_jax)
    _equal_state(got, sd)


# --- the reader against layouts that orbax and tensorstore write -----------------------

@pytest.fixture(scope="module")
def orbax_written(tmp_path_factory):
    """A tree of every kind of leaf the reader takes, saved by orbax."""
    rng = np.random.RandomState(0)
    tree = {
        "wide": rng.randn(48, 40).astype(np.float32),  # 7680 B: a chunk out of line
        "scalar": np.asarray(np.float32(2.5)),
        "half": rng.randn(6).astype(np.float16),
        "brain": np.asarray(jnp.asarray(rng.randn(3, 5), jnp.bfloat16)),
        "nested": {"count": np.arange(-3, 4, dtype=np.int32), "mask": rng.rand(6) > 0.5,
                   "steps": np.arange(300, dtype=np.uint8).reshape(3, 100),
                   "long": np.arange(-2, 3, dtype=np.int64)},
    }
    path = tmp_path_factory.mktemp("orbax_written") / "ckpt"
    _orbax_save(tree, path)
    return str(path), tree


def test_reader_reads_a_leaf_stored_out_of_line(orbax_written):
    path, tree = orbax_written
    with port_alone():
        store = orbax.Store(path)
        got = orbax.load_orbax(path)
    entry = store.entries[b"wide/0.0"]
    assert entry.inline is None and entry.file.base == "ocdbt.process_0/"
    assert entry.length > orbax.MAX_INLINE_VALUE_BYTES
    _same(got["wide"], tree["wide"])


def test_reader_reads_scalar_half_bf16_int_and_bool_leaves(orbax_written):
    path, tree = orbax_written
    with port_alone():
        got = orbax.load_orbax(path)
    assert got["scalar"].shape == () and isinstance(got["brain"], torch.Tensor)
    _same(got, tree)
    _same(got, ocp.StandardCheckpointer().restore(path))


def test_reader_assembles_a_grid_of_chunks(tmp_path):
    """Edge chunks cropped, and a chunk that equals the fill value, which
    tensorstore leaves unwritten, read as the fill value."""
    rng = np.random.RandomState(1)
    grid = rng.randn(5, 7).astype(np.float32)
    grid[:2, 3:6] = 1.5  # the chunk (0, 1), all fill
    steps = np.arange(10, dtype=np.int32)
    path = tmp_path / "grid"
    _zarr(path, "grid", grid, [2, 3], fill_value=1.5)
    _zarr(path, "steps", steps, [4])
    _metadata(path, [("grid",), ("steps",)])
    with port_alone():
        store = orbax.Store(str(path))
        got = orbax.load_orbax(str(path))
    keys = {k.decode() for k in store.entries}
    assert "grid/0.1" not in keys and {"grid/2.2", "steps/2"} <= keys
    _same(got, {"grid": grid, "steps": steps})


def test_reader_reads_a_tree_saved_from_mesh_sharded_arrays(tmp_path):
    """``jax.Array`` leaves placed on the 4 x 2 CPU mesh: orbax writes a
    chunk a shard."""
    rng = np.random.RandomState(5)
    tree = {"kernel": rng.randn(8, 6).astype(np.float32), "bias": rng.randn(6).astype(np.float32),
            "scale": rng.randn(5).astype(np.float32)}
    mesh = make_mesh(jax.devices(), data=4, model=2)
    specs = {"kernel": P("data", "model"), "bias": P("model"), "scale": P()}
    placed = {k: jax.device_put(v, NamedSharding(mesh, specs[k])) for k, v in tree.items()}
    jax_weights.save_orbax(placed, str(tmp_path / "sharded"))
    with port_alone():
        store = orbax.Store(str(tmp_path / "sharded"))
        got = orbax.load_orbax(str(tmp_path / "sharded"))
    assert {b"kernel/3.1", b"bias/1"} <= set(store.entries)
    _same(got, tree)


def test_reader_walks_interior_nodes(tmp_path):
    """Nodes of at most 256 decoded bytes: a b-tree of several levels, whose
    interior nodes keep each child's common key prefix."""
    rng = np.random.RandomState(2)
    tree = {f"layer{i:02d}": {"bias": rng.randn(3).astype(np.float32)} for i in range(24)}
    path = tmp_path / "deep"
    config = {"max_decoded_node_bytes": 256}
    for name, leaf in tree.items():
        _zarr(path, f"{name}.bias", leaf["bias"], [3], config)
    _metadata(path, [(name, "bias") for name in tree])
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/"}).result()
    with port_alone():
        store = orbax.Store(str(path))
        got = orbax.load_orbax(str(path))
    assert store.height >= 2
    assert {k: store.get(k.decode()) for k in store.entries} == {
        k: kv.read(k).result().value for k in kv.list().result()}
    _same(got, tree)


def test_reader_takes_the_newest_of_two_commits(tmp_path):
    path = tmp_path / "two"
    first = np.arange(6, dtype=np.float32)
    _zarr(path, "kept", first, [6])
    _zarr(path, "moved", np.zeros(4, np.float32), [4])
    # the second commit adds a leaf and rewrites one
    later = np.arange(4, dtype=np.float32) + 7
    _zarr(path, "added", later[::-1].copy(), [2])
    moved = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{path}/",
                                                   "path": "moved"}}).result()
    moved.write(later).result()
    _metadata(path, [("kept",), ("moved",), ("added",)])
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/"}).result()
    with port_alone():
        store = orbax.Store(str(path))
        got = orbax.load_orbax(str(path))
    assert store.generation > 1 and len(kv.list().result()) == len(store.entries)
    _same(got, {"kept": first, "moved": later, "added": later[::-1]})


def test_reader_refuses_a_corrupted_node_naming_the_file(tmp_path):
    path = tmp_path / "bad"
    _orbax_save({"w": np.arange(12, dtype=np.float32)}, path)
    with port_alone():
        root = orbax.Store(str(path)).root_node
    node = path / root.file.path
    raw = bytearray(node.read_bytes())
    raw[root.offset + 20] ^= 0x40
    node.write_bytes(bytes(raw))
    with port_alone(), pytest.raises(orbax.OrbaxFormatError, match="CRC-32C mismatch") as err:
        orbax.load_orbax(str(path))
    assert str(node) in str(err.value)


@pytest.mark.parametrize("case", ["float64", "zarr3", "list"])
def test_reader_refuses_what_it_does_not_take_by_name(tmp_path, case):
    path = tmp_path / case
    if case == "float64":
        _orbax_save({"odd": np.ones(3, np.float64)}, path)
        message = "leaf odd: dtype '<f8' is not read"
    else:
        with port_alone():
            orbax.save_orbax({"w": np.ones(3, np.float32)}, str(path))
        meta = json.loads((path / "_METADATA").read_text())
        if case == "zarr3":
            meta["use_zarr3"] = True
            message = "use_zarr3 True"
        else:  # a sequence index among the keys
            meta["tree_metadata"]["('w',)"]["key_metadata"][0]["key_type"] = 1
            message = "leaf w is not an array under dict keys"
        (path / "_METADATA").write_text(json.dumps(meta))
    with port_alone(), pytest.raises(ValueError, match=message.replace("(", r"\(")):
        orbax.load_orbax(str(path))


# --- the writer -----------------------------------------------------------------------

def _every_dtype(seed):
    rng = np.random.RandomState(seed)
    return {
        "f32": rng.randn(64, 33).astype(np.float32), "f16": rng.randn(5).astype(np.float16),
        "bf16": torch.from_numpy(rng.randn(4, 3).astype(np.float32)).to(torch.bfloat16),
        "scalar": np.float32(-1.25), "flag": rng.rand(7) > 0.5,
        "ints": {name: (rng.randn(9) * 50).astype(name)
                 for name in ("int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
                              "uint64")},
    }


def test_save_orbax_round_trips_every_dtype(tmp_path):
    tree = _every_dtype(3)
    with port_alone():
        orbax.save_orbax(tree, str(tmp_path / "rt"))
        got = orbax.load_orbax(str(tmp_path / "rt"))
    want = dict(tree, bf16=np.asarray(jnp.asarray(tree["bf16"].float().numpy(), jnp.bfloat16)),
                scalar=np.asarray(tree["scalar"]))
    _same(got, want)
    assert sorted(os.listdir(tmp_path)) == ["rt"]  # the temporary sibling renamed away


def test_orbax_and_the_jax_package_read_the_ports_directory_bitwise(tmp_path):
    tree = _every_dtype(4)
    with port_alone():
        orbax.save_orbax(tree, str(tmp_path / "port"))
    want = dict(tree, bf16=np.asarray(jnp.asarray(tree["bf16"].float().numpy(), jnp.bfloat16)),
                scalar=np.asarray(tree["scalar"]))
    restored = ocp.StandardCheckpointer().restore(str(tmp_path / "port"))
    _same(jax.tree.map(np.asarray, restored), want)
    _same(jax.tree.map(np.asarray, jax_weights.load_params(str(tmp_path / "port"), None)), want)


def test_jax_mesh_restore_places_the_ports_clip_tree(tmp_path):
    """The JAX package's ``load_orbax`` with a 4 x 2 mesh builds its target
    from the checkpoint's metadata and restores each leaf under
    ``clip_vit_param_specs``."""
    tree = clip_convert.params_to_jax(_clip().state_dict())
    with port_alone():
        orbax.save_orbax(tree, str(tmp_path / "clip"))
    mesh = make_mesh(jax.devices(), data=4, model=2)
    sharded = jax_weights.load_orbax(str(tmp_path / "clip"), mesh, clip_vit_param_specs)
    specs = dict((jax.tree_util.keystr(p), s) for p, s in jax.tree_util.tree_leaves_with_path(
        clip_vit_param_specs(tree), is_leaf=lambda x: isinstance(x, P)))
    leaves = jax.tree_util.tree_leaves_with_path(sharded)
    assert len(leaves) == len(specs)
    assert any(leaf.sharding.spec != P() for _, leaf in leaves)
    for path, leaf in leaves:
        assert leaf.sharding.spec == specs[jax.tree_util.keystr(path)]
    _same(jax.tree.map(np.asarray, sharded), tree)


def test_save_orbax_refuses_an_existing_dst(tmp_path):
    (tmp_path / "taken").mkdir()
    with port_alone(), pytest.raises(FileExistsError, match="orbax dst already exists"):
        orbax.save_orbax({"w": np.ones(2, np.float32)}, str(tmp_path / "taken"))
    assert not list((tmp_path / "taken").iterdir())


def test_a_zstd_library_that_does_not_load_is_named(monkeypatch, tmp_path):
    monkeypatch.setattr(orbax, "ZSTD_LIBRARY", "libzstd-missing.so.1")
    orbax._zstd.cache_clear()
    try:
        with port_alone(), pytest.raises(RuntimeError, match="libzstd-missing.so.1"):
            orbax.save_orbax({"w": np.ones(2, np.float32)}, str(tmp_path / "w"))
    finally:
        orbax._zstd.cache_clear()
    assert not list(tmp_path.iterdir())


# --- the converter CLI ------------------------------------------------------------------

def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_convert_weights_script",
                                                  ROOT / "scripts" / "convert_weights.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_converter_cli_writes_an_orbax_directory_the_jax_script_restores_alike(
        monkeypatch, tmp_path, capsys):
    src = tmp_path / "resnet18.pth"
    torch.save(seeded_resnet("resnet18", 2).state_dict(), src)
    ours, theirs = tmp_path / "port_orbax", tmp_path / "jax_orbax"
    with port_alone():
        assert convert_weights.main(["--feature_type", "resnet18", "--format", "orbax",
                                     str(src), str(ours)]) == 0
    assert capsys.readouterr().out == f"{src} -> {ours}: 11.7M params\n"
    monkeypatch.setattr(sys, "argv", ["convert_weights.py", "--feature_type", "resnet18",
                                      "--format", "orbax", str(src), str(theirs)])
    _jax_script().main()
    unused = functools.partial(jax_resnet_convert.convert_state_dict, arch="resnet18")
    got = jax_weights.load_params(str(ours), unused)
    _same(jax.tree.map(np.asarray, got),
          jax.tree.map(np.asarray, jax_weights.load_params(str(theirs), unused)))
