"""Time the host's read of a full-width converted checkpoint in each format.

    python3 scripts/weights_read_timing.py [--repeats 3]

Seeds CLIP-ViT-B/32's tower (the port's ``init_weights``), turns its
state dict into the JAX package's tree (``params_to_jax``) and writes it
with the port's
``save_msgpack`` and ``save_orbax`` into a temporary directory. Then it
reads each file back, ``--repeats`` times in turns, with the port's
``load_msgpack`` and ``load_orbax`` and, where ``tensorstore`` imports,
through tensorstore's own zarr reader over the same OCDBT store. It prints
each reader's best wall time in ms and the host's CPU count. The reads
are warm (the files were just written), and the times are the host's:
no device is involved.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from video_features_tpu_torch.models.clip import convert, model  # noqa: E402
from video_features_tpu_torch.models.common.flax_msgpack import (  # noqa: E402
    load_msgpack,
    save_msgpack,
)
from video_features_tpu_torch.models.common.orbax import load_orbax, save_orbax  # noqa: E402

FEATURE_TYPE = "CLIP-ViT-B/32"


def read_tensorstore(path: str) -> None:
    """Every leaf of the orbax directory at ``path`` through tensorstore."""
    import tensorstore as ts

    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    ctx = ts.Context()
    for entry in meta["tree_metadata"].values():
        name = ".".join(k["key"] for k in entry["key_metadata"])
        kvstore = {"driver": "ocdbt", "base": f"file://{path}/", "path": name}
        store = ts.open({"driver": "zarr", "kvstore": kvstore}, open=True, read=True,
                        context=ctx).result()
        np.asarray(store.read().result())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    tower = model.init_weights(model.VisionTransformer(model.CONFIGS[FEATURE_TYPE]), seed=0)
    tree = convert.params_to_jax(tower.state_dict())
    with tempfile.TemporaryDirectory() as root:
        files = {"msgpack": os.path.join(root, "w.msgpack"), "orbax": os.path.join(root, "w")}
        save_msgpack(tree, files["msgpack"])
        save_orbax(tree, files["orbax"])
        readers = {"msgpack": lambda: load_msgpack(files["msgpack"]),
                   "orbax": lambda: load_orbax(files["orbax"])}
        try:
            import tensorstore  # noqa: F401 - only whether it imports
            readers["tensorstore"] = lambda: read_tensorstore(files["orbax"])
        except ImportError:
            pass
        best = {name: float("inf") for name in readers}
        for _ in range(args.repeats):
            for name, read in readers.items():
                t0 = time.perf_counter()
                read()
                best[name] = min(best[name], (time.perf_counter() - t0) * 1e3)
        sizes = {fmt: sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(p)
                          for f in fs) if os.path.isdir(p) else os.path.getsize(p)
                 for fmt, p in files.items()}
    print(f"{FEATURE_TYPE}: {sum(np.asarray(x).size for x in _leaves(tree)) / 1e6:.1f}M "
          f"params; msgpack {sizes['msgpack'] / 2**20:.1f} MiB, orbax "
          f"{sizes['orbax'] / 2**20:.1f} MiB; {os.cpu_count()} CPUs")
    for name, ms in best.items():
        print(f"  {name}: best of {args.repeats} {ms:.1f} ms")
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
