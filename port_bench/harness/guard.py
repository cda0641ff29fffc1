"""The import guard: the benchmark drives the PyTorch port only, so no
module of JAX or of the JAX package may be loaded in its process. Names are
compared by their whole top-level part (before the first dot):
``video_features_tpu_torch`` starts with the JAX package's name and is not
it."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "video_features_tpu"})


def forbidden_loaded(modules: Iterable[str] = ()) -> List[str]:
    names = modules or list(sys.modules)
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
