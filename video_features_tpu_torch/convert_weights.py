"""Convert a reference checkpoint into the JAX package's Flax ``.msgpack``
or orbax checkpoint directory, without JAX.

The port's counterpart of the JAX package's ``scripts/convert_weights.py``:
it loads ``src`` as an extractor would (a reference state dict through the
family's ``convert_state_dict``, or an already-converted ``.msgpack``/orbax
tree), turns the port's state dict into the JAX package's param tree
(``params_to_jax``) and writes it with ``flax_msgpack.save_msgpack`` or
``orbax.save_orbax`` (the port's own codecs). Either package's
``--weights_path`` then reads the file or directory. The output format
follows the JAX script's rules: ``--format``, else a ``.msgpack`` suffix
for a file and no suffix for an orbax directory; any other suffix needs
``--format``, and an existing orbax ``dst`` is refused, both before
``src`` is read.

Usage:
  python -m video_features_tpu_torch.convert_weights --feature_type resnet50 \\
      resnet50-0676ba61.pth resnet50.msgpack
  python -m video_features_tpu_torch.convert_weights --feature_type i3d \\
      i3d_flow.pt i3d_flow.msgpack
  python -m video_features_tpu_torch.convert_weights --feature_type CLIP-ViT-B/32 \\
      ViT-B-32.pt ./weights/clip_b32_orbax
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
from typing import Callable, Tuple

from video_features_tpu_torch.config import (
    CLIP_FEATURE_TYPES,
    FEATURE_TYPES,
    RESNET_FEATURE_TYPES,
    VGGISH_FEATURE_TYPES,
)


def converters(feature_type: str) -> Tuple[Callable, Callable, Callable]:
    """(convert_state_dict, params_from_jax, params_to_jax) of a feature
    type's family; I3D's serve both its streams (one checkpoint each)."""
    if feature_type in CLIP_FEATURE_TYPES:
        from video_features_tpu_torch.models.clip import convert
        from video_features_tpu_torch.models.clip.model import CONFIGS

        to_port = functools.partial(convert.convert_state_dict,
                                    layers=CONFIGS[feature_type].layers)
        return to_port, convert.params_from_jax, convert.params_to_jax
    if feature_type in RESNET_FEATURE_TYPES:
        from video_features_tpu_torch.models.resnet import convert

        return (functools.partial(convert.convert_state_dict, arch=feature_type),
                functools.partial(convert.params_from_jax, arch=feature_type),
                convert.params_to_jax)
    if feature_type in VGGISH_FEATURE_TYPES:
        from video_features_tpu_torch.models.vggish import convert
    elif feature_type == "r21d_rgb":
        from video_features_tpu_torch.models.r21d import convert
    elif feature_type == "raft":
        from video_features_tpu_torch.models.raft import convert
    elif feature_type == "pwc":
        from video_features_tpu_torch.models.pwc import convert
    elif feature_type == "i3d":
        from video_features_tpu_torch.models.i3d import convert
    else:
        raise SystemExit(f"unknown feature_type: {feature_type}")
    return convert.convert_state_dict, convert.params_from_jax, convert.params_to_jax


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--feature_type", required=True, choices=FEATURE_TYPES)
    ap.add_argument("src", help="source checkpoint (.pt/.pth/.pytorch/.bin/.npz, or an "
                                "already-converted .msgpack / orbax directory)")
    ap.add_argument("dst", help="output: a .msgpack file, or an orbax checkpoint directory")
    ap.add_argument("--format", choices=["msgpack", "orbax"], default=None,
                    help="output format; default infers from dst (.msgpack suffix -> msgpack, "
                         "otherwise an orbax directory)")
    args = ap.parse_args(argv)

    # dst is checked before the (possibly multi-GB) load and conversion
    if args.format is not None:
        as_msgpack = args.format == "msgpack"
    else:
        as_msgpack = args.dst.endswith(".msgpack")
        if not as_msgpack and os.path.splitext(os.path.basename(args.dst))[1]:
            raise SystemExit(f"dst {args.dst!r} has a file-like suffix but isn't .msgpack — "
                             "pass --format msgpack or --format orbax")
    if not as_msgpack and os.path.exists(args.dst):
        raise SystemExit(f"orbax dst already exists: {args.dst}")

    from video_features_tpu_torch.models.common.flax_msgpack import save_msgpack
    from video_features_tpu_torch.models.common.orbax import save_orbax
    from video_features_tpu_torch.models.common.weights import load_params

    to_port, from_jax, to_jax = converters(args.feature_type)
    params = to_jax(load_params(args.src, to_port, from_jax))
    (save_msgpack if as_msgpack else save_orbax)(params, args.dst)
    n = sum(x.size for x in _leaves(params))
    print(f"{args.src} -> {args.dst}: {n / 1e6:.1f}M params")
    return 0


if __name__ == "__main__":
    sys.exit(main())
