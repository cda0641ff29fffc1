"""CLI: ``python -m video_features_tpu_torch --feature_type <X> ...`` (or
the ``video-features-tpu-torch`` script).

The JAX package's flags and output files (``video_features_tpu/cli.py``).
The run goes to ``cuda:<device_ids[0]>``, or to the CPU with ``--cpu``.
"""

from __future__ import annotations

import sys

from video_features_tpu_torch.config import parse_args
from video_features_tpu_torch.devices import resolve_device
from video_features_tpu_torch.extract.registry import build_extractor


def main(argv=None) -> None:
    cfg = parse_args(sys.argv[1:] if argv is None else list(argv))
    device = resolve_device(cfg)  # raises before any work when CUDA is absent
    if cfg.on_extraction in ("save_numpy", "save_pickle"):
        print(f"Saving features to {cfg.output_path}")
    build_extractor(cfg)(device=device)
