"""CLI: ``python -m video_features_tpu_torch --feature_type <X> ...`` (or
the ``video-features-tpu-torch`` script).

The JAX package's flags and output files (``video_features_tpu/cli.py``).
The run goes to ``cuda:<device_id>`` (one), or to the CPU with ``--cpu``.
After the run, every record under ``<output_path>/_manifest/`` is merged
into ``summary.json``, with the run's telemetry block, and its one-line
outcome printed; with ``--strict`` a failed video, an empty-feature
warning or a worker death exits nonzero.
"""

from __future__ import annotations

import sys

from video_features_tpu_torch.config import parse_args
from video_features_tpu_torch.devices import resolve_device
from video_features_tpu_torch.extract.registry import build_extractor
from video_features_tpu_torch.runtime.faults import finalize_run, format_summary, strict_failures


def main(argv=None) -> None:
    cfg = parse_args(sys.argv[1:] if argv is None else list(argv))
    device = resolve_device(cfg)  # raises before any work when CUDA is absent
    if cfg.on_extraction in ("save_numpy", "save_pickle"):
        print(f"Saving features to {cfg.output_path}")
    if cfg.keep_tmp_files:
        print(f"Keeping temp files in {cfg.tmp_path}")
    extractor = build_extractor(cfg)
    summary = None
    try:
        extractor(device=device)
    finally:
        # the last telemetry drain goes before the merge, so summary.json's
        # telemetry block covers the whole run; both happen even when the
        # run raised, so a crashed run still leaves a record of what completed
        extractor.telemetry.close()
        if extractor.manifest.path is not None:
            summary = finalize_run(cfg.output_path)
            if summary is not None:
                print(format_summary(summary))
    if cfg.strict and summary is not None:
        problems = strict_failures(summary)
        if problems:
            raise SystemExit(
                f"--strict: run completed with {len(problems)} problem(s):\n  "
                + "\n  ".join(problems)
            )
