"""CLI: ``python -m video_features_tpu_torch --feature_type <X> ...`` (or
the ``video-features-tpu-torch`` script), and ``... serve ...``.

The JAX package's flags and output files (``video_features_tpu/cli.py``).
The run goes to the ``--device_ids`` CUDA devices (every visible one by
default) or to the CPU with ``--cpu``: one worker per device over a
shared queue of videos (``--sharding queue``), or one sharded forward
over a (data, model) mesh of them (``--sharding mesh``, every family:
data parallel, or the frame axis with halos for RAFT, PWC and I3D;
``parallel/scheduler.py``). ``--feature_types A B ...`` runs several
models over the same videos, one after another, with the shared-decode
frame cache installed (``extract/plan.py::run_multi``): each clip is
decoded once. After the run, every
record under ``<output_path>/_manifest/`` is merged into
``summary.json``, with the run's telemetry block, and its one-line
outcome printed; with ``--strict`` a failed video, an empty-feature
warning or a worker death exits nonzero.

Under a launcher (``torchrun``: ``WORLD_SIZE`` > 1) ``--sharding mesh``
joins one ``torch.distributed`` group for the whole run
(``parallel/distributed.py``): every process walks the same videos over
one global mesh and only rank 0 writes; queue mode makes no group, each
process running its strided share of the videos.

``serve [warmup] ...`` starts the long-lived daemon
(``serve/daemon.py::serve_main``) on the same device rules; its exit
code is 1 after a sticky device error stopped it.
"""

from __future__ import annotations

import sys

from video_features_tpu_torch.config import parse_batch_args
from video_features_tpu_torch.extract.plan import run_multi
from video_features_tpu_torch.parallel import distributed
from video_features_tpu_torch.parallel.devices import resolve_devices
from video_features_tpu_torch.runtime.faults import finalize_run, format_summary, strict_failures


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "serve":
        # the long-lived daemon (serve/): loads models once, keeps them
        # resident, serves requests over HTTP and/or a spool dir;
        # `serve warmup ...` runs the declared warmup pairs and exits
        from video_features_tpu_torch.serve.daemon import serve_main

        return serve_main(argv[1:])
    cfg, feature_types = parse_batch_args(argv)
    # a launched mesh joins its process group before any device work, and
    # leaves it when the whole --feature_types loop is over
    joined = distributed.initialize(cfg)
    try:
        summary = _run(cfg, feature_types)
    finally:
        if joined:
            distributed.shutdown()
    if cfg.strict and summary is not None:
        problems = strict_failures(summary)
        if problems:
            raise SystemExit(
                f"--strict: run completed with {len(problems)} problem(s):\n  "
                + "\n  ".join(problems)
            )


def _run(cfg, feature_types):
    """The batch run: every feature type over the videos, then the
    manifest merged into ``summary.json`` (returned, None without a
    manifest)."""
    resolve_devices(cfg)  # raises before any work: no CUDA, or an id out of range
    if cfg.on_extraction in ("save_numpy", "save_pickle"):
        print(f"Saving features to {cfg.output_path}")
    if cfg.keep_tmp_files:
        print(f"Keeping temp files in {cfg.tmp_path}")
    summary = None
    built = []
    try:
        run_multi(cfg, feature_types, built=built)
        # every process's records are written before any of them merges
        distributed.barrier()
    finally:
        # the merge happens even when the run raised, so a crashed run
        # still leaves a record of what completed; one <output>/_manifest
        # covers every model's pass
        if any(ext.manifest.path is not None for ext in built):
            summary = finalize_run(cfg.output_path)
            if summary is not None:
                print(format_summary(summary))
    return summary
