"""The control of a cell's check: the plain reference put in the program's
place, computed one precision below the configuration's (fp32 with TF32
on, where the configuration states fp32 with TF32 off), and held to the
same numbers as a run: each stream's worst per-stack relative L2 distance
from the reference at its own precision. A limit sits below what this
reads and above what sound runs of the program read.

    python3 port_bench/control.py --workload <cell> --seeds <n> [<n> ...]

Per seed it makes the run's inputs (clips and weights) and compares
``check_videos`` distinct clips at the cell's own sizes; one JSON line a
seed. Needs a CUDA card: TF32 exists only there.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_readings(workload: str, seed: int, videos: int = 0) -> dict:
    import torch

    from port_bench.harness import compare, spec
    from port_bench.harness.inputs import make_weights
    from port_bench.reference import pipeline
    from port_bench.traffic.generator import make_clips

    cell = spec.workload(workload)
    config = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    device = torch.device("cuda:0")
    work = pathlib.Path(tempfile.mkdtemp(prefix="port_bench-control-",
                                         dir=os.environ.get("TMPDIR")))
    try:
        clips = make_clips(mix, seed, str(work / "clips"))[:videos or int(cell["check_videos"])]
        make_weights(config, seed, str(work / "weights"), device)
        worst = {k: 0.0 for k in cell["limits"]}
        feats = {}
        for tf32 in (False, True):
            with pipeline.precision(tf32):
                models = pipeline.load_models(config, str(work / "weights"), device)
                feats[tf32] = [pipeline.video_features(c, models, config, device) for c in clips]
                del models
                torch.cuda.empty_cache()
        for ref, low in zip(feats[False], feats[True]):
            for stream in ("rgb", "flow"):
                key = f"{stream}_rel_l2"
                worst[key] = max(worst[key], compare.rel_l2_rows(low[stream], ref[stream]))
        return {"workload": workload, "seed": seed, "videos": len(clips), **worst}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--videos", type=int, default=0, help="clips a seed (default: the cell's)")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA card (TF32)", file=sys.stderr)
        return 3
    for seed in args.seeds:
        print(json.dumps(control_readings(args.workload, seed, args.videos)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
