"""Whether the card's free memory moves a one-process mesh's features.

    python3 scripts/mesh_exactness_probe.py [--free_gib 24 16 12 10 8 6]

Runs ``chip_smoke.py``'s phase-24 reference, the one-process mesh
``--device_ids 0 0`` of CLIP-ViT-B/32 ``uni_12 --attn flash`` and I3D +
PWC on one 65-frame clip with deterministic cuDNN, first on an idle card,
then again under a ballast tensor that leaves each ``--free_gib`` GiB of
the card free, and prints each file's largest difference from the first
run (or the run's failure). cuDNN's plans are picked by heuristics
(``cudnn.benchmark`` off), but PyTorch tries them in order and passes
over a plan whose workspace it cannot allocate, so a full card can pick
another plan and move the sums' rounding. The peak memory the run
reserves is printed beside it. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import gc
import glob
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

GIB = 1 << 30


def features(out: str):
    return {os.path.basename(f): np.load(f)
            for f in sorted(glob.glob(os.path.join(out, "**", "*.npy"), recursive=True))}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--free_gib", type=float, nargs="+", default=[24, 16, 12, 10, 8, 6])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from video_features_tpu_torch import cli
    from video_features_tpu_torch.utils.synth import synth_video

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip().splitlines()[0] if card.strip() else 'not read'}")
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory() as root:
        clip = synth_video(os.path.join(root, "i3d65.mp4"), n_frames=65, seed=9)

        def run(label: str):
            out = os.path.join(root, label)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            cli.main(["--feature_types", "CLIP-ViT-B/32", "i3d", "--extract_method", "uni_12",
                      "--attn", "flash", "--flow_type", "pwc", "--allow_random_init",
                      "--on_extraction", "save_numpy", "--strict", "--sharding", "mesh",
                      "--tmp_path", os.path.join(root, "tmp"), "--device_ids", "0", "0",
                      "--output_path", out, "--video_paths", clip])
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_reserved() / GIB
            print(f"{label}: {time.perf_counter() - t0:.1f} s, peak reserved {peak:.2f} GiB")
            return features(out)

        ref = run("idle")
        again = run("idle_again")
        print("idle_again: " + ", ".join(
            f"{n} {float(np.abs(again[n] - ref[n]).max()):.3e}" for n in sorted(ref)))
        for free in args.free_gib:
            gc.collect()
            torch.cuda.empty_cache()
            have, _ = torch.cuda.mem_get_info()
            ballast = torch.empty(max(int(have - free * GIB), 0), dtype=torch.uint8,
                                  device="cuda")
            left = torch.cuda.mem_get_info()[0] / GIB
            try:
                got = run(f"free_{free:g}")
                diffs = ", ".join(f"{n} {float(np.abs(got[n] - ref[n]).max()):.3e}"
                                  for n in sorted(ref))
                print(f"free {left:.2f} GiB: {diffs}")
            except BaseException as e:  # noqa: BLE001 - a full card may fail the run
                print(f"free {left:.2f} GiB: the run failed: {type(e).__name__}: "
                      f"{str(e).splitlines()[0][:200] if str(e) else ''}")
            del ballast
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
