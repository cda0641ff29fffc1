"""Count the kernel records a ``torch.profiler`` trace keeps as a process ages.

    python3 scripts/profiler_trace_loss.py [--probes 8] [--gap 14]

Each probe opens three profiler sessions in turn, each around 40 launches
of one scan kernel (20, a 50 ms pause, 20): ``nosync`` stops the profiler
right after the launches, ``sync`` after ``torch.cuda.synchronize()``,
``pad`` also sleeps 50 ms before the launches and after the
synchronize. It exports each session's Chrome trace and prints how many
of the 40 launches the trace holds. Between probes the card runs the same
kernel unprofiled for ``--gap`` seconds. A trace that holds fewer than 40
has lost records; ``chip_smoke.py`` takes its ``--profile_dir`` traces in
a fresh process for that reason. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

LAUNCHES = 40


def kernels_in(path: str) -> int:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events if str(e.get("cat", "")).lower() == "kernel")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--probes", type=int, default=8)
    parser.add_argument("--gap", type=float, default=14.0, help="seconds of unprofiled work")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profiler_trace_loss: no CUDA device visible")
        return 1
    x = torch.randn(1024, 1024, device="cuda")

    def burst(n: int) -> None:
        for _ in range(n):
            torch.cumsum(x, dim=0)

    out = tempfile.mkdtemp(prefix="trace_loss_")
    t_start = time.time()
    for probe in range(args.probes):
        row = []
        for mode in ("nosync", "sync", "pad"):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                if mode == "pad":
                    time.sleep(0.05)
                burst(LAUNCHES // 2)
                time.sleep(0.05)
                burst(LAUNCHES // 2)
                if mode != "nosync":
                    torch.cuda.synchronize()
                if mode == "pad":
                    time.sleep(0.05)
            path = os.path.join(out, f"probe{probe}-{mode}.json")
            prof.export_chrome_trace(path)
            row.append(f"{mode} {kernels_in(path)}/{LAUNCHES}")
        print(f"process age {time.time() - t_start:7.1f} s, probe {probe}: " + ", ".join(row),
              flush=True)
        t0 = time.time()
        while time.time() - t0 < args.gap:
            burst(200)
            torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
