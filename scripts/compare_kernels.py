"""Time the port's CUDA kernels against an earlier version of their sources
on one card, on the same inputs, in turns.

    git show <commit>:video_features_tpu_torch/csrc/flash_attention.cu > _old_kernels/flash_attention.cu
    git show <commit>:video_features_tpu_torch/csrc/local_correlation.cu > _old_kernels/local_correlation.cu
    python3 scripts/compare_kernels.py --old _old_kernels

``_old_kernels/`` is git-ignored; the earlier sources are never committed.
The earlier K1 keeps today's C entry point; the earlier K2 is the one
before launch shapes were chosen by the wrapper (no tile arguments).

For every phase-3 case of ``chip_smoke.py`` (K1 at its six shapes, K2 at
PWC's five level shapes, the ragged case and bf16) it builds both versions
(one ``nvcc`` per source, all at once), holds each against the plain
version, and takes each one's device time from a ``torch.profiler`` trace
of 20 launches, in the order old, new, new, old; it prints one line per
case and a JSON line of the means. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from video_features_tpu_torch.ops import kernels  # noqa: E402
from video_features_tpu_torch.ops.correlation import local_correlation_reference  # noqa: E402
from video_features_tpu_torch.ops.correlation_kernel import local_correlation_kernel  # noqa: E402
from video_features_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_reference,
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def build_old(src: pathlib.Path) -> ctypes.CDLL:
    out = src.parent / "_build" / f"lib{src.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([kernels.nvcc(), *kernels.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out))


def old_attention(lib):
    fn = lib.vft_flash_attention_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(q, k, v, kv_len, out):
        n, h, lq, d = q.shape
        lk = k.shape[2]
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), n * h, lq, lk,
                 lk if kv_len is None else kv_len, d, _DTYPES[q.dtype], d ** -0.5,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old flash_attention: CUDA error {err}")
        return out

    return run


def old_correlation(lib):
    fn = lib.vft_local_correlation_forward
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(f1, f2, out):
        n, c, h, w = f1.shape
        err = fn(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), n, c, h, w, _DTYPES[f1.dtype],
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old local_correlation: CUDA error {err}")
        return out

    return run


def device_us(fn, name: str) -> float:
    traced = chip_smoke.device_kernels(fn, iters=20)
    return sum(ms for key, (ms, _) in traced.items() if name in key) * 1e3


def in_turns(old, new, name):
    """(old us, new us): device time in the order old, new, new, old."""
    a = device_us(old, name)
    b = device_us(new, name)
    b2 = device_us(new, name)
    a2 = device_us(old, name)
    return (a + a2) / 2, (b + b2) / 2


def report(r: dict) -> dict:
    print(f"{r['kernel']} {r['case']}: old {r['old_us']:.2f} us, new {r['new_us']:.2f} us "
          f"on the device ({r['old_us'] / max(r['new_us'], 1e-9):.2f}x); max_abs_err old "
          f"{r['old_err']:.3e}, new {r['new_err']:.3e}", flush=True)
    return r


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", required=True, type=pathlib.Path,
                        help="directory holding the earlier flash_attention.cu and "
                             "local_correlation.cu")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device visible", file=sys.stderr)
        return 1
    from video_features_tpu_torch.devices import pin_fp32

    pin_fp32()
    print(chip_smoke.card_line())
    device = torch.device("cuda", torch.cuda.current_device())
    with ThreadPoolExecutor(max_workers=4) as pool:
        new = pool.submit(kernels.build_all)
        olds = {name: pool.submit(build_old, args.old / f"{name}.cu")
                for name in ("flash_attention", "local_correlation")}
        new.result()
        for name in kernels.sources():  # registers, shared memory, spills
            log = kernels.library_path(name).with_suffix(".so.log").read_text()
            print("\n".join(f"{name}: {line.strip()}" for line in log.splitlines()
                            if "registers" in line or "spill" in line))
        old_attn = old_attention(olds["flash_attention"].result())
        old_corr = old_correlation(olds["local_correlation"].result())

    rows = []
    for i, (shape, dtype, kv_len) in enumerate(chip_smoke.ATTENTION_CASES):
        rng = np.random.default_rng(i)
        q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)
                   for _ in range(3))
        ref = flash_attention_reference(q, k, v, kv_len=kv_len).float()
        out_old = torch.empty_like(q)
        errs = [(f(q, k, v).float() - ref).abs().max().item() for f in (
            lambda q, k, v: old_attn(q, k, v, kv_len, out_old),
            lambda q, k, v: flash_attention(q, k, v, kv_len=kv_len))]
        us = in_turns(lambda: old_attn(q, k, v, kv_len, out_old),
                      lambda: flash_attention(q, k, v, kv_len=kv_len), "flash_attention")
        rows.append(report(dict(kernel="flash_attention",
                                case=f"{shape} {str(dtype)[6:]} kv_len={kv_len}",
                                old_us=us[0], new_us=us[1], old_err=errs[0], new_err=errs[1])))
    for i, (label, shape, dtype) in enumerate(chip_smoke.CORRELATION_CASES):
        rng = np.random.default_rng(100 + i)
        f1, f2 = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)
                  for _ in range(2))
        ref = local_correlation_reference(f1, f2).float()
        out_old = torch.empty((shape[0], 81, shape[2], shape[3]), dtype=dtype, device=device)
        errs = [(f().float() - ref).abs().max().item() for f in (
            lambda: old_corr(f1, f2, out_old), lambda: local_correlation_kernel(f1, f2))]
        us = in_turns(lambda: old_corr(f1, f2, out_old),
                      lambda: local_correlation_kernel(f1, f2), "local_correlation")
        rows.append(report(dict(kernel="local_correlation",
                                case=f"{label} {shape} {str(dtype)[6:]}",
                                old_us=us[0], new_us=us[1], old_err=errs[0], new_err=errs[1])))
    print(json.dumps({"compare": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
