"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no ``ok`` line:

1. the card's name and power limit (nvidia-smi);
2. build every kernel of ``video_features_tpu_torch/csrc`` (timed);
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, and time the kernel, the plain version, one
   PyTorch library call computing the same function (a yardstick only,
   never called by the port) and the least time the card could take,
   with that bound's share of the kernel's time (K1 also at L=65, one
   row past a KV tile, and at d=128);
4. the CLIP path through the port's CLI: CLIP-ViT-B/32 at full width
   (768 wide, 12 layers, 12 heads, 224 px, patch 32, 512-d), ``uni_12``,
   ``--attn flash``, seeded random weights, on 4 synthetic clips; checks
   the .npy files, K1's launch count (4 videos x 12 layers), the
   features against ``--attn fused`` on the card and against the port's
   CPU run, and prints videos/s;
5. the I3D path through the port's CLI: ``--feature_type i3d --flow_type
   pwc`` at full width (I3D rgb and flow, PWC-Net), default 64/64
   stacks, seeded random weights, on 2 synthetic 320x240 clips of 129
   frames (2 stacks each); checks the ``_rgb``/``_flow`` .npy files, K2's
   launch count (2 videos x 2 stacks x 5 pyramid levels), PWC's flow and
   the flow features with K2 against the plain cost volume on the card,
   and the features on the card against the port's CPU run; prints the
   warm videos/s split into host and forward, and one stack's top device
   kernels with K2's share;
6. the PWC path through the port's CLI: ``--feature_type pwc
   --batch_size 8`` on a 60-frame clip; checks the (59, 2, 240, 320) flow
   and K2's launch count (8 windows x 5 levels);
7. a ``kernels`` JSON line, then the ``ok`` JSON line last.

Every launch count is read from a run that starts with all counts at 0.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by
# type. fp32 work has a faster route than the CUDA cores' 67 TFLOP/s: three
# TF32 tensor-core products (big*big + big*small + small*big) at 495 TFLOP/s
# give fp32 accuracy at 165 TFLOP/s, so that is the fp32 operations term
# of every bound, whichever unit a kernel uses
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}

# kernel vs plain version on the same inputs: fp32 differs only in the
# order of its sums; bf16 outputs are rounded to bf16 (one ulp near 1 is
# 2^-7), so the bound is about one ulp
KERNEL_ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# features of the 12-layer tower, flash vs fused core (both exact fp32
# attention) and card vs CPU (other sum orders in every matmul), for
# features of unit scale
FEATURE_ATOL = 1e-3

N_VIDEOS = 4
FRAMES = 12
LAYERS = 12

# PWC's five cost volumes on the I3D main path: a 65-frame stack of
# 320x240 video, resized to 256x341 and stretched to 256x384, 64 pairs;
# (level, C, H, W)
PAIRS = 64
CORR_LEVELS = [(2, 32, 64, 96), (3, 64, 32, 48), (4, 96, 16, 24), (5, 128, 8, 12),
               (6, 196, 4, 6)]
# K1's cases in phase 3: (shape, dtype, kv_len); the first is the main path
ATTENTION_CASES = [
    ((16, 12, 50, 64), torch.float32, None),  # the main path: B/32, uni_12
    ((16, 12, 197, 64), torch.float32, None),  # B/16
    ((16, 12, 50, 64), torch.float32, 37),  # ragged KV
    ((16, 12, 50, 64), torch.bfloat16, None),
    ((16, 12, 65, 64), torch.float32, None),  # one row past a KV tile: two stages
    ((16, 12, 197, 128), torch.float32, None),  # d=128, the most shared memory
]
# K2's cases in phase 3: (label, shape, dtype); the levels are the main path
CORRELATION_CASES = [(f"level {lvl}", (PAIRS, c, h, w), torch.float32)
                     for lvl, c, h, w in CORR_LEVELS]
CORRELATION_CASES += [("ragged", (PAIRS, 32, 67, 121), torch.float32),
                      ("level 2 bf16", (PAIRS, 32, 64, 96), torch.bfloat16)]
I3D_VIDEOS = 2
I3D_CLIP_FRAMES = 129  # 2 stacks of 64 + 1 frames at step 64
I3D_STACKS = 2
STACK = 64
PWC_CLIP_FRAMES = 60
PWC_BATCH = 8
# I3D features, relative L2 error of fp32 sums in other orders through
# ~60 convolutions (and, card vs CPU, PWC's ~50): features are a mean of
# small activations under random weights, so the check is relative
I3D_FEATURE_RTOL = 1e-3
# PWC flow with K2 vs with the plain cost volume, relative to the flow's
# largest magnitude: the volumes differ by fp32 sum order (~1e-7)
FLOW_RTOL = 1e-4
UINT8_LEVEL = 2.0 / 255.0  # one flow level after scale_to_1_1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else "unknown"


def time_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """ms per call from CUDA events around ``iters`` back-to-back calls:
    the device's time, or the host's launch cost where that is slower."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(fn, iters: int = 1):
    """{kernel name: (device ms per iteration, launches per iteration)}
    from a torch.profiler trace of ``iters`` calls; empty when the trace
    holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us > 0:
            out[e.key] = (us / 1e3 / iters, e.count / iters)
    return out


def attention_bound(shape, dtype, kv_len):
    """(ms, 'bytes'|'operations'): q and o whole, the kv_len rows of k and
    v each moved once; 2 * 2 * Lq * kv_len * d operations per (n, h)."""
    n, h, lq, d = shape
    kv = shape[2] if kv_len is None else kv_len
    size = torch.finfo(dtype).bits // 8
    nbytes = (2 * n * h * lq * d + 2 * n * h * kv * d) * size
    ops = 4 * n * h * lq * kv * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def reset_counts():
    """Every kernel's launch count to 0, before a path is driven."""
    from video_features_tpu_torch.ops.correlation_kernel import local_correlation_kernel
    from video_features_tpu_torch.ops.flash_attention import flash_attention

    flash_attention.launches = 0
    local_correlation_kernel.launches = 0


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def flow_feature_rtol(flip_share: float, levels) -> float:
    """Tolerance on I3D-flow features whose uint8 flow levels differ in
    ``flip_share`` of their values by one. A network that keeps the scale
    of its input (LeCun-initialised convs) moves its output by about the
    input's relative change, sqrt(share) * level / rms(input), where the
    input is the levels scaled to [-1, 1]; the factor 4 is margin,
    I3D_FEATURE_RTOL the sum-order part."""
    x = 2.0 * np.asarray(levels, np.float64) / 255.0 - 1.0
    rms = float(np.sqrt(np.mean(np.square(x))))
    return I3D_FEATURE_RTOL + 4.0 * np.sqrt(flip_share) * UINT8_LEVEL / max(rms, 1e-30)


def check_flash_attention(device):
    """Phase 3 for K1; returns the main path case's record."""
    import torch.nn.functional as F

    from video_features_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    main = None
    for i, (shape, dtype, kv_len) in enumerate(ATTENTION_CASES):
        rng = np.random.default_rng(i)
        q, k, v = (
            torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)
            for _ in range(3)
        )
        out = flash_attention(q, k, v, kv_len=kv_len)
        torch.cuda.synchronize()
        ref = flash_attention_reference(q, k, v, kv_len=kv_len)
        err = (out.float() - ref.float()).abs().max().item()
        tol = KERNEL_ATOL[dtype]
        mask = None
        if kv_len is not None:
            mask = torch.arange(shape[2], device=device) < kv_len
        ms = time_ms(lambda: flash_attention(q, k, v, kv_len=kv_len))
        plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, kv_len=kv_len))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        bound_ms, bound_by = attention_bound(shape, dtype, kv_len)
        traced = device_kernels(lambda: flash_attention(q, k, v, kv_len=kv_len), iters=20)
        device_ms = sum(ms for name, (ms, _) in traced.items() if "flash_attention" in name)
        # every kernel SDPA launches, on the device
        library_device_ms = sum(ms for ms, _ in device_kernels(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), iters=20).values())
        print(
            f"flash_attention {shape} {str(dtype)[6:]} kv_len={kv_len}: "
            f"max_abs_err {err:.3e} (tol {tol:g}); kernel {ms * 1e3:.2f} us, "
            f"kernel on the device {device_ms * 1e3:.2f} us (profiler), "
            f"plain {plain_ms * 1e3:.2f} us, sdpa {library_ms * 1e3:.2f} us, "
            f"sdpa on the device {library_device_ms * 1e3:.2f} us (profiler), "
            f"bound {bound_ms * 1e3:.2f} us ({bound_by}), "
            f"{bound_share(bound_ms, device_ms or ms)} of the bound"
        )
        if not err <= tol:
            raise AssertionError(f"flash_attention disagrees with its plain version: {err}")
        if main is None:
            main = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=library_ms,
                        device_ms=device_ms or None,
                        library_device_ms=library_device_ms or None)
    return main


def bound_share(bound_ms: float, ms: float) -> str:
    """The bound as a share of the kernel's time (1 = at the bound)."""
    return f"{bound_ms / ms:.3f}" if ms > 0 else "not measured"


def correlation_bound(shape, dtype):
    """(ms, 'bytes'|'operations'): f1 and f2 read once, the 81 planes
    written once; one multiply and one add per (plane, channel, pixel)."""
    n, c, h, w = shape
    size = torch.finfo(dtype).bits // 8
    nbytes = (2 * n * c * h * w + n * 81 * h * w) * size
    ops = 2 * 81 * n * c * h * w
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_local_correlation(device):
    """Phase 3 for K2; returns the record of one stack's five cost
    volumes on the I3D main path (times and bounds summed over the five
    levels, the largest error of the five)."""
    from video_features_tpu_torch.ops.correlation import local_correlation_reference
    from video_features_tpu_torch.ops.correlation_kernel import (
        launch_shape,
        local_correlation_kernel,
    )

    stack = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, device_ms=0.0)
    bounds = []  # (ms, what sets it) of each main-path level
    for i, (label, shape, dtype) in enumerate(CORRELATION_CASES):
        rng = np.random.default_rng(100 + i)
        f1, f2 = (
            torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)
            for _ in range(2)
        )
        out = local_correlation_kernel(f1, f2)
        torch.cuda.synchronize()
        ref = local_correlation_reference(f1, f2)
        err = (out.float() - ref.float()).abs().max().item()
        tol = KERNEL_ATOL[dtype]
        ms = time_ms(lambda: local_correlation_kernel(f1, f2))
        plain_ms = time_ms(lambda: local_correlation_reference(f1, f2), iters=20, warmup=2)
        bound_ms, bound_by = correlation_bound(shape, dtype)
        traced = device_kernels(lambda: local_correlation_kernel(f1, f2), iters=20)
        device_ms = sum(ms for name, (ms, _) in traced.items() if "local_correlation" in name)
        tile = launch_shape(*shape, f1.element_size())
        print(
            f"local_correlation {label} {shape} {str(dtype)[6:]}: max_abs_err {err:.3e} "
            f"(tol {tol:g}); kernel {ms * 1e3:.2f} us, kernel on the device "
            f"{device_ms * 1e3:.2f} us (profiler), plain {plain_ms * 1e3:.2f} us, "
            f"bound {bound_ms * 1e3:.2f} us ({bound_by}), "
            f"{bound_share(bound_ms, device_ms or ms)} of the bound; {tile.staging} staging, tile "
            f"{tile.tile_h}x{tile.tile_w}, {tile.splits} channel groups, chunk {tile.chunk}, "
            f"tiles {tile.tiles}, {tile.threads} threads, {tile.smem_bytes} B shared"
        )
        if not err <= tol:
            raise AssertionError(f"local_correlation disagrees with its plain version: {err}")
        if label.startswith("level") and dtype == torch.float32:
            stack["max_abs_err"] = max(stack["max_abs_err"], err)
            stack["ms"] += ms
            stack["plain_ms"] += plain_ms
            stack["device_ms"] += device_ms
            bounds.append((bound_ms, bound_by))
    # five launches one after another: their least time is the sum of
    # theirs, set by what sets the largest
    bound_ms, bound_by = sum(b for b, _ in bounds), max(bounds)[1]
    print(f"local_correlation, one stack's five levels (fp32): kernel {stack['ms'] * 1e3:.2f} us, "
          f"on the device {stack['device_ms'] * 1e3:.2f} us, plain {stack['plain_ms'] * 1e3:.2f} "
          f"us, bound {bound_ms * 1e3:.2f} us, "
          f"{bound_share(bound_ms, stack['device_ms'] or stack['ms'])} of the bound")
    return dict(max_abs_err=stack["max_abs_err"], ms=stack["ms"], plain_ms=stack["plain_ms"],
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, device_ms=stack["device_ms"] or None)


def synth_clips(root: str):
    from video_features_tpu_torch.utils.synth import synth_video

    return [synth_video(os.path.join(root, f"clip{i}.mp4"), seed=i) for i in range(N_VIDEOS)]


def read_features(out_dir: str):
    files = sorted(glob.glob(os.path.join(out_dir, "**", "*.npy"), recursive=True))
    return {os.path.basename(f): np.load(f) for f in files}


def run_main_path(root: str):
    """Phase 4; returns K1's launches on the CLIP path's run."""
    from video_features_tpu_torch import cli
    from video_features_tpu_torch.ops.flash_attention import flash_attention

    clips = synth_clips(root)

    def argv(attn, out, *extra):
        return ["--feature_type", "CLIP-ViT-B/32", "--extract_method", f"uni_{FRAMES}",
                "--attn", attn, "--allow_random_init", "--on_extraction", "save_numpy",
                "--output_path", os.path.join(root, out), "--tmp_path",
                os.path.join(root, "tmp"), "--video_paths", *extra]

    reset_counts()
    t0 = time.perf_counter()
    cli.main(argv("flash", "flash", *clips))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention.launches

    flash = read_features(os.path.join(root, "flash"))
    if len(flash) != N_VIDEOS:
        raise AssertionError(f"expected {N_VIDEOS} .npy files, got {sorted(flash)}")
    for name, feats in flash.items():
        if feats.shape != (FRAMES, 512) or not np.isfinite(feats).all():
            raise AssertionError(f"{name}: shape {feats.shape}, finite {np.isfinite(feats).all()}")
    if launches != N_VIDEOS * LAYERS:
        raise AssertionError(f"flash_attention launched {launches} times, expected "
                             f"{N_VIDEOS * LAYERS}")
    print(f"main path (--attn flash, cold CLI run, model build included): {N_VIDEOS} videos "
          f"in {wall:.3f} s, {N_VIDEOS / wall:.3f} videos/s, {wall / N_VIDEOS * 1e3:.1f} ms/video; "
          f"flash_attention launches {launches}")

    cli.main(argv("fused", "fused", *clips))
    fused = read_features(os.path.join(root, "fused"))
    err = max(np.abs(flash[k] - fused[k]).max() for k in flash)
    print(f"features --attn flash vs --attn fused on the card: max_abs_err {err:.3e} "
          f"(tol {FEATURE_ATOL:g})")
    if not err <= FEATURE_ATOL:
        raise AssertionError(f"flash and fused features disagree: {err}")

    cli.main(argv("fused", "cpu", clips[0]) + ["--cpu"])
    (cpu_name, cpu_feats), = read_features(os.path.join(root, "cpu")).items()
    err = np.abs(flash[cpu_name] - cpu_feats).max()
    print(f"features card (--attn flash) vs the port on the CPU (--attn fused), {cpu_name}: "
          f"max_abs_err {err:.3e} (tol {FEATURE_ATOL:g})")
    if not err <= FEATURE_ATOL:
        raise AssertionError(f"card and CPU features disagree: {err}")

    from video_features_tpu_torch.config import ExtractionConfig
    from video_features_tpu_torch.extract.registry import build_extractor

    ex = build_extractor(ExtractionConfig(
        feature_type="CLIP-ViT-B/32", video_paths=clips, extract_method=f"uni_{FRAMES}",
        attn="flash", allow_random_init=True), external_call=True)
    device = torch.device("cuda", torch.cuda.current_device())
    model = ex.warmup(device)
    ex(device=device)  # first forward: cuBLAS and allocator set-up
    prep = fwd = 0.0
    for clip in clips:
        t0 = time.perf_counter()
        payload = ex.prepare(clip)
        t1 = time.perf_counter()
        ex.forward(model, payload)  # ends in a copy to the host
        prep, fwd = prep + t1 - t0, fwd + time.perf_counter() - t1
    warm = prep + fwd
    print(f"main path (--attn flash, warm extractor): {N_VIDEOS / warm:.3f} videos/s, "
          f"{warm / N_VIDEOS * 1e3:.2f} ms/video = host decode + preprocess "
          f"{prep / N_VIDEOS * 1e3:.2f} ms + forward (H2D, model, D2H) {fwd / N_VIDEOS * 1e3:.2f} ms")
    print_top_kernels(device_kernels(lambda: ex.forward(model, payload)), fwd / N_VIDEOS * 1e3,
                      "one forward on the device")
    return launches


def print_top_kernels(traced, wall_ms: float, label: str, top: int = 8, mark: str = ""):
    """One forward's device time by kernel from a profiler trace."""
    busy = sum(ms for ms, _ in traced.values())
    if not busy:
        print(f"{label}: the profiler recorded no device time (not measured)")
        return
    marked = sum(ms for name, (ms, _) in traced.items() if mark and mark in name)
    print(f"{label}: {busy:.3f} ms busy of {wall_ms:.3f} ms wall (idle share "
          f"{1 - busy / wall_ms:.3f})" + (f"; {mark} {marked:.4f} ms ({marked / busy:.1%})"
                                           if mark else "") + "; by kernel:")
    for name, (ms, n) in sorted(traced.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {ms:.4f} ms ({ms / busy:.1%}) x{n:g} {name[:90]}")


def stack_streams(models, stack, corr_method="auto"):
    """One stack (65, H, W, 3) through both streams, step by step as
    ``ExtractI3D.forward`` runs it: (flow, its cropped uint8 levels, rgb
    features, flow features), each as numpy."""
    from video_features_tpu_torch.models.i3d.extract_i3d import center_crop, rgb_chain
    from video_features_tpu_torch.ops.preprocess import flow_to_uint8, scale_to_1_1

    pwc = models["pwc"]
    pwc.corr_method = corr_method
    try:
        with torch.inference_mode():
            flow = pwc(stack[None])
            levels = flow_to_uint8(center_crop(flow))
            f_rgb, _ = models["rgb"](rgb_chain(stack[None, :-1]))
            f_flow, _ = models["flow"](scale_to_1_1(levels))
    finally:
        pwc.corr_method = "auto"
    return tuple(t.cpu().numpy() for t in (flow, levels, f_rgb, f_flow))


def compare_stack(a, b, label: str) -> None:
    """Flow tight; the share of uint8 levels that flip; rgb features by
    I3D_FEATURE_RTOL; flow features by the tolerance that share allows."""
    flow_err = float(np.abs(a[0] - b[0]).max())
    flow_tol = FLOW_RTOL * max(float(np.abs(b[0]).max()), 1.0)
    share = float(np.mean(a[1] != b[1]))
    rgb_err, flow_feat_err = rel_l2(a[2], b[2]), rel_l2(a[3], b[3])
    feat_tol = flow_feature_rtol(share, b[1])
    print(f"{label}: flow max_abs_err {flow_err:.3e} px (tol {flow_tol:.3e}, |flow| max "
          f"{np.abs(b[0]).max():.3f}); uint8 levels flipped {share:.3e} of {a[1].size}; "
          f"rgb features rel_l2 {rgb_err:.3e} (tol {I3D_FEATURE_RTOL:g}); flow features "
          f"rel_l2 {flow_feat_err:.3e} (tol {feat_tol:.3e})")
    if not flow_err <= flow_tol:
        raise AssertionError(f"{label}: flows disagree: {flow_err}")
    if not rgb_err <= I3D_FEATURE_RTOL:
        raise AssertionError(f"{label}: rgb features disagree: {rgb_err}")
    if not flow_feat_err <= feat_tol:
        raise AssertionError(f"{label}: flow features disagree: {flow_feat_err}")


def run_i3d_path(root: str, device):
    """Phase 5; returns K2's launches on the I3D path's run."""
    from video_features_tpu_torch import cli
    from video_features_tpu_torch.config import ExtractionConfig
    from video_features_tpu_torch.extract.registry import build_extractor
    from video_features_tpu_torch.ops.correlation_kernel import local_correlation_kernel
    from video_features_tpu_torch.utils.synth import synth_video

    clips = [synth_video(os.path.join(root, f"i3d{i}.mp4"), n_frames=I3D_CLIP_FRAMES, seed=i)
             for i in range(I3D_VIDEOS)]
    out = os.path.join(root, "i3d_out")
    reset_counts()
    t0 = time.perf_counter()
    cli.main(["--feature_type", "i3d", "--flow_type", "pwc", "--allow_random_init",
              "--on_extraction", "save_numpy", "--output_path", out,
              "--tmp_path", os.path.join(root, "tmp"), "--video_paths", *clips])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = local_correlation_kernel.launches

    feats = read_features(out)
    want = sorted(f"i3d{i}_{s}.npy" for i in range(I3D_VIDEOS) for s in ("rgb", "flow"))
    if sorted(feats) != want:
        raise AssertionError(f"expected {want}, got {sorted(feats)}")
    for name, f in feats.items():
        if f.shape != (I3D_STACKS, 1024) or not np.isfinite(f).all():
            raise AssertionError(f"{name}: shape {f.shape}, finite {np.isfinite(f).all()}")
    expected = I3D_VIDEOS * I3D_STACKS * len(CORR_LEVELS)
    if launches != expected:
        raise AssertionError(f"local_correlation launched {launches} times, expected {expected}")
    print(f"I3D path (--feature_type i3d --flow_type pwc, cold CLI run, model build included): "
          f"{I3D_VIDEOS} videos in {wall:.3f} s, {I3D_VIDEOS / wall:.3f} videos/s; "
          f"local_correlation launches {launches}")

    ex = build_extractor(ExtractionConfig(feature_type="i3d", video_paths=clips,
                                          allow_random_init=True), external_call=True)
    models = ex.warmup(device)
    frames, fps, stamps = ex.prepare(clips[0])
    stack = torch.from_numpy(np.stack(frames[: STACK + 1])).to(device)
    compare_stack(stack_streams(models, stack), stack_streams(models, stack, corr_method="plain"),
                  "one stack on the card, K2 vs the plain cost volume")

    clip65 = synth_video(os.path.join(root, "i3d65.mp4"), n_frames=STACK + 1, seed=9)
    ex65 = build_extractor(ExtractionConfig(feature_type="i3d", video_paths=[clip65],
                                            allow_random_init=True), external_call=True)
    (card,) = ex65(device=device)
    (cpu,) = ex65(device=torch.device("cpu"))
    stack65 = torch.from_numpy(np.stack(ex65.prepare(clip65)[0]))
    card_steps = stack_streams(ex65.warmup(device), stack65.to(device))
    cpu_steps = stack_streams(ex65.warmup(torch.device("cpu")), stack65)
    compare_stack(card_steps, cpu_steps,
                  "one 65-frame clip, step by step, the card vs the port on the CPU")
    rgb_err, flow_err = rel_l2(card["rgb"], cpu["rgb"]), rel_l2(card["flow"], cpu["flow"])
    flow_tol = flow_feature_rtol(float(np.mean(card_steps[1] != cpu_steps[1])), cpu_steps[1])
    print(f"features of that clip through ExtractI3D, card vs CPU: rgb rel_l2 {rgb_err:.3e} "
          f"(tol {I3D_FEATURE_RTOL:g}), flow rel_l2 {flow_err:.3e} (tol {flow_tol:.3e})")
    if not (rgb_err <= I3D_FEATURE_RTOL and flow_err <= flow_tol):
        raise AssertionError(f"card and CPU features disagree: rgb {rgb_err}, flow {flow_err}")

    ex(device=device)  # warm: cuDNN and allocator set-up
    prep = fwd = 0.0
    for clip in clips:
        t0 = time.perf_counter()
        payload = ex.prepare(clip)
        t1 = time.perf_counter()
        ex.forward(models, payload)  # ends in a copy to the host
        prep, fwd = prep + t1 - t0, fwd + time.perf_counter() - t1
    warm = prep + fwd
    print(f"I3D path (warm extractor): {I3D_VIDEOS / warm:.3f} videos/s, "
          f"{warm / I3D_VIDEOS * 1e3:.2f} ms/video = host decode + resize "
          f"{prep / I3D_VIDEOS * 1e3:.2f} ms + forward (H2D, PWC, 2x I3D, D2H) "
          f"{fwd / I3D_VIDEOS * 1e3:.2f} ms, {I3D_STACKS} stacks each")
    one = (frames[: STACK + 1], fps, stamps[: STACK + 1])
    t0 = time.perf_counter()
    ex.forward(models, one)
    one_ms = (time.perf_counter() - t0) * 1e3
    print_top_kernels(device_kernels(lambda: ex.forward(models, one)), one_ms,
                      "one stack's forward on the device", top=10, mark="local_correlation")
    return launches


def run_pwc_path(root: str):
    """Phase 6; returns K2's launches on the PWC path's run."""
    from video_features_tpu_torch import cli
    from video_features_tpu_torch.ops.correlation_kernel import local_correlation_kernel
    from video_features_tpu_torch.utils.synth import synth_video

    clip = synth_video(os.path.join(root, "pwc.mp4"), n_frames=PWC_CLIP_FRAMES, seed=5)
    out = os.path.join(root, "pwc_out")
    reset_counts()
    t0 = time.perf_counter()
    cli.main(["--feature_type", "pwc", "--batch_size", str(PWC_BATCH), "--allow_random_init",
              "--on_extraction", "save_numpy", "--output_path", out,
              "--tmp_path", os.path.join(root, "tmp"), "--video_paths", clip])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = local_correlation_kernel.launches
    (flow,) = read_features(out).values()
    shape = (PWC_CLIP_FRAMES - 1, 2, 240, 320)
    if flow.shape != shape or not np.isfinite(flow).all():
        raise AssertionError(f"pwc flow: shape {flow.shape} (expected {shape}), "
                             f"finite {np.isfinite(flow).all()}")
    windows = -(-(PWC_CLIP_FRAMES - 1) // PWC_BATCH)
    if launches != windows * len(CORR_LEVELS):
        raise AssertionError(f"local_correlation launched {launches} times, expected "
                             f"{windows * len(CORR_LEVELS)}")
    print(f"PWC path (--feature_type pwc --batch_size {PWC_BATCH}, cold CLI run): flow "
          f"{flow.shape}, |flow| max {np.abs(flow).max():.3f}, {wall:.3f} s; "
          f"local_correlation launches {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    from video_features_tpu_torch.devices import pin_fp32
    from video_features_tpu_torch.ops import kernels

    print(card_line())
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
    pin_fp32()
    device = torch.device("cuda", torch.cuda.current_device())

    t0 = time.perf_counter()
    built = kernels.build_all()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items())})")

    k1 = check_flash_attention(device)
    k2 = check_local_correlation(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        k1_launches = run_main_path(root)
        k2_launches = run_i3d_path(root, device)
        run_pwc_path(root)

    records = [
        {
            "name": "flash_attention",
            "route": "cuda",
            "source": "video_features_tpu_torch/csrc/flash_attention.cu",
            "replaces": "video_features_tpu/ops/pallas/flash_attention.py:36",
            "launches": k1_launches,
            **k1,
        },
        {
            "name": "local_correlation",
            "route": "cuda",
            "source": "video_features_tpu_torch/csrc/local_correlation.cu",
            "replaces": "video_features_tpu/ops/pallas/correlation_kernel.py:39",
            "launches": k2_launches,
            **k2,
        },
    ]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 - any failed phase fails the run
        import traceback

        traceback.print_exc()
        sys.exit(1)
