"""One run of one cell: inputs from the seed, the program's set-up, the
measured window, the check against the plain reference, and the metrics.

The program is ``video_features_tpu_torch`` driven through the entry its
users run: the CLI's own parser (``config.parse_batch_args``), the
registry's ``build_extractor``, ``BaseExtractor.warmup`` and
``BaseExtractor.__call__`` with ``--on_extraction save_numpy`` (the
pipelined loop, the manifest, the sink and the telemetry all run).

- Inputs (before set-up): the mix's clips, enough hard-linked names of
  them, and the weight files.
- ``setup_s``: from the program's first import through the build, the
  weights' load (``warmup`` on every card), one video alone on each card
  (the first call at every shape the window uses; the cards at once, each
  from its own thread, as queue mode's workers run) and a warm pair
  through the first card's loop (the loop's pace).
- The window: the next videos of the list, as many as the pace says fill
  ``seconds``, and a margin, through one card's ``__call__`` or, on more
  cards, queue mode's ``parallel_feature_extraction``. A video counts when its ``sink`` span
  ends inside the window; the rate is those videos over the time from the
  window's start to the last of them.
- The check: once the window is over and the program freed, the reference
  recomputes a seeded sample of the videos completed in the window, and
  each stream's worst relative L2 distance per stack (``compare.py``) is
  held to the cell's limit.
"""

from __future__ import annotations

import contextlib
import gc
import math
import os
import pathlib
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from port_bench.harness import compare, spec
from port_bench.harness.inputs import make_weights
from port_bench.reference import pipeline
from port_bench.traffic.generator import SAMPLE, link_videos, make_clips, sub_seeds

# the fastest a video could go, sizing the names made before set-up
MIN_VIDEO_S = 0.1
# the window's list: the warm pace's share of ``seconds``, times this, +2
LIST_MARGIN = 1.15
TRACE_SECONDS = 5.0


def program_argv(config: dict, cell: dict, list_file: str, out_dir: str, tmp_dir: str,
                 weights_dir: str, cuda: bool) -> List[str]:
    pipe = config["pipeline"]
    devices = (["--device_ids", *map(str, range(cell["chips"]))] if cuda else ["--cpu"])
    return ["--feature_type", config["feature_type"], "--flow_type", config["flow_type"],
            "--streams", "rgb", "flow", "--stack_size", str(pipe["stack_size"]),
            "--step_size", str(pipe["step_size"]), "--dtype", config["dtype"],
            "--file_with_video_paths", list_file, "--output_path", out_dir,
            "--tmp_path", tmp_dir, "--weights_path", weights_dir,
            "--on_extraction", "save_numpy", *cell["flags"], *devices]


def _sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def _sync_all(devs, cuda: bool) -> None:
    for d in devs if cuda else ():
        torch.cuda.synchronize(d)


def _peak(devs, cuda: bool) -> int:
    """``max_memory_allocated`` on the fullest card."""
    return max(torch.cuda.max_memory_allocated(d) for d in devs) if cuda else 0


def _first_calls(ext, devs) -> None:
    """Video ``k`` alone on card ``k``, the cards at once, each from a
    thread of its own on its own card, as queue mode's workers run."""
    import threading

    from video_features_tpu_torch.parallel.scheduler import worker_labels

    errors = []

    def one(k, d, label):
        try:
            with torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext():
                ext(indices=[k], device=d, worker=label)
        except BaseException as e:  # noqa: BLE001 - raised below, on the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=one, args=(k, d, lab))
               for k, (d, lab) in enumerate(zip(devs, worker_labels(devs)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def _drive(ext, devs, lo: int, hi: int, names: List[str]) -> None:
    """Videos ``lo`` to ``hi`` of the list through the entry users run:
    one card's ``BaseExtractor.__call__``, or queue mode's
    ``parallel_feature_extraction`` over the cards, with the extractor's
    path list set to those videos."""
    if len(devs) == 1:
        ext(indices=list(range(lo, hi)), device=devs[0])
        return
    from video_features_tpu_torch.parallel.scheduler import parallel_feature_extraction

    ext.path_list = list(names[lo:hi])
    parallel_feature_extraction(ext, devs)


def _outputs(out_dir: str, video: str) -> Dict[str, str]:
    stem = pathlib.Path(video).stem
    return {s: os.path.join(out_dir, "i3d", f"{stem}_{s}.npy") for s in ("rgb", "flow")}


def _sample(done: List[str], k: int, seed: int) -> List[str]:
    """Up to ``k`` of the completed videos, drawn from the seed, of distinct
    clips (hard links share an inode) while there are enough."""
    rng = np.random.RandomState(sub_seeds(seed, 1, SAMPLE)[0])
    order = [done[i] for i in rng.permutation(len(done))]
    picked, seen = [], set()
    for v in order:
        if os.stat(v).st_ino not in seen:
            picked.append(v)
            seen.add(os.stat(v).st_ino)
    picked += [v for v in order if v not in picked]
    return picked[:k]


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        bench_dir: pathlib.Path = spec.BENCH_DIR, cuda: bool = True,
        width_div: int = 1) -> Tuple[dict, Dict[str, Tuple[float, float]]]:
    """(the result line's object, {number compared: (value, limit)}).
    ``cuda=False`` and ``width_div`` serve the CPU tests only."""
    bench = spec.benchmark(bench_dir.parent)
    cell = spec.workload(cell_name, bench_dir)
    config = spec.config(cell["config"], bench_dir)
    mix = spec.traffic(cell["traffic"], bench_dir)
    device = torch.device("cuda:0" if cuda else "cpu")
    work = pathlib.Path(tempfile.mkdtemp(prefix="port_bench-", dir=os.environ.get("TMPDIR")))
    try:
        return _run(cell_name, cell, config, mix, bench, seed, seconds, trace, work, device,
                    cuda, bench_dir, width_div)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(cell_name, cell, config, mix, bench, seed, seconds, trace, work, device, cuda,
         bench_dir, width_div):
    chips = int(cell["chips"])
    warm = chips + 2  # one cold video a card, then a warm pair on the first
    # --- inputs, before set-up ---
    clips = make_clips(mix, seed, str(work / "clips"))
    n_max = warm + int(math.ceil((seconds * LIST_MARGIN + TRACE_SECONDS) * chips
                                 / MIN_VIDEO_S)) + 8
    names = link_videos(clips, n_max, seed, str(work / "videos"))
    list_file = work / "videos.txt"
    list_file.write_text("\n".join(names) + "\n")
    weights_dir = str(work / "weights")
    make_weights(config, seed, weights_dir, device, width_div)
    out_dir = str(work / "out")
    argv = program_argv(config, cell, str(list_file), out_dir, str(work / "tmp"), weights_dir,
                        cuda)
    _sync(cuda)
    if cuda:
        torch.cuda.empty_cache()

    # --- set-up: the program's first import to the warm videos done ---
    with contextlib.redirect_stdout(sys.stderr):
        t0 = time.perf_counter()
        from video_features_tpu_torch.config import parse_batch_args
        from video_features_tpu_torch.extract.registry import build_extractor
        from video_features_tpu_torch.parallel.devices import resolve_devices

        cfg, _ = parse_batch_args(argv)
        devs = resolve_devices(cfg)
        dev = devs[0]
        ext = build_extractor(cfg)
        t_load = time.perf_counter()
        states = [ext.warmup(d) for d in devs]
        _sync_all(devs, cuda)
        load_s = time.perf_counter() - t_load
        t_first = time.perf_counter()
        if chips == 1:
            ext(indices=[0], device=dev)
        else:
            _first_calls(ext, devs)
        _sync_all(devs, cuda)
        first_video_s = time.perf_counter() - t_first
        t_pair = time.monotonic()
        ext(indices=[chips, chips + 1], device=dev)
        _sync(cuda)
        pair_s = time.monotonic() - t_pair
        setup_s = time.perf_counter() - t0
    # the loop's pace: the warm pair's call, less its first video's
    # prepare (the one the pipeline cannot hide), over two videos; a queue
    # of cards runs as many loops at once
    prep = [r["t1"] - r["t0"] for r in ext.telemetry.spans()
            if r["stage"] == "prepare" and r.get("t0", 0) >= t_pair
            and r["video"] == names[chips]]
    pace = max((pair_s - (prep[0] if prep else 0.0)) / 2 / chips, MIN_VIDEO_S)
    n = int(math.ceil(seconds / pace * LIST_MARGIN)) + 2
    print(f"port_bench: set-up {setup_s:.3f} s (load {load_s:.3f}, first video "
          f"{first_video_s:.3f}, warm pair {pair_s:.3f}); pace {pace:.3f} s a video; "
          f"{n} videos listed for {seconds} s", file=sys.stderr)

    window = names[warm:warm + n]
    hooks = None
    if trace:
        from port_bench.harness.tracing import ModelEvents

        hooks = ModelEvents([kv for st in states for kv in st.items()], last="flow",
                            trace_seconds=TRACE_SECONDS)
        hooks.recording = True

    # --- the window ---
    setup_peak = _peak(devs, cuda)
    for d in devs if cuda else ():
        torch.cuda.reset_peak_memory_stats(d)
    with contextlib.redirect_stdout(sys.stderr):
        t_start = time.monotonic()
        _drive(ext, devs, warm, warm + n, names)
        _sync_all(devs, cuda)
        t_end = time.monotonic()
    window_peak = _peak(devs, cuda)

    spans = [r for r in ext.telemetry.spans() if r.get("t0", 0) >= t_start]
    sinks = {r["video"]: r["t1"] for r in spans if r["stage"] == "sink"}
    done = [v for v in window if all(os.path.exists(p) for p in _outputs(out_dir, v).values())]
    in_window = sorted(t for v, t in sinks.items() if v in window and t <= t_start + seconds)
    rate = len(in_window) / (in_window[-1] - t_start) if in_window else 0.0
    print(f"port_bench: window {len(in_window)} videos in {seconds} s, the last at "
          f"{(in_window[-1] - t_start) if in_window else 0.0:.3f} s; the list of {n} done at "
          f"{t_end - t_start:.3f} s", file=sys.stderr)
    model_ms = reduced = None
    if hooks is not None:
        from port_bench.harness.tracing import reduce_trace

        model_ms = hooks.device_ms()
        hooks.recording = False
        # the traced stretch, after the window: the next videos of the list
        hooks.trace()
        k = int(math.ceil(TRACE_SECONDS / pace)) + 2 * chips
        t_trace = time.monotonic()
        with contextlib.redirect_stdout(sys.stderr):
            _drive(ext, devs, warm + n, warm + n + k, names)
        hooks.finish()
        if hooks.state == "off":
            traced = [r for r in ext.telemetry.spans() if r.get("t0", 0) >= t_trace]
            reduced = reduce_trace(hooks.prof, traced, hooks.origin)
        hooks = None
    del states, ext
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # --- the check, after the window, the program freed ---
    completed = [v for v in window if v in sinks and sinks[v] <= t_start + seconds and v in done]
    sample = _sample(completed, int(cell["check_videos"]), seed)
    numbers = _check(sample, out_dir, config, weights_dir, device, width_div)
    limits = cell["limits"]
    compared = {k: (numbers[k], float(limits[k])) for k in sorted(limits)}
    failed = len(window) - len(done)
    correct = (bool(sample) and failed == 0
               and all(v <= lim for v, lim in compared.values()))

    # --- metrics ---
    ctx = {
        "cell": cell_name, "config": config, "mix": mix, "seconds": seconds,
        "setup": {"setup_s": setup_s, "load_s": load_s, "first_video_s": first_video_s},
        "window": {"t_start": t_start, "t_end": t_end, "rate": rate, "completed": len(in_window),
                   "videos": window, "completed_videos": completed},
        "spans": spans, "model_ms": model_ms, "trace": reduced, "chips": chips,
        "peak_window_bytes": window_peak,
        "video_hw": pipeline_hw(mix, config),
        "stacks_per_video": len(pipeline.windows(mix["frames"], config["pipeline"]["stack_size"],
                                                 config["pipeline"]["step_size"])),
    }
    metrics = {}
    if trace:
        for m in spec.per_layer_for(cell_name, bench):
            value = spec.metric(m["name"], bench_dir).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"videos_per_s": rate, "setup_s": setup_s}
        for m in spec.end_to_end_for(cell_name, bench):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                "count": chips,
                "memory_peak_bytes": int(max(setup_peak, window_peak))}
    result = {"correct": correct, "attempted": len(window), "failed": failed,
              "metrics": metrics, "device": dev_info}
    if trace and reduced is not None:
        dev_info["busy_s"] = reduced["busy_s"]
        dev_info["window_s"] = reduced["window_s"]
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    return result, compared


def pipeline_hw(mix: dict, config: dict) -> Tuple[int, int]:
    """The frames' (h, w) after the ``min_side`` resize."""
    h, w, side = mix["height"], mix["width"], config["pipeline"]["min_side"]
    if min(h, w) == side:
        return h, w
    return (side, int(side * w / h)) if h < w else (int(side * h / w), side)


def _check(sample: List[str], out_dir: str, config: dict, weights_dir: str, device,
           width_div: int) -> Dict[str, float]:
    """Each stream's worst per-stack relative L2 distance between the
    program's files and the reference, over the sample (inf without one)."""
    worst = {"rgb_rel_l2": math.inf if not sample else 0.0,
             "flow_rel_l2": math.inf if not sample else 0.0}
    if not sample:
        return worst
    with pipeline.precision(tf32=bool(config.get("tf32", False))):
        models = pipeline.load_models(config, weights_dir, device, width_div)
        ref_by_clip: Dict[int, dict] = {}
        for video in sample:
            key = os.stat(video).st_ino
            if key not in ref_by_clip:
                ref_by_clip[key] = pipeline.video_features(video, models, config, device)
            ref = ref_by_clip[key]
            for stream, path in _outputs(out_dir, video).items():
                d = compare.rel_l2_rows(np.load(path), ref[stream])
                worst[f"{stream}_rel_l2"] = max(worst[f"{stream}_rel_l2"], d)
    return worst
