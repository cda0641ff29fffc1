"""Queue mode (video-level data parallelism) and mesh mode.

Counterpart of ``video_features_tpu/parallel/scheduler.py``.

``parallel_feature_extraction`` (``--sharding queue``, the default): one
host thread per device drains a shared queue of videos in chunks, so
decode load-balances across devices instead of leaving one idle behind a
long static shard. A worker that dies outside the extractor's per-video
isolation (its warmup, or an escape past it) is recorded as a
``worker_death``, as is one that a sticky device error stopped (the
videos it recorded failed stay so); its in-flight chunk goes back in the
queue, capped at ``--retries`` re-queues per video, and the surviving
workers drain it.
No collective is issued: each worker runs its own model on its own
device. Threads, not processes: decode and CUDA launches release the GIL.

``mesh_feature_extraction`` (``--sharding mesh``): one sharded forward
over a (data, model) grid of every selected device
(``parallel/sharding.py``), driven by this thread as the extractor's
"device". Under a launcher every process runs it over one global grid
(``parallel/distributed.py``): each walks the whole path list in the
same order, drives its own data rows, and only rank 0 writes.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import traceback
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from video_features_tpu_torch.parallel.devices import resolve_devices, world_size
from video_features_tpu_torch.runtime.faults import NULL_MANIFEST, LoopStopped


def mesh_feature_extraction(extractor, devices: Optional[Sequence] = None) -> None:
    """``--sharding mesh``: the extractor's ordinary loop with a
    ``(data, model)`` mesh of ``devices`` as its device (``--mesh_model``
    sets the model axis; the frame batch splits over ``data``). Refused,
    with the JAX package's messages, for an extractor that does not
    declare mesh support, tensor parallelism (``--mesh_model > 1``) or
    context parallelism (``--mesh_context``).

    In a launched process group ``devices`` are this process's and the
    mesh is global (``sharding.make_mesh``); a sticky error, a failed
    collective among them, then raises out of the run: the other
    processes cannot go on without this one."""
    from video_features_tpu_torch.parallel.sharding import make_mesh

    if devices is None:
        devices = resolve_devices(extractor.config)
    if not getattr(extractor, "mesh_capable", False):
        raise ValueError(
            f"--sharding mesh is not supported for feature_type "
            f"{extractor.feature_type!r}: {type(extractor).__name__} does "
            "not declare mesh support (mesh_capable); use --sharding queue"
        )
    model_axis = int(extractor.config.mesh_model or 1)
    if model_axis > 1 and not getattr(extractor, "mesh_tp_capable", False):
        raise ValueError(
            f"--mesh_model {model_axis} needs tensor-parallel param "
            f"specs, which {type(extractor).__name__} does not define "
            "(only the batch axis shards); use --mesh_model 1"
        )
    if getattr(extractor.config, "mesh_context", False) and not getattr(
        extractor, "mesh_context_capable", False
    ):
        raise ValueError(
            f"--mesh_context needs a transformer token axis to shard; "
            f"{type(extractor).__name__} does not declare support "
            "(mesh_context_capable)"
        )
    mesh = make_mesh(devices, model=model_axis)
    extractor(device=mesh, raise_stop=mesh.multiprocess)


def _on_device(device):
    """Make ``device`` the thread's current CUDA device (a thread starts
    on cuda:0), so a stream or allocation without an explicit device
    lands on the worker's own card."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def worker_labels(devices: Sequence) -> List[str]:
    """One label per worker: the device's name, with ``/<k>`` for the
    k-th repeat when a device is listed more than once
    (``--device_ids 0 0``), so spans and thread names tell them apart."""
    repeats = Counter(str(d) for d in devices)
    seen: Counter = Counter()
    labels = []
    for d in devices:
        name = str(d)
        labels.append(name if repeats[name] == 1 else f"{name}/{seen[name]}")
        seen[name] += 1
    return labels


def parallel_feature_extraction(extractor, devices: Optional[Sequence] = None) -> None:
    """Extract every video of ``extractor.path_list`` (module docstring).

    Each worker builds its device's model once (``extractor.warmup``),
    then pulls chunks of indices and runs ``extractor(chunk, device=...,
    worker=..., raise_stop=True)``; a sticky device error ends the worker
    like any other death, with its chunk's failed videos kept failed and
    the rest re-queued; remaining items are drained in further passes over the
    still-live devices, so the run either produces every output (or a
    failed record) or raises. Under a launcher (``WORLD_SIZE``/``RANK``)
    this process owns the strided slice ``range(rank, n, world)`` of the
    list; no process group is initialised."""
    if devices is None:
        devices = resolve_devices(extractor.config)
    devices = list(devices)

    n = len(extractor.path_list)
    own = range(n)
    world = world_size()
    if world > 1:
        own = range(int(os.environ.get("RANK", "0") or 0), n, world)
        # the heartbeat's total: this process only ever runs len(own) videos
        telemetry = getattr(extractor, "telemetry", None)
        if telemetry is not None:
            telemetry.total_videos = len(own)
    work: "queue.Queue[int]" = queue.Queue()
    for idx in own:
        work.put(idx)

    # the NULL manifest swallows the records of an extractor without one
    manifest = getattr(extractor, "manifest", None) or NULL_MANIFEST
    errors: List[Tuple[object, BaseException]] = []  # (device, exc)
    # re-queues per index, capped at --retries: past the cap the video is
    # recorded failed instead of ping-ponging between dying workers
    requeue_counts: Dict[int, int] = {}
    lock = threading.Lock()
    retries = int(getattr(extractor.config, "retries", 2) or 0)
    dead: set = set()  # worker slots
    interrupted = threading.Event()

    def record_death(device, exc: BaseException, phase: str, slot: int) -> None:
        with lock:
            errors.append((device, exc))
            dead.add(slot)
        if isinstance(exc, LoopStopped):
            return  # the extractor printed it and recorded the worker_death
        traceback.print_exc()
        manifest.event(
            "worker_death",
            device=str(device),
            phase=phase,
            error_type=type(exc).__name__,
            message=str(exc)[:300],
        )

    def requeue_or_drop(chunk: List[int]) -> None:
        for idx in chunk:
            with lock:
                requeue_counts[idx] = count = requeue_counts.get(idx, 0) + 1
            if count > retries:
                entry = extractor.path_list[idx]
                video = getattr(extractor, "_video_key", lambda e: str(e))(entry)
                print(
                    f"Dropping {video}: re-queued {count - 1} time(s) by "
                    "worker deaths, retry budget exhausted"
                )
                manifest.record(
                    video,
                    "failed",
                    stage="worker",
                    error_class="transient",
                    message=f"worker died {count} times holding this video",
                    attempts=count,
                )
            else:
                work.put(idx)

    # chunks give the extractor's --decode_workers pipeline a window of
    # upcoming videos to decode ahead, small enough that the shared queue
    # still balances; with --video_batch a chunk covers at least two full
    # groups, or every chunk boundary would flush a partial group
    decode_workers = int(getattr(extractor.config, "decode_workers", 0) or 0)
    video_batch = int(getattr(extractor.config, "video_batch", 1) or 1)
    chunk_size = (
        n
        if len(devices) == 1
        else max(1, 2 * (decode_workers + 1), 2 * video_batch)
    )
    labels = worker_labels(devices)

    def worker(slot: int) -> None:
        device = devices[slot]
        with _on_device(device):
            try:
                extractor.warmup(device)
            except Exception as e:  # noqa: BLE001 - recorded; the run goes on without it
                record_death(device, e, "warmup", slot)
                return
            while not interrupted.is_set():
                chunk: List[int] = []
                try:
                    for _ in range(chunk_size):
                        chunk.append(work.get_nowait())
                except queue.Empty:
                    pass
                if not chunk:
                    return
                try:
                    extractor(chunk, device=device, worker=labels[slot], raise_stop=True)
                except KeyboardInterrupt:
                    interrupted.set()
                    return
                except LoopStopped as e:
                    # a sticky device error: this card fails every later
                    # launch. The videos it recorded failed stay so; the
                    # rest of the chunk goes to the live workers
                    record_death(device, e, "extract", slot)
                    key = getattr(extractor, "_video_key", str)
                    requeue_or_drop([i for i in chunk
                                     if key(extractor.path_list[i]) not in e.videos])
                    return
                except BaseException as e:  # noqa: BLE001 - a worker death
                    # an escape past the per-video isolation: the chunk goes
                    # back (its finished videos may run again; the sink's
                    # writes are atomic) and the death is recorded, so the
                    # run cannot end clean with outputs missing
                    record_death(device, e, "extract", slot)
                    requeue_or_drop(chunk)
                    return

    live = list(range(len(devices)))
    while live and not work.empty() and not interrupted.is_set():
        if len(live) == 1:
            worker(live[0])
        else:
            threads = [
                threading.Thread(target=worker, args=(s,), daemon=True,
                                 name=f"extract-{labels[s]}")
                for s in live
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        live = [s for s in live if s not in dead]

    if interrupted.is_set():
        raise KeyboardInterrupt
    deaths = "; ".join(f"{d}: {type(e).__name__}: {str(e)[:200]}" for d, e in errors)
    if not work.empty():
        raise RuntimeError(
            f"all extraction workers died with {work.qsize()} of {len(own)} videos "
            f"unprocessed ({len(errors)} worker death(s): {deaths})"
        ) from (errors[0][1] if errors else None)
    if errors:
        print(
            f"WARNING: {len(errors)} extraction worker(s) died mid-run; "
            "their videos were re-queued and completed by surviving workers "
            f"(or recorded failed past the retry cap). Deaths: {deaths}"
        )
