"""Extractor runtime: the per-video loop every feature type shares, its
run contract, and its async device ingest.

Counterpart of ``video_features_tpu/extract/base.py``: the path list is
formed in ``__init__``, the model is built once per device (``warmup``),
and ``__call__`` runs the videos. Results go to the output sink or, with
``external_call``, back to the caller in the order of the indices given.

The run contract (``runtime/faults.py``):

- every outcome of a save run (or of a ``--strict`` or ``--fault_inject``
  run) is one record under ``<output_path>/_manifest/``: done, retry,
  failed (with its stage and error class), skipped, a sink warning, or a
  decode warning (fps defaulted, partial decode; ``io/video.py``);
- a transient or oom failure goes back in the queue after a backoff, up
  to ``--retries`` times; any other failure is recorded and printed, and
  the loop goes on with the next video;
- a sticky device error (``faults.is_sticky``: a CUDA error that fails
  every later launch, a kernel that does not build) is recorded as that
  video's failure plus one ``worker_death`` event, and stops the loop:
  the videos not yet attempted get no record, so ``--resume`` runs them
  (in queue mode the other workers take them: ``parallel/scheduler.py``);
- in a mesh across launched processes every outcome is collective
  (``_run_lockstep``): the processes agree on each video's prepare and
  sink, and retry, fail or go on together; a failure inside the sharded
  forward, where the others may wait in a collective, stops the run;
- ``--resume`` skips a video whose output files all exist, or that an
  earlier run recorded as a permanent failure (unless ``--retry_failed``);
- with ``--preflight on`` (the default) each video is probed before its
  first attempt (``io/probe.py``): a file the probe rejects fails
  permanent at stage ``preflight`` with zero retries, and the probe's
  cautions are recorded as warnings;
- with ``--cache_dir`` (save runs) a video whose (content hash, config
  digest) the feature store holds is a file copy, recorded ``done`` with
  the note ``cache_hit`` before any decode or launch, and every video the
  sink commits is published to the store (``extract/cache.py``); a
  (video, flow dir) pair is never cached, as the hash covers the video
  only.

``run_paths`` is the serve daemon's dispatch surface: it appends entries
to the path list and runs only the new indices on the warm extractor.

Run telemetry (``runtime/telemetry.py``, ``--telemetry on``, the
default): each stage of a video is a span (``prepare``, ``decode`` from
the reader, ``h2d``, ``dispatch``, ``fetch``, ``sink``; the serial loop's
``extract``; ``compile``, a built module's first call at a signature),
with counters (``videos_done``, ``frames_decoded``, ``h2d_bytes``,
``retries``, ``windows_skipped``, ``compiles``), the pipelined loop's
queue-depth gauges and the shape keys seen. The device lane: a call
anchors its CUDA device's clock before its first dispatch, while no other
worker has work on the lane (``Telemetry.anchor_device``), and the pipelined and serial loops wrap
every dispatch in one device scope (``Telemetry.device_scope``): an
extractor that records device phases inside it (I3D's ``h2d`` /
``preprocess`` / ``flow_net`` / ``i3d_rgb`` / ``i3d_flow`` / ``d2h`` per
stack, with ``stage_in`` and ``launch`` host spans) gets a ``device``
row per phase, any other one ``forward`` row per dispatch; the drain
thread reads the rows once their events have completed, and the call
reads what is left at its end, without a wait. The lockstep loop and a
mesh record none. A save run drains them to
``<output_path>/_telemetry/``, beside the device cost ledger's
``cost_ledger.json`` (``telemetry/ledger.py``: each model call's flops
and memory, measured at its first call), and ``finalize_run`` puts the
merged block in ``summary.json``; other runs keep the spans in memory. A failure
record carries the id of the span it failed in. ``--profile_dir`` wraps
the loop in a ``torch.profiler`` trace (``utils/profiling.py``) and
prints the per-stage wall time.

With ``--decode_workers N >= 1`` and more than one video the loop is the
JAX package's ``_run_pipelined``: ``prepare`` runs on N host threads,
at most N + 1 prepared payloads wait, and the device half is split in
two. ``dispatch_prepared`` enqueues a video's H2D, forward and D2H
(``extract/ingest.py``) and returns a handle; up to ``--inflight_groups``
handles wait in a ``CompletionQueue`` before the loop blocks on the
oldest's ``fetch_dispatched``, and a head that has already completed is
sunk without blocking. With ``--video_batch N > 1``, prepared videos
whose payloads share an ``agg_key`` fuse N at a time into one
``transfer_group`` + ``dispatch_group`` (a partial group flushes at the
end), and ``fetch_group`` splits the results per video; a fused group
that fails at dispatch or fetch re-runs each member alone (a
``group_fallback`` event), unless the error is sticky. With 0 (or one
video) each video is prepared and computed in turn.

A subclass implements ``_build(device)`` (the model state), ``prepare``
(host: decode and preprocess one video; thread-safe, and touches no CUDA)
and either ``dispatch_prepared`` + ``fetch_dispatched`` (``forward`` is
then their composition) or ``forward`` alone (the solo path only); and
for ``--video_batch``, ``agg_key``, ``dispatch_group``, ``fetch_group``
and optionally ``transfer_group``.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from video_features_tpu_torch.config import ExtractionConfig
from video_features_tpu_torch.devices import pin_fp32, resolve_device
from video_features_tpu_torch.extract.cache import FeatureCache, config_digest
from video_features_tpu_torch.extract.ingest import (
    CompletionQueue,
    HostCopy,
    RequeueTimers,
    place_taps,
)
from video_features_tpu_torch.io.ffmpeg import reencode_video_with_diff_fps
from video_features_tpu_torch.io.paths import form_list_from_user_input, video_path_of
from video_features_tpu_torch.io.probe import ResourceCaps, preflight
from video_features_tpu_torch.io.sink import action_on_extraction, expected_output_files
from video_features_tpu_torch.io.video import (
    pop_decode_warnings,
    set_decode_timeout,
    set_resource_caps,
)
from video_features_tpu_torch.parallel import distributed
from video_features_tpu_torch.runtime import faults
from video_features_tpu_torch.runtime import telemetry as telemetry_mod
from video_features_tpu_torch.runtime.faults import NULL_MANIFEST, LoopStopped, RunManifest
from video_features_tpu_torch.runtime.telemetry import Telemetry
from video_features_tpu_torch.telemetry.ledger import (
    CostLedger,
    default_ledger_path,
    instrument_state,
)
from video_features_tpu_torch.utils.profiling import device_trace


# --resume's answers, by the index a mesh's processes broadcast
_SKIP_REASONS = (None, "prior permanent failure (pass --retry_failed to re-attempt)",
                 "outputs exist")
# a process's outcome of one step of a lockstep video, by the code the
# processes gather (``BaseExtractor._agree``): the worst decides
_OK, _RETRY, _FAIL, _STOP = range(4)


def device_of(state) -> torch.device:
    """The device of a built model state (a module, or a dict of them)."""
    module = next(iter(state.values())) if isinstance(state, dict) else state
    return next(module.parameters()).device


class BaseExtractor:
    feature_type: str = ""
    # what the preflight probe must find in an input: 'video' or 'audio'
    media_need: str = "video"

    def __init__(self, config: ExtractionConfig, external_call: bool = False) -> None:
        self.config = config
        self.external_call = external_call
        if not self.feature_type:
            self.feature_type = self.config.feature_type
        self.path_list = form_list_from_user_input(self.config)
        # features land in <output_path>/<feature_type>/ unless output_direct
        if self.config.output_direct:
            self.output_path = self.config.output_path
        else:
            self.output_path = os.path.join(self.config.output_path, self.feature_type)
        self.tmp_path = os.path.join(self.config.tmp_path, self.feature_type)
        self._device_state: Dict[torch.device, Any] = {}
        # --preprocess device: (device, ids of the host taps) -> (the host
        # taps, kept so their ids stay theirs; the placed taps)
        self._taps: Dict[tuple, tuple] = {}
        self._taps_lock = threading.Lock()
        # queue mode's workers share this extractor: warmup builds each
        # device's state once, under this lock
        self._build_lock = threading.Lock()
        pin_fp32()
        # the manifest roots at output_path (not the feature's subdirectory),
        # so one <output>/_manifest covers the tree and --resume merges it
        wants_manifest = not external_call and (
            self.config.on_extraction in ("save_numpy", "save_pickle")
            or self.config.strict
            or bool(self.config.fault_inject)
        )
        self.manifest = (
            RunManifest(self.config.output_path) if wants_manifest else NULL_MANIFEST
        )
        # spans and metrics go to <output_path>/_telemetry on the runs that
        # keep a manifest; external and print runs keep the spans in memory;
        # --telemetry off leaves the bare per-stage timer
        wants_telemetry = self.config.telemetry != "off"
        tele_root = self.config.output_path if wants_manifest and wants_telemetry else None
        self.telemetry = Telemetry(
            output_root=tele_root,
            enabled=wants_telemetry,
            heartbeat_s=float(self.config.heartbeat_s or 0.0) if tele_root else 0.0,
            total_videos=len(self.path_list),
        )
        self.timer = self.telemetry.timer
        telemetry_mod.set_current(self.telemetry)
        # the device cost ledger (telemetry/ledger.py), on the runs that
        # write spans: warmup() hooks the built state so each module's
        # first call per signature records its flops and memory
        self.ledger: Optional[CostLedger] = (
            CostLedger.shared(default_ledger_path(self.config)) if tele_root is not None else None
        )
        faults.install_injector(self.config.fault_inject)
        # --decode_timeout and the input caps: every reader opened from now
        # on takes them (io/video.py); the probe checks the same caps
        set_decode_timeout(self.config.decode_timeout)
        self._resource_caps = ResourceCaps.from_config(self.config)
        set_resource_caps(self._resource_caps)
        self._t0: Dict[str, float] = {}  # video key -> this attempt's start
        self._prior_failed: set = set()
        if self.config.resume and not external_call and not self.config.retry_failed:
            self._prior_failed = faults.permanently_failed_videos(self.config.output_path)
        # the content-addressed feature cache (extract/cache.py): save runs only
        self._feature_cache: Optional[FeatureCache] = None
        self._cache_digest: Optional[str] = None
        # a mesh across launched processes opts out, as the JAX package's
        # meshes do: a per-host store probe would diverge like a per-host
        # --resume probe, and every skip there must be collective
        if (self.config.cache_dir and not external_call
                and self.config.on_extraction in ("save_numpy", "save_pickle")
                and not self._lockstep()):
            self._feature_cache = FeatureCache(self.config.cache_dir,
                                               hash_mode=self.config.cache_hash)
            self._cache_digest = config_digest(self.config)

    def feature_keys(self) -> List[str]:
        """The keys a feature dict carries, whose files ``--resume`` probes
        (i3d overrides this with its streams)."""
        return [self.feature_type]

    def _fps_source(self, video_path: str):
        """(decode path, selection fps) under ``--fps_retarget``: with
        ``nearest`` (the default) the original, its frames picked on the
        target grid in-process; with ``reencode`` the reference's ffmpeg
        re-encode into the tmp path (a ``reencode`` span), already on the
        target grid, so no selection fps. Used by the extractors whose
        reference re-encodes (resnet*, raft, pwc; ``sanity_check`` keeps
        the flag to them)."""
        fps = self.config.extraction_fps
        if fps and self.config.fps_retarget == "reencode":
            with self.telemetry.span("reencode", video=str(video_path)):
                return reencode_video_with_diff_fps(
                    video_path, self.tmp_path, fps, timeout_s=self.config.decode_timeout,
                ), None
        return video_path, fps

    def _already_done(self, entry) -> bool:
        files = expected_output_files(
            self.feature_keys(), video_path_of(entry), self.output_path,
            self.config.on_extraction, self.config.output_direct,
        )
        return bool(files) and all(os.path.exists(f) for f in files)

    def _build(self, device: torch.device) -> Any:
        raise NotImplementedError

    def prepare(self, entry) -> Any:
        raise NotImplementedError

    # --- the device half: solo ---------------------------------------------
    def dispatch_prepared(self, state: Any, payload: Any) -> Any:
        """Enqueue one prepared video's H2D (``ingest.place_batch``), its
        forward and its D2H (``ingest.HostCopy``), and return a handle
        without waiting for any of them."""
        raise NotImplementedError

    def fetch_dispatched(self, handle: Any) -> Dict[str, np.ndarray]:
        """Wait for a dispatched video's results and assemble its feature
        dict."""
        raise NotImplementedError

    def forward(self, state: Any, payload: Any) -> Dict[str, np.ndarray]:
        """The device half of one video: dispatched, then fetched. An
        extractor without the split overrides this instead."""
        return self.fetch_dispatched(self.dispatch_prepared(state, payload))

    def extract_prepared(self, state: Any, payload: Any) -> Dict[str, np.ndarray]:
        """The loops' solo path for one prepared video."""
        return self.forward(state, payload)

    def _supports_device_pipeline(self) -> bool:
        return type(self).dispatch_prepared is not BaseExtractor.dispatch_prepared

    # --- the device half: cross-video aggregation (--video_batch) -----------
    def _supports_aggregation(self) -> bool:
        return type(self).dispatch_group is not BaseExtractor.dispatch_group

    def _aggregation_enabled(self) -> bool:
        return self._supports_aggregation() and max(int(self.config.video_batch or 1), 1) > 1

    def agg_key(self, payload: Any):
        """Hashable shape key: payloads with equal keys may fuse into one
        dispatch. ``None`` sends the video down the solo path (an
        extractor's opt-out for oversized payloads or ``--show_pred``)."""
        return None

    def transfer_group(self, state: Any, payloads: List[Any]):
        """Optional H2D stage of a fused group: assemble the group's host
        arrays and place them now, returning an ``ingest.StagedGroup``
        that ``dispatch_group`` consumes. None (the default) keeps the
        placement inside ``dispatch_group``. A partial group (the flush at
        the end of a run) is not padded to the full group's shape: eager
        PyTorch compiles no shape, and each video's rows are its own."""
        return None

    def dispatch_group(self, state: Any, payloads: Any) -> Any:
        """Fuse up to ``--video_batch`` same-key payloads (or the
        ``StagedGroup`` of ``transfer_group``) into one forward; return a
        handle without waiting."""
        raise NotImplementedError

    def fetch_group(self, handle: Any) -> List[Dict[str, np.ndarray]]:
        """Wait for a fused group and return its members' feature dicts,
        in the order of the payloads."""
        raise NotImplementedError

    @staticmethod
    def _dispatch_rows_grouped(rows: List[np.ndarray], chunk_rows: int,
                               forward) -> List[Tuple[HostCopy, int]]:
        """The row re-chunking of fused ResNet frames and R(2+1)D stacks:
        the videos' valid rows concatenated and run ``chunk_rows`` at a
        time through ``forward`` (a host chunk -> its feature rows on the
        device, placed by the caller: on one device, or split over a
        mesh's data rows), the last chunk unpadded (eager PyTorch compiles
        no shape, so a short chunk costs nothing extra). Returns
        ``[(HostCopy, rows)]`` without waiting."""
        all_rows = np.concatenate(rows, axis=0)
        outs = []
        with torch.inference_mode():
            for i in range(0, all_rows.shape[0], chunk_rows):
                piece = all_rows[i : i + chunk_rows]
                outs.append((HostCopy(forward(piece)), piece.shape[0]))
        return outs

    @staticmethod
    def _split_grouped_rows(outs, totals: List[int]) -> List[np.ndarray]:
        """Fetch ``_dispatch_rows_grouped``'s handles and split the rows
        back per video (``totals`` rows each, in order)."""
        cat = np.concatenate([h.numpy()[:n] for h, n in outs], axis=0)
        return np.split(cat, np.cumsum(totals)[:-1])

    def _device_preprocess_enabled(self) -> bool:
        """``--preprocess device``: ``prepare`` ships raw uint8 frames and
        their resample taps, and the dispatch resizes, crops and
        normalizes on the device (``ops/preprocess.py``). The JAX
        package's host rerun of a video whose fused program fails to
        compile is left out: eager PyTorch compiles nothing, and a failure
        on the device path is a failed video like any other."""
        return self.config.preprocess == "device"

    # --- --host_preprocess native: the threaded C++ chains
    # (native/preprocess.cpp) of the extractors with a PIL chain, CLIP's
    # bicubic and the ResNet family's bilinear one
    _use_native: Optional[bool] = None
    _native_threads: int = 1

    def _decide_native(self) -> None:
        """Under ``--preprocess host``, ``--host_preprocess native`` takes
        the C++ chains, with the cores this process may use split between
        its queue workers (``_queue_workers``). Where the JAX package
        prints that the library is unavailable and goes on with PIL, this
        raises, naming the build error: a quiet switch would hide which
        chain ran."""
        use = (self.config.host_preprocess == "native"
               and not self._device_preprocess_enabled())
        if use:
            from video_features_tpu_torch import native

            if not native.available():
                raise RuntimeError(
                    "--host_preprocess native requested but the preprocess library "
                    f"is unavailable: {native.build_error()}"
                )
            self._native_threads = max(native.cpu_budget() // self._queue_workers(), 1)
        # set last: a reader that sees the decision sees its thread count
        self._use_native = use

    def _queue_workers(self) -> int:
        """The device workers of this run, which share the host's cores:
        one per ``--device_ids`` entry in queue mode (every visible CUDA
        device without ids), one for ``--cpu`` and for a mesh (one loop
        drives every device). Counted without touching a device."""
        cfg = self.config
        if cfg.cpu or cfg.sharding == "mesh":
            return 1
        if cfg.device_ids:
            return len(cfg.device_ids)
        return max(torch.cuda.device_count(), 1)

    def _native_decided(self) -> bool:
        """The chain decision, made once. The extractors with a PIL chain
        call it in ``__init__``, so an unavailable library fails the setup
        and a decode worker finds it made. No lock is held around it: the
        library's build (a ``g++`` run of up to 300 s) is one-shot under
        ``native``'s own lock, so two callers that race here both wait for
        that one build and decide alike, and ``_decide_native`` publishes
        the answer last."""
        if self._use_native is None:
            self._decide_native()
        return bool(self._use_native)

    # the host taps are lru_cached per source resolution (ops/resize.py), so
    # the same arrays come back for every video of a resolution; the bound
    # only matters to a corpus of more resolutions than those caches hold
    _TAPS_MAX = 512

    def _device_taps(self, taps, device: torch.device):
        """A video's host taps on ``device`` (``ingest.place_taps``), placed
        once per set of host arrays and then reused. Call it on the loop
        thread."""
        key = (device,) + tuple(id(a) for pair in taps for a in pair)
        with self._taps_lock:  # queue workers share the cache
            hit = self._taps.get(key)
            if hit is None:
                if len(self._taps) >= self._TAPS_MAX:
                    self._taps.pop(next(iter(self._taps)))
                hit = self._taps[key] = (taps, place_taps(taps, device))
        return hit[1]

    def _note_windows_skipped(self, entry, skipped: int, total: int) -> None:
        """``--frame_delta_threshold``: the frames a video's gate skipped
        count into the ``windows_skipped`` metric and a ``delta_gated``
        manifest event."""
        if skipped > 0:
            self.telemetry.metrics.inc("windows_skipped", skipped)
            self.manifest.event("delta_gated", video=self._video_key(entry),
                                skipped=skipped, total=total)

    def _prefetch_frame_cap(self, max_bytes: int, frame_bytes: int, floor: int) -> int:
        """A prepared video's cap in frames: the byte budget split over
        the ``decode_workers + 2`` prepared videos that can be resident."""
        resident = max(int(self.config.decode_workers or 0), 1) + 2
        return max(max_bytes // resident // frame_bytes, floor)

    def warmup(self, device) -> Any:
        """Build (once) and cache this device's model state (a
        ``torch.device``, or a ``parallel.sharding.Mesh``). Thread-safe:
        queue workers on one device build it once, and workers on distinct
        devices never race the cache or the ledger's hooks. On the runs
        with telemetry on the state's modules are hooked
        (``telemetry/ledger.py::instrument_state``, labelled with the
        run's ``--sharding``): the first call per (fn family, signature)
        is a ``compile`` span and, with a ledger, records its flops and
        memory; every call still runs the module as it is."""
        state = self._device_state.get(device)
        if state is None:
            with self._build_lock:
                state = self._device_state.get(device)
                if state is None:
                    state = self._build(device)
                    if self.ledger is not None or self.telemetry.enabled:
                        from video_features_tpu_torch.parallel.sharding import is_mesh

                        instrument_state(
                            state, self.ledger, model=self.feature_type,
                            sharding=self.config.sharding,
                            device=device.first if is_mesh(device) else device,
                            telemetry=self.telemetry,
                        )
                    self._device_state[device] = state
        return state

    def __call__(
        self,
        indices: Optional[Sequence[int]] = None,
        device=None,
        worker: Optional[str] = None,
        raise_stop: bool = False,
    ) -> Optional[List[Dict[str, np.ndarray]]]:
        """Run ``indices`` (every video by default) on ``device``.
        ``worker`` names the caller's worker in spans (default: the
        device's name); queue mode passes one per worker, so two workers
        on one device stay apart. A sticky device error ends the call
        (``_stop_on_sticky``); with ``raise_stop`` it then raises
        ``LoopStopped``, so queue mode marks the worker dead and hands the
        rest of its chunk to the others."""
        if indices is None:
            indices = range(len(self.path_list))
        if device is None:
            device = resolve_device(self.config)
        state = self.warmup(device)
        # the device lane's clock: one wait before the call's first dispatch,
        # unless another worker's scope or unread phase is on the lane
        self.telemetry.anchor_device(device)
        wid = worker or str(device)
        indices = [int(i) for i in indices]
        results: List = []  # external_call: (position, feats_dict) pairs
        stop: Optional[LoopStopped] = None
        try:
            with device_trace(self.config.profile_dir):
                if self._lockstep():
                    self._run_lockstep(indices, device, wid, state, results)
                elif len(indices) > 1 and int(self.config.decode_workers or 0) >= 1:
                    self._run_pipelined(indices, device, wid, state, results)
                else:
                    self._run_serial(indices, device, wid, state, results)
        except LoopStopped as e:
            stop = e
        finally:
            self.manifest.close()
            self.telemetry.resolve_device()
        # the stage totals reach summary.json through the metrics snapshot;
        # the printed summary stays behind --profile_dir
        self.telemetry.flush()
        if self.config.profile_dir:
            print(self.timer.summary())
        if stop is not None and raise_stop:
            raise stop
        if self.external_call:
            return [d for _, d in sorted(results, key=lambda t: t[0])]
        return None

    def run_paths(
        self, entries: Sequence[Any], device: Optional[torch.device] = None
    ) -> Optional[List[Dict[str, np.ndarray]]]:
        """Run extraction over ``entries`` (paths) on an extractor that may
        already have processed other videos — the serve daemon's dispatch
        surface.

        Appends to ``path_list`` and runs the normal ``__call__`` loop
        over just the new indices, so the warm ``_device_state`` (loaded
        weights, placed taps) is reused as-is: a group of same-shape
        entries with ``--video_batch`` > 1 fuses exactly like a batch
        run's would, and retries/manifest all apply per entry. Extractors
        are built once per daemon lifetime and path_list grows
        monotonically; each entry is a fresh manifest identity even if
        the same path was run before."""
        entries = list(entries)
        if not entries:
            return [] if self.external_call else None
        start = len(self.path_list)
        self.path_list.extend(entries)
        if self.telemetry.total_videos is not None:
            self.telemetry.total_videos = len(self.path_list)
        return self(range(start, len(self.path_list)), device)

    # --- the two loops ------------------------------------------------------
    def _run_serial(self, indices, device, wid: str, state, results) -> None:
        """Each video prepared and computed in turn, over a retry deque: a
        retry goes to the back with its backoff deadline (``not_before``).
        ``wid`` labels the spans; ``device`` names a sticky death."""
        queue: deque = deque((pos, idx, 1, 0.0) for pos, idx in enumerate(indices))
        while queue:
            pos, idx, attempt, not_before = queue.popleft()
            entry = self.path_list[idx]
            if attempt == 1:
                reason = self._resume_skip_reason(entry)
                if reason is not None:
                    self._skip(entry, reason)
                    continue
                if self._try_cache_hit(entry):
                    continue
            wait = not_before - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            self._mark_start(entry)
            try:
                try:
                    if attempt == 1:
                        self._preflight_entry(entry)
                    with self.telemetry.span("extract", video=self._video_key(entry),
                                             attempt=attempt, worker=wid):
                        payload = self.prepare(entry)
                        with self.telemetry.device_scope(device, wid,
                                                         video=self._video_key(entry)):
                            feats_dict = self.extract_prepared(state, payload)
                finally:
                    self._drain_decode_warnings(entry)  # decoded on this thread
                self._sink_or_collect(feats_dict, entry, results, pos)
            except KeyboardInterrupt:
                raise
            except Exception:  # noqa: BLE001 - classify, maybe retry

                def requeue(delay, pos=pos, idx=idx, attempt=attempt):
                    queue.append((pos, idx, attempt + 1, time.monotonic() + delay))

                self._on_failure(entry, "extract", attempt, requeue=requeue, device=device)
                continue
            self._on_success(entry, attempt)

    def _run_lockstep(self, indices, device, wid: str, state, results) -> None:
        """The loop of a mesh across launched processes (``_lockstep``):
        ``_run_serial``'s, with each outcome taken together. Every process
        runs every video's collectives in the same order, so none may
        retry, skip or fail a video alone. After the prepare, and again
        after the forward and the sink (which process 0 alone runs), every
        process gives its outcome to one gather (``_agree``), and all take
        the same decision: go on, retry the video together at the back of
        the same queue, or record it failed and go on. A failure inside
        the forward cannot be agreed on, as the other processes may be
        waiting in one of its collectives: it stops the run
        (``_stop_on_sticky``), and theirs then fail. No decode threads and
        no ``--video_batch`` groups here: each video is one step of all
        the processes."""
        queue: deque = deque((pos, idx, 1, 0.0) for pos, idx in enumerate(indices))
        while queue:
            pos, idx, attempt, not_before = queue.popleft()
            entry = self.path_list[idx]
            if attempt == 1:
                reason = self._resume_skip_reason(entry)
                if reason is not None:
                    self._skip(entry, reason)
                    continue
            wait = not_before - time.monotonic()
            if wait > 0:
                time.sleep(wait)

            def requeue(delay, pos=pos, idx=idx, attempt=attempt):
                queue.append((pos, idx, attempt + 1, time.monotonic() + delay))

            self._mark_start(entry)
            with self.telemetry.span("extract", video=self._video_key(entry),
                                     attempt=attempt, worker=wid):
                payload = err = None
                try:
                    if attempt == 1:
                        self._preflight_entry(entry)
                    payload = self.prepare(entry)
                except KeyboardInterrupt:
                    raise
                except Exception as e:  # noqa: BLE001 - agreed on below
                    err = e
                self._drain_decode_warnings(entry)
                if not self._agree(entry, "prepare", attempt, err, requeue, device):
                    continue
                try:
                    feats_dict = self.extract_prepared(state, payload)
                except KeyboardInterrupt:
                    raise
                except Exception:  # noqa: BLE001 - the others may wait in a collective
                    self._stop_on_sticky([(entry, attempt)], "dispatch", device)
                finally:
                    self._drain_decode_warnings(entry)
            err = None
            try:
                self._sink_or_collect(feats_dict, entry, results, pos)
            except KeyboardInterrupt:
                raise
            except Exception as e:  # noqa: BLE001 - agreed on below
                err = e
            if self._agree(entry, "sink", attempt, err, requeue, device):
                self._on_success(entry, attempt)

    def _run_pipelined(self, indices, device, wid: str, state, results) -> None:
        """The JAX package's ``_run_pipelined`` (module docstring), with its
        spans, counters and queue-depth gauges. ``prepare`` (and the
        preflight probe of a first attempt) runs on ``--decode_workers``
        host threads; the device half on this thread. A retry re-enters
        ``pending`` as a fresh prepare future once its backoff timer
        fires, from any drain, so the final drain is one loop that also
        waits on armed timers."""
        workers = max(1, int(self.config.decode_workers))
        depth = workers + 1  # prepared and waiting beyond the one consumed
        split = self._supports_device_pipeline()
        agg = self._aggregation_enabled()
        group_size = max(int(self.config.video_batch or 1), 1)
        groups: Dict[Any, list] = {}  # agg_key -> [(pos, idx, attempt, entry, payload)]
        # entries: ([(pos, idx, attempt, entry), ...], handle, grouped,
        # host payloads of a group, kept for its solo fallback)
        inflight = CompletionQueue(int(self.config.inflight_groups))
        pending: deque = deque()  # (pos, idx, attempt, prepare future)
        timers = RequeueTimers()
        stop_lock = threading.Lock()
        stopped: List[bool] = []  # set at a sticky error: timers submit nothing

        def prep(entry, attempt: int):
            self._mark_start(entry)
            with self.telemetry.span("prepare", video=self._video_key(entry),
                                     attempt=attempt, worker=wid):
                faults.fire("prepare")
                if attempt == 1:  # a reject fails permanent from the future
                    self._preflight_entry(entry)
                try:
                    return self.prepare(entry)
                finally:
                    self._drain_decode_warnings(entry)  # this worker's notes

        def requeue(pos, idx, attempt):
            def do(delay: float) -> None:
                def fire() -> None:
                    with stop_lock:
                        if not stopped:
                            pending.append((pos, idx, attempt + 1,
                                            pool.submit(prep, self.path_list[idx], attempt + 1)))

                timers.schedule(delay, fire)

            return do

        def sink_one(pos, idx, attempt, entry, feats_dict) -> None:
            try:
                self._sink_or_collect(feats_dict, entry, results, pos)
            except KeyboardInterrupt:
                raise
            except Exception:  # noqa: BLE001 - this video's sink failed
                self._on_failure(entry, "sink", attempt, requeue=requeue(pos, idx, attempt),
                                 device=device)
                return
            self._on_success(entry, attempt)

        def run_solo(pos, idx, attempt, entry, payload, inject: bool = True) -> None:
            """The solo device path of one prepared video (the non-split
            extractors', and the group fallback's, which passes
            ``inject=False`` so the dispatch injection cannot fail again
            the members it is recovering)."""
            try:
                try:
                    if inject:
                        faults.fire("dispatch")
                    with self.telemetry.span("dispatch", video=self._video_key(entry),
                                             attempt=attempt, worker=wid), \
                            self.telemetry.device_scope(device, wid, video=self._video_key(entry)):
                        self.telemetry.count_h2d(payload)
                        feats_dict = self.extract_prepared(state, payload)
                finally:
                    self._drain_decode_warnings(entry)  # a streamed payload decodes here
            except KeyboardInterrupt:
                raise
            except Exception:  # noqa: BLE001 - classify, maybe retry
                self._on_failure(entry, "dispatch", attempt, requeue=requeue(pos, idx, attempt),
                                 device=device)
                return
            sink_one(pos, idx, attempt, entry, feats_dict)

        def solo_fallback(items, phase: str, fused_err: str) -> None:
            """A fused dispatch or fetch failed: re-run every member alone,
            so at most the truly bad video is lost. Callers leave their
            ``except`` block and drop the group's handle first: a live
            traceback would pin the group's device tensors while the
            re-runs need that memory."""
            print(f"Fused --video_batch {phase} failed for a group of {len(items)}; "
                  "falling back to per-video dispatch:")
            print(fused_err, end="")
            self.manifest.event(
                "group_fallback",
                phase=phase,
                size=len(items),
                videos=[self._video_key(e) for _, _, _, e, _ in items],
                message=fused_err.strip().splitlines()[-1][:300] if fused_err else None,
            )
            for pos, idx, attempt, e, p in items:
                run_solo(pos, idx, attempt, e, p, inject=False)

        def drain_completed(only_ready: bool = False) -> bool:
            """Fetch and sink the oldest in-flight entry; with
            ``only_ready``, only if its device work has already completed
            (a non-blocking probe). Returns whether an entry was drained."""
            if only_ready and not inflight.head_ready():
                return False
            slots, handle, grouped, payloads = inflight.pop()
            self.telemetry.metrics.set_gauge("queue_depth.inflight", len(inflight))
            if grouped:
                fused_err = None
                try:
                    with self.telemetry.span("fetch", worker=wid, group_size=len(slots)):
                        dicts = self.fetch_group(handle)
                except KeyboardInterrupt:
                    raise
                except Exception as exc:  # noqa: BLE001 - a fused fetch fails together
                    if faults.is_sticky(exc):
                        self._stop_on_sticky([(e, att) for _, _, att, e in slots], "fetch", device)
                    fused_err = traceback.format_exc()
                if fused_err is not None:
                    del handle  # free the group's device memory before the re-runs
                    solo_fallback([(pos, idx, att, e, p)
                                   for (pos, idx, att, e), p in zip(slots, payloads)],
                                  "fetch", fused_err)
                    return True
                for (pos, idx, att, e), d in zip(slots, dicts):
                    sink_one(pos, idx, att, e, d)
                return True
            pos, idx, attempt, entry = slots[0]
            try:
                with self.telemetry.span("fetch", video=self._video_key(entry),
                                         attempt=attempt, worker=wid):
                    feats_dict = self.fetch_dispatched(handle)
            except KeyboardInterrupt:
                raise
            except Exception:  # noqa: BLE001 - classify, maybe retry
                self._on_failure(entry, "dispatch", attempt, requeue=requeue(pos, idx, attempt),
                                 device=device)
                return True
            sink_one(pos, idx, attempt, entry, feats_dict)
            return True

        def drain_to_capacity() -> None:
            """After a dispatch: block on the oldest entry while the window
            is full, then sink whatever else has already completed."""
            while inflight.full:
                drain_completed()
            while drain_completed(only_ready=True):
                pass

        def dispatch_group_now(items) -> None:  # items: [(pos, idx, attempt, entry, payload)]
            payloads = [p for *_, p in items]
            fused_err = staged = None
            try:
                # one dispatch injection per group: the group is one dispatch
                faults.fire("dispatch")
                with self.telemetry.device_scope(
                        device, wid, group_size=len(items),
                        videos=[self._video_key(e) for _, _, _, e, _ in items]):
                    with self.telemetry.span("h2d", worker=wid, group_size=len(items)):
                        for p in payloads:
                            self.telemetry.count_h2d(p)
                        staged = self.transfer_group(state, payloads)
                    with self.telemetry.span("dispatch", worker=wid, group_size=len(items)):
                        handle = self.dispatch_group(
                            state, staged if staged is not None else payloads)
            except KeyboardInterrupt:
                raise
            except Exception as exc:  # noqa: BLE001 - a fused dispatch fails together
                if faults.is_sticky(exc):
                    self._stop_on_sticky([(e, att) for _, _, att, e, _ in items], "dispatch",
                                         device)
                fused_err = traceback.format_exc()
            if fused_err is not None:
                staged = None  # free the staged group before the re-runs
                solo_fallback(items, "dispatch", fused_err)
                return
            inflight.push([(pos, idx, att, e) for pos, idx, att, e, _ in items],
                          handle, True, payloads)
            self.telemetry.metrics.set_gauge("queue_depth.inflight", len(inflight))
            drain_to_capacity()

        def dispatch_single(pos, idx, attempt, entry, payload) -> None:
            if not split:
                run_solo(pos, idx, attempt, entry, payload)
                return
            try:
                try:
                    faults.fire("dispatch")
                    with self.telemetry.span("dispatch", video=self._video_key(entry),
                                             attempt=attempt, worker=wid), \
                            self.telemetry.device_scope(device, wid, video=self._video_key(entry)):
                        self.telemetry.count_h2d(payload)
                        handle = self.dispatch_prepared(state, payload)
                finally:
                    self._drain_decode_warnings(entry)  # a streamed payload decodes here
            except KeyboardInterrupt:
                raise
            except Exception:  # noqa: BLE001 - classify, maybe retry
                self._on_failure(entry, "dispatch", attempt, requeue=requeue(pos, idx, attempt),
                                 device=device)
            else:
                inflight.push([(pos, idx, attempt, entry)], handle, False, None)
                self.telemetry.metrics.set_gauge("queue_depth.inflight", len(inflight))
            drain_to_capacity()

        def consume_one() -> None:
            pos, idx, attempt, fut = pending.popleft()
            # how full the host-to-device pipeline is at each consume:
            # prepare futures, payloads waiting in group buffers, dispatches
            metrics = self.telemetry.metrics
            metrics.set_gauge("queue_depth.pending", len(pending))
            metrics.set_gauge("queue_depth.inflight", len(inflight))
            metrics.set_gauge("queue_depth.prepared",
                              sum(len(b) for b in groups.values()) if agg else 0)
            entry = self.path_list[idx]
            try:
                payload = fut.result()
                key = self.agg_key(payload) if agg else None
                if key is not None:
                    self.telemetry.note_bucket(key)
            except KeyboardInterrupt:
                raise
            except Exception:  # noqa: BLE001 - prepare or decode failed: classify
                self._on_failure(entry, "prepare", attempt, requeue=requeue(pos, idx, attempt),
                                 device=device)
                return
            if key is not None:
                buf = groups.setdefault(key, [])
                buf.append((pos, idx, attempt, entry, payload))
                if len(buf) >= group_size:
                    del groups[key]
                    dispatch_group_now(buf)
                return
            dispatch_single(pos, idx, attempt, entry, payload)

        with ThreadPoolExecutor(max_workers=workers,
                                thread_name_prefix=f"decode-{wid}") as pool:
            try:
                for pos, idx in enumerate(indices):
                    entry = self.path_list[idx]
                    reason = self._resume_skip_reason(entry)
                    if reason is not None:
                        self._skip(entry, reason)
                        continue
                    if self._try_cache_hit(entry):
                        continue
                    pending.append((pos, idx, 1, pool.submit(prep, entry, 1)))
                    if len(pending) > depth:
                        consume_one()
                while pending or groups or inflight or timers.pending():
                    while pending:
                        consume_one()
                    for key in list(groups):  # flush the partial groups
                        buf = groups.pop(key)
                        if buf:
                            dispatch_group_now(buf)
                    while inflight and not pending:
                        drain_completed()
                    if not (pending or groups or inflight):
                        timers.wait_any(0.05)  # only armed backoff timers remain
            except LoopStopped:
                with stop_lock:
                    stopped.append(True)
                pool.shutdown(wait=True, cancel_futures=True)
                raise

    # --- outcomes -----------------------------------------------------------
    def _sink_or_collect(self, feats_dict, entry, results, order: int) -> None:
        """``order`` is the video's position in the caller's indices:
        external_call results are returned sorted by it. In a mesh across
        launched processes only process 0 writes: every process runs the
        same loop over the same videos, the features are on all of them
        (``sharding.gather_rows``), and one writer is enough. Queue mode's
        processes ran disjoint videos, so each writes its own."""
        if self.external_call:
            results.append((order, feats_dict))
            return
        if self._lockstep() and distributed.process_index() != 0:
            return
        with self.telemetry.span("sink", video=self._video_key(entry)):
            warnings = action_on_extraction(
                feats_dict, video_path_of(entry), self.output_path,
                self.config.on_extraction, self.config.output_direct,
            )
        for w in warnings:  # empty features: --strict fails the run on them
            self.manifest.record(self._video_key(entry), "warning", stage="sink", message=w)
        self._cache_publish(entry)

    def _video_key(self, entry) -> str:
        """The manifest's key for a path-list entry."""
        return str(video_path_of(entry))

    def _mark_start(self, entry) -> None:
        self._t0[self._video_key(entry)] = time.monotonic()

    def _wall(self, entry) -> Optional[float]:
        t0 = self._t0.get(self._video_key(entry))
        return time.monotonic() - t0 if t0 is not None else None

    def _on_success(self, entry, attempt: int, note: Optional[str] = None) -> None:
        self.telemetry.metrics.inc("videos_done")
        extra = {"note": note} if note else {}
        self.manifest.record(
            self._video_key(entry), "done", attempts=attempt, wall_s=self._wall(entry), **extra
        )

    # --- the content-addressed feature cache (extract/cache.py) -------------
    @staticmethod
    def _cacheable_entry(entry) -> bool:
        """(video, flow dir) pairs are never cached: the content hash
        covers only the video, so a changed flow dir would be served stale
        features."""
        return not (isinstance(entry, (tuple, list)) and len(entry) > 1 and entry[1])

    def _try_cache_hit(self, entry) -> bool:
        """Content-addressed short-circuit before any decode work: when
        the store holds this (content hash, config digest), materialize
        the payloads onto the expected output paths and count the video
        done (manifest note ``cache_hit``): nothing is decoded and no
        kernel launches. Every cache-side failure — unreadable input,
        corrupt entry, vanished payload — is a miss; the real extraction
        path is always the fallback."""
        if self._feature_cache is None or not self._cacheable_entry(entry):
            return False
        video = self._video_key(entry)
        keys = self.feature_keys()
        try:
            chash = self._feature_cache.content_hash(video)
        except OSError:
            return False  # unreadable input: let the real path report it
        cached = self._feature_cache.lookup(chash, self._cache_digest, keys)
        if cached is not None:
            try:
                with self.telemetry.span("cache_hit", video=video):
                    self._feature_cache.materialize(cached, self._feature_cache.dest_files(
                        keys, video, self.output_path, self.config.on_extraction,
                        self.config.output_direct,
                    ))
            except OSError:
                cached = None  # payload vanished mid-copy: treat as miss
        if cached is None:
            self.telemetry.metrics.inc(f"cache_miss.{self.feature_type}")
            return False
        self.telemetry.metrics.inc(f"cache_hit.{self.feature_type}")
        self._on_success(entry, 1, note="cache_hit")
        return True

    def _cache_publish(self, entry) -> None:
        """Populate the store from the files the sink just committed
        atomically. Claim-by-rename semantics: losing to a concurrent
        writer is a no-op, and any OSError leaves the store unchanged."""
        if self._feature_cache is None or not self._cacheable_entry(entry):
            return
        video = self._video_key(entry)
        try:
            chash = self._feature_cache.content_hash(video)
        except OSError:
            return
        dests = self._feature_cache.dest_files(
            self.feature_keys(), video, self.output_path, self.config.on_extraction,
            self.config.output_direct,
        )
        if not all(os.path.exists(p) for p in dests.values()):
            return
        self._feature_cache.publish(chash, self._cache_digest, dests,
                                    feature_type=self.feature_type)

    def _on_failure(self, entry, stage: str, attempt: int, requeue=None, device=None) -> None:
        """The per-video failure policy, called from an ``except`` block
        (the live exception is read off ``sys.exc_info``): a transient or
        oom failure with attempts left is recorded as ``retry`` and handed
        to ``requeue(delay)``; any other is recorded as ``failed`` and
        printed; a sticky device error stops the loop (``_stop_on_sticky``,
        naming ``device``).
        An exception's own ``stage`` (decode errors, injected faults)
        overrides the caller's coarser label."""
        exc = sys.exc_info()[1]
        if exc is not None and faults.is_sticky(exc):
            self._stop_on_sticky([(entry, attempt)], stage, device)
        stage = getattr(exc, "stage", None) or stage
        error_class = faults.classify_error(exc) if exc is not None else "permanent"
        video = self._video_key(entry)
        retries = int(self.config.retries)
        record = dict(
            stage=stage, error_class=error_class,
            error_type=type(exc).__name__ if exc is not None else None,
            message=str(exc) if exc is not None else None,
            attempts=attempt, wall_s=self._wall(entry),
        )
        # the failing stage's span (stamped by Telemetry.span on the way
        # out, innermost wins) links the record to _telemetry/spans-*.jsonl
        span_id = getattr(exc, "telemetry_span", None)
        if span_id is not None:
            record["span"] = span_id
        if requeue is not None and faults.is_retryable(error_class) and attempt <= retries:
            delay = faults.backoff_delay(attempt, float(self.config.retry_backoff), video)
            self.telemetry.metrics.inc("retries")
            self.manifest.record(video, "retry", **record)
            print(
                f"Transient {stage} failure for {video} (attempt {attempt}/{retries + 1}): "
                f"{type(exc).__name__}: {exc}; retrying in {delay:.2f}s"
            )
            requeue(delay)
            return
        self.manifest.record(video, "failed", **record)
        print(f"An error occurred extracting {video_path_of(entry)}:")
        traceback.print_exc()
        print("Continuing...")

    def _agree(self, entry, stage: str, attempt: int, exc: Optional[BaseException],
               requeue, device) -> bool:
        """One step of a lockstep video (``_run_lockstep``) on every
        process: each gives its outcome, ``exc`` or None, to one gather,
        and True comes back when none failed. Otherwise every process
        takes the worst outcome's decision through the failure policy,
        with its own exception or a ``faults.PeerFailure`` that names the
        processes that failed: a retry together (``requeue``) while every
        failure is retryable and attempts are left, else a failed record;
        a sticky error anywhere stops every process."""
        code = _OK
        if exc is not None:
            code = (_STOP if faults.is_sticky(exc) else
                    _RETRY if faults.is_retryable(faults.classify_error(exc)) else _FAIL)
        codes = distributed.all_gather_int(code)
        worst = max(codes)
        if worst == _OK:
            return True
        if exc is None:
            failed = [rank for rank, c in enumerate(codes) if c != _OK]
            exc = faults.PeerFailure(f"{stage} failed on process(es) {failed} of the mesh",
                                     "transient" if worst == _RETRY else "permanent")
        try:
            raise exc
        except Exception:  # noqa: BLE001 - the policy reads it off sys.exc_info
            if worst == _STOP:
                self._stop_on_sticky([(entry, attempt)], stage, device)
            self._on_failure(entry, stage, attempt,
                             requeue=requeue if worst == _RETRY else None, device=device)
        return False

    def _stop_on_sticky(self, members, stage: str, device=None) -> None:
        """At a sticky device error, called from its ``except`` block:
        record each of the failing dispatch's ``(entry, attempt)`` members
        as failed and one ``worker_death`` event naming ``device``, then raise
        ``LoopStopped``. Every later launch in this process would fail the
        same way, so the videos not yet attempted are left without a
        record, for ``--resume``."""
        exc = sys.exc_info()[1]
        stage = getattr(exc, "stage", None) or stage
        span_id = getattr(exc, "telemetry_span", None)
        for entry, attempt in members:
            self.manifest.record(
                self._video_key(entry), "failed", stage=stage,
                error_class=faults.classify_error(exc), error_type=type(exc).__name__,
                message=str(exc), attempts=attempt, wall_s=self._wall(entry),
                **({"span": span_id} if span_id is not None else {}),
            )
        self.manifest.event(
            "worker_death", device=None if device is None else str(device), phase=stage,
            error_type=type(exc).__name__, message=str(exc)[:300],
        )
        videos = ", ".join(str(video_path_of(e)) for e, _ in members)
        print(f"A sticky device error occurred extracting {videos}:")
        traceback.print_exc()
        print("Stopping: every later launch in this process would fail the same way; "
              "the videos not attempted yet are left for --resume.")
        raise LoopStopped(str(exc), videos=[self._video_key(e) for e, _ in members]) from exc

    def _preflight_entry(self, entry) -> None:
        """``--preflight on``: probe the input before its first attempt,
        record the probe's cautions as warnings, and raise its permanent
        error on a reject (``MediaRejected``, or ``ResourceCapExceeded``
        over a cap), stage ``preflight``, before any decode or retry is
        spent on it."""
        if self.config.preflight != "on":
            return
        video = self._video_key(entry)
        report = preflight(video, need=self.media_need, caps=self._resource_caps)
        for w in report.warnings:
            self.manifest.record(video, "warning", stage="preflight", message=w)
        if report.verdict == "reject":
            raise report.to_error()

    def _drain_decode_warnings(self, entry) -> None:
        """This thread's decode notes (``io/video.py``) into the manifest
        as the video's warnings. Runs on the thread that decoded."""
        for note in pop_decode_warnings():
            extra = {k: v for k, v in note.items() if k not in ("kind", "message")}
            self.manifest.record(self._video_key(entry), "warning", stage="decode",
                                 kind=note.get("kind"), message=note.get("message"), **extra)

    def _resume_skip_reason(self, entry) -> Optional[str]:
        """Why ``--resume`` skips this video, or None to process it: its
        outputs exist, or an earlier run recorded a permanent failure.

        A mesh across launched processes takes process 0's answer
        (``distributed.broadcast_one_to_all``), as the JAX package's
        ``_already_done`` does: only process 0 writes (``_sink_or_collect``),
        so a probe of the other hosts' files diverges, and one process
        skipping a video the others compute would leave every sharded
        collective of it waiting. The broadcast is itself a collective,
        safe because in mesh mode every process asks for every video in
        the same order. It covers the prior-failure check too, which the
        JAX package leaves local: another host's manifest may lack
        process 0's failure record. Queue mode must not broadcast: its
        processes run disjoint videos, and the local probe is right."""
        if not self.config.resume or self.external_call:
            return None
        reason = None
        if self._video_key(entry) in self._prior_failed:
            reason = _SKIP_REASONS[1]
        elif self._already_done(entry):
            reason = _SKIP_REASONS[2]
        if self._lockstep():
            reason = _SKIP_REASONS[distributed.broadcast_one_to_all(_SKIP_REASONS.index(reason))]
        return reason

    def _lockstep(self) -> bool:
        """A mesh across launched processes: every process runs every
        video's collectives, in the same order."""
        return self.config.sharding == "mesh" and distributed.multihost()

    def _skip(self, entry, reason: str) -> None:
        print(f"Skipping {video_path_of(entry)}: {reason} (--resume)")
        self.manifest.record(self._video_key(entry), "skipped", message=reason)
