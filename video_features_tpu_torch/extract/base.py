"""Extractor runtime: the per-video loop every feature type shares, and
its run contract.

Counterpart of ``video_features_tpu/extract/base.py``: the path list is
formed in ``__init__``, the model is built once per device (``warmup``),
and ``__call__`` runs the videos. Results go to the output sink or, with
``external_call``, back to the caller in the order of the indices given.

The run contract (``runtime/faults.py``):

- every outcome of a save run (or of a ``--strict`` or ``--fault_inject``
  run) is one record under ``<output_path>/_manifest/``: done, retry,
  failed (with its stage and error class), skipped, or a sink warning;
- a transient or oom failure goes back in the queue after a backoff, up
  to ``--retries`` times; any other failure is recorded and printed, and
  the loop goes on with the next video;
- ``--resume`` skips a video whose output files all exist, or that an
  earlier run recorded as a permanent failure (unless ``--retry_failed``).

With ``--decode_workers N >= 1`` and more than one video, ``prepare``
runs on N host threads while ``forward`` runs on the calling thread, with
at most N + 1 prepared payloads waiting; with 0 (or one video) each video
is prepared and computed in turn.

A subclass implements ``_build(device)`` (the model state), ``prepare``
(host: decode and preprocess one video; thread-safe, and touches no CUDA)
and ``forward`` (device: the model on a prepared payload, returning the
feature dict).
"""

from __future__ import annotations

import os
import sys
import time
import traceback
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from video_features_tpu_torch.config import ExtractionConfig
from video_features_tpu_torch.devices import pin_fp32, resolve_device
from video_features_tpu_torch.extract.ingest import RequeueTimers
from video_features_tpu_torch.io.paths import form_list_from_user_input, video_path_of
from video_features_tpu_torch.io.sink import action_on_extraction, expected_output_files
from video_features_tpu_torch.runtime import faults
from video_features_tpu_torch.runtime.faults import NULL_MANIFEST, RunManifest


class BaseExtractor:
    feature_type: str = ""

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
        faults.install_injector(self.config.fault_inject)
        self._t0: Dict[str, float] = {}  # video key -> this attempt's start
        self._prior_failed: set = set()
        if self.config.resume and not external_call and not self.config.retry_failed:
            self._prior_failed = faults.permanently_failed_videos(self.config.output_path)

    def feature_keys(self) -> List[str]:
        """The keys a feature dict carries, whose files ``--resume`` probes
        (i3d overrides this with its streams)."""
        return [self.feature_type]

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

    def forward(self, state: Any, payload: Any) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def warmup(self, device: torch.device) -> Any:
        """Build (once) and cache this device's model state."""
        state = self._device_state.get(device)
        if state is None:
            state = self._device_state[device] = self._build(device)
        return state

    def __call__(
        self,
        indices: Optional[Sequence[int]] = None,
        device: Optional[torch.device] = None,
    ) -> Optional[List[Dict[str, np.ndarray]]]:
        if indices is None:
            indices = range(len(self.path_list))
        if device is None:
            device = resolve_device(self.config)
        state = self.warmup(device)
        indices = [int(i) for i in indices]
        results: List = []  # external_call: (position, feats_dict) pairs
        try:
            if len(indices) > 1 and int(self.config.decode_workers or 0) >= 1:
                self._run_pipelined(indices, state, results)
            else:
                self._run_serial(indices, state, results)
        finally:
            self.manifest.close()
        if self.external_call:
            return [d for _, d in sorted(results, key=lambda t: t[0])]
        return None

    # --- the two loops ------------------------------------------------------
    def _run_serial(self, indices, state, results) -> None:
        """Each video prepared and computed in turn, over a retry deque: a
        retry goes to the back with its backoff deadline (``not_before``)."""
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
            self._mark_start(entry)
            try:
                feats_dict = self.forward(state, self.prepare(entry))
                self._sink_or_collect(feats_dict, entry, results, pos)
            except KeyboardInterrupt:
                raise
            except Exception:  # noqa: BLE001 - classify, maybe retry

                def requeue(delay, pos=pos, idx=idx, attempt=attempt):
                    queue.append((pos, idx, attempt + 1, time.monotonic() + delay))

                self._on_failure(entry, "extract", attempt, requeue=requeue)
                continue
            self._on_success(entry, attempt)

    def _run_pipelined(self, indices, state, results) -> None:
        """``prepare`` on ``--decode_workers`` host threads, ``forward`` on
        this thread: while video k computes, videos k+1..k+N decode. At
        most N + 1 prepared payloads wait beyond the one being consumed,
        so host memory stays bounded. A retry re-enters ``pending`` as a
        fresh prepare future once its backoff timer fires."""
        workers = max(1, int(self.config.decode_workers))
        depth = workers + 1
        pending: deque = deque()  # (pos, idx, attempt, prepare future)
        timers = RequeueTimers()

        def prep(entry, attempt: int):
            self._mark_start(entry)
            faults.fire("prepare")
            return self.prepare(entry)

        def requeue(pos, idx, attempt):
            def do(delay: float) -> None:
                def fire() -> None:
                    entry = self.path_list[idx]
                    pending.append((pos, idx, attempt + 1, pool.submit(prep, entry, attempt + 1)))

                timers.schedule(delay, fire)

            return do

        def consume_one() -> None:
            pos, idx, attempt, fut = pending.popleft()
            entry = self.path_list[idx]
            stage = "prepare"
            try:
                payload = fut.result()
                stage = "dispatch"
                faults.fire("dispatch")
                feats_dict = self.forward(state, payload)
                stage = "sink"
                self._sink_or_collect(feats_dict, entry, results, pos)
            except KeyboardInterrupt:
                raise
            except Exception:  # noqa: BLE001 - classify, maybe retry
                self._on_failure(entry, stage, attempt, requeue=requeue(pos, idx, attempt))
                return
            self._on_success(entry, attempt)

        with ThreadPoolExecutor(max_workers=workers, thread_name_prefix="decode") as pool:
            for pos, idx in enumerate(indices):
                entry = self.path_list[idx]
                reason = self._resume_skip_reason(entry)
                if reason is not None:
                    self._skip(entry, reason)
                    continue
                pending.append((pos, idx, 1, pool.submit(prep, entry, 1)))
                if len(pending) > depth:
                    consume_one()
            # a retry re-enters `pending` from any consume, possibly through
            # a timer still armed: drain until neither is left
            while pending or timers.pending():
                while pending:
                    consume_one()
                if timers.pending():
                    timers.wait_any(0.05)

    # --- outcomes -----------------------------------------------------------
    def _sink_or_collect(self, feats_dict, entry, results, order: int) -> None:
        """``order`` is the video's position in the caller's indices:
        external_call results are returned sorted by it."""
        if self.external_call:
            results.append((order, feats_dict))
            return
        warnings = action_on_extraction(
            feats_dict, video_path_of(entry), self.output_path,
            self.config.on_extraction, self.config.output_direct,
        )
        for w in warnings:  # empty features: --strict fails the run on them
            self.manifest.record(self._video_key(entry), "warning", stage="sink", message=w)

    def _video_key(self, entry) -> str:
        """The manifest's key for a path-list entry."""
        return str(video_path_of(entry))

    def _mark_start(self, entry) -> None:
        self._t0[self._video_key(entry)] = time.monotonic()

    def _wall(self, entry) -> Optional[float]:
        t0 = self._t0.get(self._video_key(entry))
        return time.monotonic() - t0 if t0 is not None else None

    def _on_success(self, entry, attempt: int) -> None:
        self.manifest.record(
            self._video_key(entry), "done", attempts=attempt, wall_s=self._wall(entry)
        )

    def _on_failure(self, entry, stage: str, attempt: int, requeue=None) -> None:
        """The per-video failure policy, called from an ``except`` block
        (the live exception is read off ``sys.exc_info``): a transient or
        oom failure with attempts left is recorded as ``retry`` and handed
        to ``requeue(delay)``; any other is recorded as ``failed`` and
        printed. An exception's own ``stage`` (decode errors, injected
        faults) overrides the caller's coarser label."""
        exc = sys.exc_info()[1]
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
        if requeue is not None and faults.is_retryable(error_class) and attempt <= retries:
            delay = faults.backoff_delay(attempt, float(self.config.retry_backoff), video)
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

    def _resume_skip_reason(self, entry) -> Optional[str]:
        """Why ``--resume`` skips this video, or None to process it: its
        outputs exist, or an earlier run recorded a permanent failure."""
        if not self.config.resume or self.external_call:
            return None
        if self._video_key(entry) in self._prior_failed:
            return "prior permanent failure (pass --retry_failed to re-attempt)"
        if self._already_done(entry):
            return "outputs exist"
        return None

    def _skip(self, entry, reason: str) -> None:
        print(f"Skipping {video_path_of(entry)}: {reason} (--resume)")
        self.manifest.record(self._video_key(entry), "skipped", message=reason)
