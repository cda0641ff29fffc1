"""Shared-ingest planner: decode once, fan raw frames out to N models.

Counterpart of ``video_features_tpu/extract/plan.py``, copied as it is
but for :func:`run_multi`, which drives the port's extractors on its one
device. Without it, a CLIP+I3D+VGGish request for one video decodes the
file once per model. This module inverts that for the video extractors: a
byte-budgeted :class:`SharedFrameCache` holds each clip's full decoded
RGB frame list (plus the reader's fps/frame-count metadata), and
io/video.py's samplers consult it through the ``set_frame_cache`` hook
before opening a reader. The first toucher decodes ALL frames through
ONE reader (one ``decode`` telemetry span, which the decode-once
tests pin); every later sampler — any model, any sampling
grid — replays the cached list with zero container opens.

Replay is bit-identical to direct decode by construction: a reader's
``retrieve()`` bytes do not depend on which frames a sampler keeps
(grab does the decode; retrieve only color-converts), so serving
``frames[target]`` from the cached list yields exactly the array the
sampler would have retrieved. tests/test_torch_cache.py pins CLIP+ResNet
fan-out outputs equal to their single-model runs.

The cache is installed around a scope — :func:`run_multi` for batch
fan-out, the serve daemon for its lifetime — and entries are LRU-
evicted under the ``--ingest_cache_mb`` byte budget. A clip too big
for the budget is decoded directly (never cached, never split).

Audio extractors (VGGish) read wav files through soundfile, not
io/video.py, so the frame cache never sees them; their repeat traffic
is served by the content-addressed feature cache instead
(extract/cache.py — the hash memo covers the wav bytes).
"""

from __future__ import annotations

import contextlib
import os
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple


class CachedClip:
    """One fully-decoded clip: the frame list plus the reader metadata
    the samplers need (fps 0.0 when the container declared none — the
    consumer applies the same recorded 25.0 default as a live reader).
    Frames are marked read-only: N extractors share these arrays."""

    __slots__ = ("frames", "fps", "frame_count", "width", "height", "nbytes")

    def __init__(self, frames, fps, frame_count, width, height):
        for f in frames:
            f.setflags(write=False)
        self.frames: Tuple = tuple(frames)
        self.fps = float(fps)
        self.frame_count = int(frame_count)
        self.width = int(width)
        self.height = int(height)
        self.nbytes = sum(int(f.nbytes) for f in self.frames)


class SharedFrameCache:
    """Byte-budgeted LRU of :class:`CachedClip` keyed by
    (abspath, size, mtime_ns) — a re-encoded file under the same name
    can never serve stale frames.

    Thread contract (decode workers hit this concurrently): the map is
    lock-guarded; a per-key in-flight latch makes concurrent first
    touchers of the SAME clip decode it once (losers wait, timed, then
    re-check), while different clips decode in parallel. A builder
    that fails or exceeds the budget clears its latch and waiters fall
    back to direct decode — nobody blocks forever on a latch no one
    will set."""

    def __init__(self, max_bytes: int) -> None:
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._clips: "OrderedDict[tuple, CachedClip]" = OrderedDict()
        self._inflight: Dict[tuple, threading.Event] = {}
        self._bytes = 0
        self._hits = 0
        self._populated = 0
        self._evicted = 0

    def _key(self, path: str) -> tuple:
        st = os.stat(path)
        return (os.path.abspath(path), st.st_size, st.st_mtime_ns)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "clips": len(self._clips),
                "bytes": self._bytes,
                "hits": self._hits,
                "populated": self._populated,
                "evicted": self._evicted,
            }

    def acquire(self, path: str, decoder: Optional[str] = None) -> Optional[CachedClip]:
        """The cached clip for ``path``, populating on first touch with the
        first toucher's ``decoder`` (its config's ``--decoder``; the
        backends give the same bytes, so the key leaves it out).
        None means "decode directly": unstatable path, over-budget
        clip, or a concurrent builder that hasn't finished in time.
        Decode errors (corrupt container, timeout, resource caps)
        propagate exactly as a direct open would raise them."""
        try:
            key = self._key(path)
        except OSError:
            return None
        with self._lock:
            clip = self._clips.get(key)
            if clip is not None:
                self._clips.move_to_end(key)
                self._hits += 1
                return clip
            latch = self._inflight.get(key)
            if latch is None:
                latch = self._inflight[key] = threading.Event()
                building = True
            else:
                building = False
        if not building:
            latch.wait(60.0)
            with self._lock:
                clip = self._clips.get(key)
                if clip is not None:
                    self._clips.move_to_end(key)
                    self._hits += 1
                return clip  # None -> caller decodes directly
        clip = None
        try:
            clip = self._decode_all(path, decoder)
        finally:
            with self._lock:
                self._inflight.pop(key, None)
                if clip is not None:
                    self._store(key, clip)
            latch.set()
        return clip

    def _store(self, key: tuple, clip: CachedClip) -> None:
        # caller holds self._lock
        if clip.nbytes > self.max_bytes:
            return
        self._clips[key] = clip
        self._bytes += clip.nbytes
        self._populated += 1
        while self._bytes > self.max_bytes and len(self._clips) > 1:
            _, old = self._clips.popitem(last=False)
            self._bytes -= old.nbytes
            self._evicted += 1

    def _decode_all(self, path: str, decoder: Optional[str]) -> Optional[CachedClip]:
        from video_features_tpu_torch.io import video as vio

        frames: List = []
        total = 0
        with vio._Reader(path, decoder) as r:
            fps, declared = r.fps, r.frame_count
            width, height = r.width, r.height
            while r.grab():
                frame = r.retrieve()
                if frame is None:
                    break
                frames.append(frame)
                total += int(frame.nbytes)
                if total > self.max_bytes:
                    # too big to share: abandon (the partial prefix is
                    # useless — replay must cover the whole stream) and
                    # let every sampler decode this clip directly
                    return None
        return CachedClip(frames, fps, declared, width, height)


def cache_for(cfg, feature_types) -> Optional[SharedFrameCache]:
    """The shared-decode cache a run should install: only a multi-model
    scope can amortize a decode, and ``--ingest_cache_mb 0`` opts out."""
    budget_mb = int(getattr(cfg, "ingest_cache_mb", 0) or 0)
    if budget_mb <= 0 or len(list(feature_types)) < 2:
        return None
    return SharedFrameCache(budget_mb << 20)


@contextlib.contextmanager
def shared_frame_cache(cfg, feature_types):
    """Install the shared-decode cache into io/video.py for the scope
    of a fan-out run; always uninstalled on exit so a crashed run
    cannot leak frame memory into the next."""
    from video_features_tpu_torch.io.video import set_frame_cache

    cache = cache_for(cfg, feature_types)
    set_frame_cache(cache)
    try:
        yield cache
    finally:
        set_frame_cache(None)


def run_multi(config, feature_types, external_call: bool = False, device=None,
              built=None):
    """Batch fan-out: run each feature type's extractor over the same
    input selection with ONE shared decode per clip.

    Extractor-major order — model A finishes every video before model B
    starts — so each resident model's weights are built once; the frame
    cache (not interleaving) is what makes the second model's decode
    free. A save run puts each model on its devices as the JAX package
    does: ``resolve_devices`` of its config, then
    ``mesh_feature_extraction`` under ``--sharding mesh``, else
    ``parallel_feature_extraction`` (``device``, when given, is the one
    device instead). Returns {feature_type: extractor-call result} for
    ``external_call`` (the in-process API, on ``device`` or the config's
    first device), else {feature_type: extractor} after each save run
    completes. In a launched mesh the caller holds the process group
    around the whole loop (``cli.main``), so every model's collectives
    run in one group, in the same order on every process. ``built``,
    when given, is a list each extractor is
    appended to as soon as it is built, so the caller sees every model
    that started even when a later one raises (the CLI merges the run
    manifest from it)."""
    from video_features_tpu_torch.config import sanity_check
    from video_features_tpu_torch.extract.registry import build_extractor
    from video_features_tpu_torch.parallel.devices import resolve_devices
    from video_features_tpu_torch.parallel.scheduler import (
        mesh_feature_extraction,
        parallel_feature_extraction,
    )

    fts = list(dict.fromkeys(feature_types))
    results = {}
    with shared_frame_cache(config, fts):
        for ft in fts:
            fcfg = sanity_check(config.replace(feature_type=ft))
            ext = build_extractor(fcfg, external_call=external_call)
            if built is not None:
                built.append(ext)
            try:
                if external_call:
                    results[ft] = ext(device=device)
                    continue
                devices = [device] if device is not None else resolve_devices(fcfg)
                if fcfg.sharding == "mesh":
                    mesh_feature_extraction(ext, devices)
                else:
                    parallel_feature_extraction(ext, devices)
            finally:
                # the last telemetry drain goes before the caller's
                # manifest merge, so summary.json's telemetry block
                # covers the whole run
                ext.telemetry.close()
            results[ft] = ext
    return results
