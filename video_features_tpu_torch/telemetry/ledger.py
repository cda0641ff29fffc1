"""Device cost ledger: what each built model costs on the device.

Counterpart of ``video_features_tpu/telemetry/ledger.py``. The JAX
package reads its facts off the compiled executable (``cost_analysis``,
``memory_analysis``); eager PyTorch compiles nothing, so the port
measures the first call of each (fn family, argument signature) as it
runs. The file format, the entry keys and the projection are the JAX
package's, so either package's ``ledger`` CLI reads the other's
``cost_ledger.json``.

Three pieces:

- :class:`CostLedger` — the persistent ledger, copied as it is: one
  entry per (model, fn family, spatial bucket, sharding mode) carrying
  ``flops``, a ``memory`` block and the platform the call ran on.
  Persistence is the service-time model's (serve/costmodel.py): atomic
  ``os.replace`` rewrite, torn or missing files load silently as empty,
  snapshot under the lock but file I/O outside it. :meth:`CostLedger.
  shared` hands every component of one process (daemon + pooled
  extractors) the same instance per path. ``n_compiles`` keeps the JAX
  package's name; here it counts captures (a rebuilt extractor captures
  its entries again).
- :func:`instrument_state` — the capture seam. ``BaseExtractor.warmup``
  hands it the built state: an ``nn.Module`` is the fn family
  ``"forward"``, a dict of modules (I3D's ``{"rgb", "flow", "pwc"}``)
  one family per key. A forward pre-hook and an always-called forward
  hook on each module measure the first call per argument signature
  while it runs, under a process-wide capture lock; attribute access,
  ``state_dict`` keys and execution stay as they are. What a capture
  records:

  - ``memory.argument_bytes``: the parameters and buffers of every
    module of the built state (they are placed and evicted together, so
    all of them are resident while any one runs) plus the call's tensor
    inputs;
  - ``memory.output_bytes``: the call's output tensors;
  - ``memory.temp_bytes``: the rise of ``torch.cuda.max_memory_allocated``
    over the call after ``reset_peak_memory_stats``, less the outputs —
    only where the device reports a peak (CUDA): on the CPU it is
    absent, never 0;
  - ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count plus
    the hand-written kernels' own counts (:func:`kernel_flops`, called by
    ``ops/flash_attention.py`` and ``ops/correlation.py`` whichever
    version runs, with the plain version's operations kept out), so one
    model and bucket record the same flops on the CPU and on the card;
  - ``bytes_accessed``: absent — eager PyTorch has no figure for it.

  A capture that fails is swallowed: the dispatch always runs.
- :class:`DeviceMemorySampler` — live gauges: a thread polling
  ``torch.cuda.memory_stats`` and ``torch.cuda.mem_get_info`` of the
  daemon's device into the MetricsRegistry (``device_mem_bytes.cuda:<i>|
  <kind>``, rendered as ``vft_device_mem_bytes{device,kind}``) and the
  ``device_mem_headroom_bytes`` gauge. A CPU device sets no gauge.

HBM semantics are the JAX package's: the ``vft_hbm_bytes{model,kind}``
projection and the warmup ``--hbm_budget_bytes`` gate count only entries
whose platform has device memory (``cuda``; ``cpu`` entries project
nothing).

No torch at module scope: the ``python -m video_features_tpu_torch.
telemetry ledger`` CLI renders ledgers without it.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence

LEDGER_FILENAME = "cost_ledger.json"
SCHEMA_VERSION = 1

# entry-key separator; shared with the exposition conventions ('|' never
# appears in a feature type, fn family, WxH/shape bucket, or sharding mode)
KEY_SEP = "|"

# one capture at a time in the process: the peak-memory statistic it
# resets is the device's, not the thread's
_CAPTURE_LOCK = threading.Lock()
# the capture running on this thread, for kernel_flops and nested calls
_TLS = threading.local()


def default_ledger_path(cfg: Any) -> str:
    """Where the ledger persists: under the run's ``_telemetry`` directory
    (the JAX package puts it beside ``--compile_cache`` when one is set;
    the port has no compile cache)."""
    return os.path.join(cfg.output_path, "_telemetry", LEDGER_FILENAME)


def entry_key(model: str, family: str, bucket: str, sharding: str) -> str:
    return KEY_SEP.join((model, family, bucket, sharding))


class CostLedger:
    """Per-call cost facts keyed by (model, family, bucket, sharding),
    persisted like the service-time model. Thread-safe: the capture path
    records from extractor dispatch threads while /metrics snapshots from
    HTTP handler threads; no I/O under the lock."""

    _SHARED_LOCK = threading.Lock()
    _SHARED: Dict[str, "CostLedger"] = {}

    def __init__(self, path: Optional[str] = None, save_every: int = 1) -> None:
        # save_every=1: captures happen once per (family, signature) — a
        # handful per run — so every record can afford its atomic rewrite,
        # and a short run (or a crash) never loses the ledger.
        self.path = path
        self.save_every = max(int(save_every), 1)
        self._lock = threading.Lock()
        self._entries: Dict[str, Dict[str, Any]] = {}
        self._dirty = 0
        if path is not None:
            self._load(path)

    @classmethod
    def shared(cls, path: str) -> "CostLedger":
        """The process-shared instance for ``path`` (normalized): the
        daemon and every pooled extractor must append to ONE ledger so
        the /metrics projection and the warmup budget agree."""
        key = os.path.abspath(path)
        with cls._SHARED_LOCK:
            led = cls._SHARED.get(key)
            if led is None:
                led = cls._SHARED[key] = cls(key)
            return led

    # -- the write side (extractor dispatch threads) ----------------------

    def record(
        self,
        model: str,
        family: str,
        bucket: str,
        sharding: str,
        platform: Optional[str],
        analysis: Dict[str, Any],
    ) -> None:
        """Fold one call's facts in. Re-records of the same key (a rebuilt
        extractor, a daemon restart on the same output path) overwrite the
        facts and bump ``n_compiles``."""
        entry: Dict[str, Any] = {
            "model": model,
            "family": family,
            "bucket": bucket,
            "sharding": sharding,
        }
        if platform:
            entry["platform"] = str(platform)
        for k in ("flops", "bytes_accessed", "memory"):
            if k in analysis:
                entry[k] = analysis[k]
        key = entry_key(model, family, bucket, sharding)
        save_now = False
        with self._lock:
            prev = self._entries.get(key)
            entry["n_compiles"] = (prev.get("n_compiles", 0) if prev else 0) + 1
            self._entries[key] = entry
            self._dirty += 1
            if self.path is not None and self._dirty >= self.save_every:
                self._dirty = 0
                save_now = True
        if save_now:
            self.save()

    # -- the read side (/metrics, /v1/stats, warmup, CLI) -----------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def entries(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for _, e in sorted(self._entries.items())]

    def snapshot(self) -> Dict[str, Any]:
        """The /v1/stats ``ledger`` block: the entries plus the
        per-model HBM projection."""
        return {
            "version": SCHEMA_VERSION,
            "path": self.path,
            "entries": self.entries(),
            "hbm_projection": self.hbm_projection(),
        }

    def hbm_projection(self) -> Dict[str, Dict[str, int]]:
        """Per-model projected resident device bytes, from entries whose
        platform has device memory (anything except cpu; entries with no
        platform or no memory block are skipped — CPU runs project
        nothing, by design).

        The JAX package's approximation: arguments (weights + the largest
        input batch) / outputs / temp are MAXed across a model's entries —
        the weights dominate ``argument_bytes`` and are shared by every
        bucket, so summing would multiply the model by its bucket count —
        while generated code is SUMMED (none is recorded here). ``resident``
        is their total: the peak call's footprint."""
        out: Dict[str, Dict[str, int]] = {}
        for e in self.entries():
            platform = e.get("platform")
            mem = e.get("memory")
            if not mem or not platform or platform == "cpu":
                continue
            proj = out.setdefault(e["model"], {
                "arguments": 0, "outputs": 0, "temp": 0, "generated_code": 0,
            })
            proj["arguments"] = max(proj["arguments"], mem.get("argument_bytes", 0))
            proj["outputs"] = max(proj["outputs"], mem.get("output_bytes", 0))
            proj["temp"] = max(proj["temp"], mem.get("temp_bytes", 0))
            proj["generated_code"] += mem.get("generated_code_bytes", 0)
        for proj in out.values():
            proj["resident"] = (
                proj["arguments"] + proj["outputs"]
                + proj["temp"] + proj["generated_code"]
            )
        return out

    def projected_resident_bytes(self, models: Optional[Sequence[str]] = None) -> int:
        """Total projected resident set across ``models`` (default: every
        model in the ledger) — the number the serve warmup checks against
        ``--hbm_budget_bytes``. 0 on the CPU (no device-memory entries),
        so the budget gate is trivially satisfied there."""
        proj = self.hbm_projection()
        if models is not None:
            proj = {m: p for m, p in proj.items() if m in models}
        return sum(p["resident"] for p in proj.values())

    # -- persistence (the costmodel pattern) ------------------------------

    def save(self, path: Optional[str] = None) -> Optional[str]:
        """Atomic rewrite: snapshot under the lock, write outside it."""
        path = path or self.path
        if path is None:
            return None
        with self._lock:
            doc = {"version": SCHEMA_VERSION, "entries": dict(self._entries)}
        from video_features_tpu_torch.io.sink import atomic_write_json

        return atomic_write_json(path, doc)

    def _load(self, path: str) -> None:
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return  # no/torn prior ledger: start cold
        if not isinstance(doc, dict) or doc.get("version") != SCHEMA_VERSION:
            return
        entries = doc.get("entries")
        if not isinstance(entries, dict):
            return
        with self._lock:
            for key, e in entries.items():
                if isinstance(e, dict) and "model" in e and "family" in e:
                    self._entries[str(key)] = e


def load_ledger(path: str) -> Optional[CostLedger]:
    """Read-side open for the CLI: None when the file is missing (the
    rc-2 contract lives in telemetry/__main__.py); a torn file loads as an
    empty ledger, like every other warm-start artifact."""
    if not os.path.isfile(path):
        return None
    return CostLedger(path)


# -- the capture seam -----------------------------------------------------


def _array_leaves(tree: Any) -> List[Any]:
    """Array-ish leaves (anything with a shape and a dtype) of a nested
    args structure."""
    out: List[Any] = []
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif hasattr(node, "shape") and hasattr(node, "dtype"):
            out.append(node)
    return out


def _signature(args: tuple, kwargs: dict) -> tuple:
    return tuple(
        (tuple(leaf.shape), str(leaf.dtype))
        for leaf in _array_leaves((args, kwargs))
    )


def bucket_of(args: tuple, kwargs: dict = {}) -> str:  # noqa: B006 - read-only default
    """The ledger's spatial-bucket string for one call: the shape of the
    largest data leaf, ``"16x3x224x224"``-style. A leading mapping arg
    (the JAX package's ``fn(params, x)`` convention) is excluded so the
    bucket tracks the *input*, not the weights; ``"~"`` when no data leaf
    exists."""
    data_args = args[1:] if args and isinstance(args[0], dict) else args
    leaves = _array_leaves((data_args, kwargs))
    if not leaves:
        return "~"
    best = max(leaves, key=lambda a: (len(a.shape), _leaf_size(a)))
    return "x".join(str(int(d)) for d in best.shape) or "scalar"


def _leaf_size(a: Any) -> int:
    n = 1
    for d in a.shape:
        n *= int(d)
    return n


def _tensor_bytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in _array_leaves(tree)
               if hasattr(t, "element_size"))


@contextlib.contextmanager
def kernel_flops(flops: float) -> Iterator[None]:
    """Around one hand-written kernel's call (its launch or its plain
    version): inside a capture on this thread, add the kernel's own
    operation count (FlopCounterMode cannot see a ctypes launch) and keep
    the plain version's torch operations out of the count. Outside a
    capture it does nothing."""
    cap = getattr(_TLS, "capture", None)
    if cap is None:
        yield
        return
    from torch.utils._python_dispatch import _disable_current_modes

    cap.kernel_flops += float(flops)
    with _disable_current_modes():
        yield


class _Capture:
    """One first call's measurement, opened by the pre-hook and closed by
    the post-hook on the same thread."""

    def __init__(self, module: Any, device: Any, weight_bytes: int,
                 args: tuple, kwargs: dict) -> None:
        import torch
        from torch.utils.flop_counter import FlopCounterMode

        self.module = module
        self.kernel_flops = 0.0
        self.argument_bytes = weight_bytes + _tensor_bytes((args, kwargs))
        self._cuda = device is not None and device.type == "cuda"
        self._device = device
        if self._cuda:
            self._before = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        self._flops = FlopCounterMode(display=False)
        self._flops.__enter__()

    def finish(self, output: Any) -> Optional[Dict[str, Any]]:
        """The call's facts, or None when it raised (``output`` None)."""
        self._flops.__exit__(None, None, None)
        if output is None:
            return None
        out_bytes = _tensor_bytes(output)
        memory = {"argument_bytes": int(self.argument_bytes), "output_bytes": int(out_bytes)}
        if self._cuda:
            import torch

            peak = torch.cuda.max_memory_allocated(self._device)
            memory["temp_bytes"] = int(max(peak - self._before - out_bytes, 0))
        return {"flops": float(self._flops.get_total_flops() + self.kernel_flops),
                "memory": memory}


def _state_modules(state: Any) -> Dict[str, Any]:
    """fn family -> module of a built state: an ``nn.Module`` is
    ``"forward"``, a dict gives one family per module-valued key."""
    import torch

    if isinstance(state, torch.nn.Module):
        return {"forward": state}
    if isinstance(state, dict):
        return {k: v for k, v in state.items() if isinstance(v, torch.nn.Module)}
    return {}


def _module_bytes(modules: Sequence[Any]) -> int:
    seen, total = set(), 0
    for m in modules:
        for t in (*m.parameters(), *m.buffers()):
            if id(t) not in seen:
                seen.add(id(t))
                total += t.numel() * t.element_size()
    return total


def instrument_state(
    state: Any,
    ledger: CostLedger,
    model: str,
    sharding: str = "queue",
    device: Any = None,
) -> Any:
    """Hook an extractor's built state so that every module's first call
    per argument signature records its facts into ``ledger`` (module
    docstring). Returns ``state`` itself: the hooks leave attribute access,
    ``state_dict`` keys and execution as they are. A state with no module
    passes through untouched."""
    families = _state_modules(state)
    if not families:
        return state
    import torch

    if device is None:
        first = next(iter(families.values()))
        device = next((p.device for p in first.parameters()), torch.device("cpu"))
    device = torch.device(device)
    weight_bytes = _module_bytes(list(families.values()))
    for family, module in families.items():
        _attach(module, ledger, model, family, sharding, device, weight_bytes)
    return state


def _attach(module: Any, ledger: CostLedger, model: str, family: str, sharding: str,
            device: Any, weight_bytes: int) -> None:
    seen: set = set()
    lock = threading.Lock()

    def pre(mod, args, kwargs):
        if getattr(_TLS, "capture", None) is not None:
            return None  # nested in another capture: that one covers it
        try:
            sig = _signature(args, kwargs)
        except Exception:  # noqa: BLE001 - signature failure: skip capture
            return None
        with lock:
            if sig in seen:
                return None
            seen.add(sig)
        # another thread's capture in flight: try again at a later call
        # rather than block a dispatch on it
        if not _CAPTURE_LOCK.acquire(blocking=False):
            with lock:
                seen.discard(sig)
            return None
        try:
            _TLS.capture = _Capture(mod, device, weight_bytes, args, kwargs)
        except Exception:  # noqa: BLE001 - observability must never kill dispatch
            _TLS.capture = None
            _CAPTURE_LOCK.release()
        return None

    def post(mod, args, kwargs, output):
        cap = getattr(_TLS, "capture", None)
        if cap is None or cap.module is not mod:
            return None
        _TLS.capture = None
        try:
            analysis = cap.finish(output)
            if analysis:
                ledger.record(model, family, bucket_of(args, kwargs), sharding,
                              device.type, analysis)
        except Exception:  # noqa: BLE001 - observability must never kill dispatch
            pass
        finally:
            _CAPTURE_LOCK.release()
        return None

    module.register_forward_pre_hook(pre, with_kwargs=True)
    module.register_forward_hook(post, with_kwargs=True, always_call=True)


# -- live device-memory gauges -------------------------------------------


class DeviceMemorySampler:
    """Polls ``torch.cuda.memory_stats`` and ``torch.cuda.mem_get_info``
    of each CUDA device into a MetricsRegistry as ``device_mem_bytes.
    cuda:<i>|<kind>`` gauges (``in_use``: allocated; ``limit``: the card's
    total; ``peak``: peak allocated; ``reserved``: held by the caching
    allocator) plus ``device_mem_headroom_bytes``, the minimum across
    devices of ``free + (reserved - allocated)``: what the caching
    allocator can still hand out, from the card's free memory or from its
    own cache.
    The JAX package's headroom is XLA's ``bytes_limit - bytes_in_use``,
    the room left in a pool preallocated up front; PyTorch's allocator
    grows on demand, so the card's free memory is the limit and the
    allocator's cached blocks are room too.

    A CPU device sets **no** gauge — the exposition simply has no
    ``vft_device_mem_*`` families there. ``sample_once()`` is public so
    tests and the warmup path can poll synchronously; ``start``/``stop``
    run it on a daemon thread."""

    def __init__(
        self,
        metrics: Any,
        interval_s: float = 10.0,
        devices: Optional[Sequence[Any]] = None,
    ) -> None:
        self.metrics = metrics
        self.interval_s = max(float(interval_s), 0.5)
        self._devices = list(devices) if devices is not None else None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _resolve_devices(self) -> List[Any]:
        import torch

        if self._devices is not None:
            return [torch.device(d) for d in self._devices]
        if not torch.cuda.is_available():
            return []
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]

    def sample_once(self) -> int:
        """One poll; returns the number of devices whose stats were
        recorded (0 on the CPU)."""
        import torch

        recorded = 0
        headroom: Optional[int] = None
        for dev in self._resolve_devices():
            if dev.type != "cuda":
                continue
            index = dev.index if dev.index is not None else torch.cuda.current_device()
            try:
                stats = torch.cuda.memory_stats(index)
                free, total = torch.cuda.mem_get_info(index)
            except Exception:  # noqa: BLE001 - no stats: no gauges
                continue
            # the allocator reports no key before its first allocation,
            # which is zero bytes allocated and reserved
            allocated = int(stats.get("allocated_bytes.all.current", 0))
            reserved = int(stats.get("reserved_bytes.all.current", 0))
            kinds = (
                ("in_use", allocated),
                ("limit", int(total)),
                ("peak", int(stats.get("allocated_bytes.all.peak", 0))),
                ("reserved", reserved),
            )
            for kind, v in kinds:
                self.metrics.set_gauge(f"device_mem_bytes.cuda:{index}{KEY_SEP}{kind}", float(v))
            recorded += 1
            room = int(free) + reserved - allocated
            headroom = room if headroom is None else min(headroom, room)
        if headroom is not None:
            self.metrics.set_gauge("device_mem_headroom_bytes", float(headroom))
        return recorded

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="device-mem-sampler", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        # first sample immediately (a daemon's /metrics should show
        # device gauges before the first interval elapses), then poll
        while True:
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 - sampling must never kill serving
                pass
            if self._stop.wait(self.interval_s):
                return

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None


def format_bytes(n: float) -> str:
    """Human bytes for warmup prints and the CLI table (binary units)."""
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} TiB"
