"""Mesh mode's pieces: the (data, model) device grid, batch placement,
the explicit collectives, and CLIP's tensor-parallel cut.

Counterpart of ``video_features_tpu/parallel/sharding.py``. The JAX
package hands a ``jax.sharding.Mesh`` and partition specs to GSPMD,
which places the shards and inserts the collectives. Here one host
thread drives every device of the grid: a sharded tensor is a list of
per-device ``torch.Tensor``s, and each collective is a function over
such a list, built from ``.to(device, non_blocking=True)`` copies and
adds on the destination's current stream. CUDA launches are
asynchronous, so the work of distinct cards overlaps while the thread
issues it in order. A copy to the device a tensor is already on is no
copy at all, so a grid of one repeated card (``--device_ids 0 0``) runs
every shard, sum and ring hop of the program with nothing crossing
between cards.

Axes, as in the JAX package:

- ``data``: the frame batch of one forward splits into row blocks, one
  per data row of the grid (``place_batch``);
- ``model``: Megatron tensor parallelism inside each transformer block
  (``clip_vit_shard_state``): the q/k/v projections and the MLP's
  ``c_fc`` split by output rows (column parallel), ``attn.out_proj`` and
  ``mlp.c_proj`` by input columns (row parallel); their partial products
  are summed over the model axis (``all_reduce_sum``) before the bias.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from video_features_tpu_torch.extract import ingest

AXES = ("data", "model")


class Mesh:
    """A ``(data, model)`` grid of ``torch.device``s; repeats allowed."""

    def __init__(self, devices: np.ndarray) -> None:
        if devices.ndim != 2:
            raise ValueError(f"a mesh is a 2-d grid of devices, got shape {devices.shape}")
        self.devices = devices
        self.shape = {"data": int(devices.shape[0]), "model": int(devices.shape[1])}

    def axis_devices(self, axis_name: str, index: int = 0) -> List[torch.device]:
        """The devices along ``axis_name`` at ``index`` of the other axis."""
        grid = self.devices if axis_name == "data" else self.devices.T
        return list(grid[:, index])

    def __repr__(self) -> str:
        cells = " ".join(str(d) for d in self.devices.flat)
        return f"mesh(data={self.shape['data']}, model={self.shape['model']}: {cells})"


def make_mesh(
    devices: Optional[Sequence[torch.device]] = None,
    data: Optional[int] = None,
    model: int = 1,
) -> Mesh:
    """A (data, model) mesh over ``devices`` (default: every visible CUDA
    device), in row-major order."""
    if devices is None:
        from video_features_tpu_torch.parallel.devices import resolve_devices

        devices = resolve_devices()
    n = len(devices)
    if data is None:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs more than {n} devices")
    arr = np.empty(data * model, dtype=object)
    arr[:] = list(devices[: data * model])
    return Mesh(arr.reshape(data, model))


def is_mesh(device) -> bool:
    return isinstance(device, Mesh)


# --- batches --------------------------------------------------------------


def pad_batch_for(device, batch):
    """Round axis 0 of a host array or tensor up so the mesh's ``data``
    axis divides it (not a mesh: unchanged). The pad rows are zeros whose
    outputs the caller slices off by its own row count."""
    if not is_mesh(device):
        return batch
    n = batch.shape[0]
    to = -(-n // device.shape["data"]) * device.shape["data"]
    if to == n:
        return batch
    if isinstance(batch, torch.Tensor):
        pad = torch.zeros((to - n, *batch.shape[1:]), dtype=batch.dtype)
        return torch.cat([batch, pad])
    return np.pad(batch, [(0, to - n)] + [(0, 0)] * (batch.ndim - 1))


def place_batch(x, mesh: Mesh, spec: Optional[str] = "data") -> List[torch.Tensor]:
    """One host batch onto the mesh's data rows, one tensor per row on the
    row's first device (``ingest.place_batch``: pinned, non-blocking).
    ``spec="data"`` splits the rows (axis 0 must divide, see
    ``pad_batch_for``); ``None`` replicates the whole batch on every row
    (``--mesh_context``: the tokens shard inside attention instead)."""
    rows = mesh.axis_devices("data")
    if spec is None:
        return [ingest.place_batch(x, d) for d in rows]
    if spec != "data":
        raise ValueError(f"place_batch splits over 'data' or replicates, got {spec!r}")
    n = x.shape[0]
    if n % len(rows):
        raise ValueError(f"batch of {n} rows not divisible by mesh axis 'data' ({len(rows)})")
    step = n // len(rows)
    return [ingest.place_batch(x[i * step:(i + 1) * step], d) for i, d in enumerate(rows)]


def place_raw_payload(payload, mesh: Mesh, place_taps: Callable = ingest.place_taps):
    """One ``--preprocess device`` payload, the ``(frames, (wt_y, idx_y),
    (wt_x, idx_x))`` triple, onto the mesh's data rows: the uint8 frame
    axis padded to a multiple of ``data`` and split over the rows, the
    resample taps replicated on each row (kilobytes next to the frames).
    Returns ``[(frames_i, taps_i)]``, one pair per row; ``place_taps(taps,
    device)`` lets the caller reuse taps it has placed before."""
    frames, wy, wx = payload
    xs = place_batch(pad_batch_for(mesh, frames), mesh)
    return [(x, place_taps((wy, wx), d)) for x, d in zip(xs, mesh.axis_devices("data"))]


# --- collectives ------------------------------------------------------------


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t.to(device, non_blocking=True)


def all_reduce_sum(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each part's device gets the sum of every part, added in the parts'
    order on every device, so all copies of the sum are equal."""
    out = []
    for dst in parts:
        acc = _to(parts[0], dst.device)
        for p in parts[1:]:
            acc = acc + _to(p, dst.device)
        out.append(acc)
    return out


def all_gather(parts: Sequence[torch.Tensor], dim: int) -> List[torch.Tensor]:
    """Each part's device gets every part, concatenated along ``dim``."""
    return [torch.cat([_to(p, dst.device) for p in parts], dim=dim) for dst in parts]


def gather(parts: Sequence[torch.Tensor], device: torch.device, dim: int = 0) -> torch.Tensor:
    """Every part onto ``device``, concatenated along ``dim``."""
    return torch.cat([_to(p, device) for p in parts], dim=dim)


def ring_permute(parts: Sequence[torch.Tensor], devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """One hop around the ring: part ``i`` moves to ``devices[(i + 1) % n]``."""
    n = len(parts)
    out: List[Optional[torch.Tensor]] = [None] * n
    for i, p in enumerate(parts):
        out[(i + 1) % n] = _to(p, devices[(i + 1) % n])
    return out


# --- CLIP's tensor-parallel cut -----------------------------------------------

# column parallel: split by output rows, bias with them; the fused
# in_proj splits each of its q, k and v sections
_COLUMN = ("attn.in_proj_weight", "attn.in_proj_bias", "mlp.c_fc.weight", "mlp.c_fc.bias")
# row parallel: split by input columns; the bias is added once, after the sum
_ROW = ("attn.out_proj.weight", "mlp.c_proj.weight")


def _rows(t: torch.Tensor, model: int, index: int) -> torch.Tensor:
    step = t.shape[0] // model
    return t[index * step:(index + 1) * step]


def clip_vit_shard_state(state: Dict[str, torch.Tensor], model: int,
                         index: int) -> Dict[str, torch.Tensor]:
    """Shard ``index`` of ``model`` of a ``VisionTransformer`` state dict:
    the counterpart of the JAX package's ``clip_vit_param_specs``, which
    shards by Flax names. Column-parallel weights (``attn.in_proj_*``,
    ``mlp.c_fc.*``) keep their ``index``-th block of output rows; the fused
    ``in_proj`` keeps that block **of each of its q, k and v sections**
    (a contiguous third of the fused rows would give shard 0 all of q).
    Row-parallel weights (``attn.out_proj.weight``, ``mlp.c_proj.weight``)
    keep their ``index``-th block of input columns; their biases stay
    whole, to be added once after the sum over ``model``. Everything else
    (LayerNorms, embeddings, ``conv1``, ``proj``) is the same tensor in
    every shard."""
    out = {}
    for name, t in state.items():
        if name.endswith(_COLUMN):
            if "in_proj" in name:
                w = t.shape[0] // 3
                t = torch.cat([_rows(s, model, index) for s in t.split(w)])
            else:
                t = _rows(t, model, index)
            t = t.contiguous()
        elif name.endswith(_ROW):
            t = _rows(t.t(), model, index).t().contiguous()
        out[name] = t
    return out
