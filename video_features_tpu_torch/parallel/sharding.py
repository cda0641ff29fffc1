"""Mesh mode's pieces: the (data, model) device grid, batch placement,
the replicated weights and row splits of the convolutional families, the
explicit collectives, and CLIP's tensor-parallel cut.

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
  per data row of the grid (``place_batch`` for CLIP; ``split_rows``,
  uneven, for the families whose weights ``replicate`` copies onto each
  row: ResNet, R(2+1)D, VGGish and the fused flow windows). The flow
  nets and I3D split a frame axis instead (sequence parallelism):
  ``halo_split`` gives each row its frames plus its right neighbour's
  first, so its pairs are its own, and ``temporal_halo`` lends each of
  I3D's time blocks the frames its temporal kernels reach across the
  block's edges;
- ``model``: Megatron tensor parallelism inside each transformer block
  (``clip_vit_shard_state``): the q/k/v projections and the MLP's
  ``c_fc`` split by output rows (column parallel), ``attn.out_proj`` and
  ``mlp.c_proj`` by input columns (row parallel); their partial products
  are summed over the model axis (``all_reduce_sum``) before the bias.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

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


def row_sizes(n: int, data: int, block: int = 1) -> List[int]:
    """``n`` items over ``data`` rows in contiguous blocks: each row takes
    ``ceil(n / data)`` rounded up to a multiple of ``block``, until the
    items run out; the last row that gets any may be ragged, and the rows
    after it get 0."""
    per = -(-max(-(-n // data), 1) // block) * block
    return [max(min(per, n - r * per), 0) for r in range(data)]


def split_rows(x, mesh: Mesh, block: int = 1) -> Tuple[List[torch.Tensor], List[int]]:
    """Axis 0 of one host batch in contiguous blocks, one a data row
    (``row_sizes``: every block but the last a multiple of ``block``),
    each placed on its row's first device (``ingest.place_batch``). A row
    left without items sits out: it gets no tensor and so no launch.
    Returns (the placed blocks of the rows that run, every row's size),
    the sizes being what ``gather_rows`` checks. Counterpart of the JAX
    package's ``pad_batch_for`` + ``place_batch``, without the zero rows:
    a list of tensors may be uneven."""
    sizes = row_sizes(x.shape[0], mesh.shape["data"], block)
    return _place_rows(x, mesh, sizes, halo=0), sizes


def halo_split(frames, mesh: Mesh, block: int = 1) -> Tuple[List[torch.Tensor], List[int]]:
    """The flow nets' neighbour exchange: the ``T - 1`` consecutive pairs
    of ``T`` host frames in ``row_sizes`` blocks, and data row ``r`` gets
    the frames of its block plus the first frame of the next block, so
    the pairs it forms are exactly the global pairs of its block (the last
    row's block ends at the last frame: no extra). Each part is placed on
    its row's first device; a row without pairs sits out. Returns (parts,
    every row's pair count).

    Counterpart of the JAX package's sharded frame axis, where the
    models' consecutive-pair views become GSPMD halo exchanges
    (``models/common/flow_extract.py``). Here the one frame is exchanged
    at the input, so the models run unchanged on each row; the cost is
    that each row boundary encodes its frame twice (once on each side).
    Moving the exchange to the feature maps would save that."""
    sizes = row_sizes(frames.shape[0] - 1, mesh.shape["data"], block)
    return _place_rows(frames, mesh, sizes, halo=1), sizes


def _place_rows(x, mesh: Mesh, sizes: Sequence[int], halo: int) -> List[torch.Tensor]:
    """Row ``r``'s block of ``sizes[r]`` entries of ``x`` and the next
    ``halo`` after it, on the row's first device; rows of size 0 get none."""
    parts, off = [], 0
    for size, dev in zip(sizes, mesh.axis_devices("data")):
        if size:
            parts.append(ingest.place_batch(x[off:off + size + halo], dev))
        off += size
    return parts


def _edge(parts: Sequence[torch.Tensor], count: int, dim: int, last: bool,
          device: torch.device) -> List[torch.Tensor]:
    """The first (``last=False``) or last ``count`` entries along ``dim``
    of the concatenation of ``parts`` (which may run over several parts),
    each piece copied to ``device``, in order."""
    pieces, need = [], count
    for p in (reversed(parts) if last else parts):
        if need <= 0:
            break
        take = min(need, p.shape[dim])
        if take:
            piece = p.narrow(dim, p.shape[dim] - take, take) if last else p.narrow(dim, 0, take)
            pieces.append(_to(piece, device))
            need -= take
    return pieces[::-1] if last else pieces


def temporal_halo(parts: Sequence[torch.Tensor], lo: int, hi: int,
                  ends: bool = True) -> List[torch.Tensor]:
    """Sequence parallelism's halo exchange for a temporal kernel: each
    part (a contiguous time block of an NCDHW tensor, on its device) gets
    the last ``lo`` frames of the blocks before it prepended and the first
    ``hi`` of the blocks after it appended (a short neighbour lends what
    it has and its own neighbour the rest). Where the global sequence
    ends, ``ends`` fills the missing frames with zeros, which is the
    TF-SAME zero padding the unsharded op applies with ``F.pad``; without
    ``ends`` nothing is added there (a valid, unpadded kernel). Counterpart
    of the halos GSPMD inserts for the JAX package's sharded time axis."""
    dim = 2
    out = []
    for i, p in enumerate(parts):
        left = _edge(parts[:i], lo, dim, last=True, device=p.device) if lo else []
        right = _edge(parts[i + 1:], hi, dim, last=False, device=p.device) if hi else []
        got_lo = sum(t.shape[dim] for t in left)
        got_hi = sum(t.shape[dim] for t in right)
        if ends and got_lo < lo:
            left.insert(0, p.new_zeros(p.shape[:dim] + (lo - got_lo,) + p.shape[dim + 1:]))
        if ends and got_hi < hi:
            right.append(p.new_zeros(p.shape[:dim] + (hi - got_hi,) + p.shape[dim + 1:]))
        out.append(torch.cat([*left, p, *right], dim=dim) if left or right else p)
    return out


class Replicas(nn.Module):
    """One module's copies over a mesh's data rows (``replicate``):
    ``rows[r]`` is the copy on row ``r``'s device, the same object for
    rows that share a device. Calling it runs part ``r`` of a list through
    ``rows[r]``; the module's device (``device_of``) is the first row's."""

    def __init__(self, mesh: Mesh, copies: Dict[torch.device, nn.Module]) -> None:
        super().__init__()
        self.mesh = mesh
        self.copies = nn.ModuleList(copies.values())
        self.rows = [copies[d] for d in mesh.axis_devices("data")]

    @property
    def device(self) -> torch.device:
        return self.mesh.axis_devices("data")[0]

    def forward(self, parts: Sequence[torch.Tensor]) -> list:
        """Part ``r`` through row ``r``'s copy (rows past the parts sit
        out)."""
        return [self.rows[r](p) for r, p in enumerate(parts)]

    def run(self, x, prepare: Optional[Callable] = None):
        """One host batch, data parallel: ``split_rows``, each part
        through ``prepare`` (on its device) and its row's copy, then the
        outputs (a tensor, or each tensor of a tuple) gathered onto the
        first device (``gather_rows``)."""
        parts, sizes = split_rows(x, self.mesh)
        if prepare is not None:
            parts = [prepare(p) for p in parts]
        outs = self(parts)
        if isinstance(outs[0], tuple):
            return tuple(gather_rows(list(o), self.device, sizes) for o in zip(*outs))
        return gather_rows(outs, self.device, sizes)


def replicate(build: Callable[[torch.device], nn.Module], mesh: Mesh) -> Replicas:
    """Data parallelism's weights: ``build`` once on the first device of
    the mesh's data axis, and a copy of that module (its ``state_dict``,
    dtypes and options as built) on each other distinct device of the
    axis, so a grid of one repeated card holds one copy. Counterpart of
    the JAX package's ``place_params`` with no specs, which replicates."""
    distinct = list(dict.fromkeys(mesh.axis_devices("data")))
    first = build(distinct[0])
    copies = {distinct[0]: first}
    for dev in distinct[1:]:
        copies[dev] = copy.deepcopy(first).to(dev)
    return Replicas(mesh, copies)


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


def gather_rows(parts: Sequence[torch.Tensor], device: torch.device,
                sizes: Sequence[int]) -> torch.Tensor:
    """The rows' outputs back onto ``device`` in row order, before the
    copy to the host (``gather`` along axis 0): ``parts`` are those of the
    rows that ran, which must be the rows of nonzero ``sizes``
    (``split_rows``, ``halo_split``), each with that many rows."""
    ran = [s for s in sizes if s]
    if [p.shape[0] for p in parts] != ran:
        raise ValueError(f"gather_rows: parts of {[p.shape[0] for p in parts]} rows for row "
                         f"sizes {list(sizes)}")
    return gather(parts, device)


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
