"""Mesh mode's pieces: the (data, model) device grid, batch placement,
the replicated weights and row splits, the explicit collectives, and
CLIP's tensor-parallel cut.

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

Under a launcher (several processes in one ``torch.distributed`` group,
``parallel/distributed.py``) the grid is global: its data rows are every
process's rows in rank order, ``Mesh.owners`` names each row's process,
and a process holds devices, parts and weights only for its own rows
(``Mesh.local_rows``). Every process walks the same videos in the same
order, so each collective below is joined by all of them: ``gather_rows``
puts every row's output on every process (the counterpart of the JAX
package's replicated mesh outputs, ``_mesh_out_sharding``),
``temporal_halo`` takes a neighbour's frames from the process that
holds it, and ``ring_permute`` hops between processes by paired sends
and receives. A process whose rows sit out still joins each of them,
with nothing to give. The model axis stays inside a process.

Axes, as in the JAX package:

- ``data``: the frame batch of one forward splits into contiguous row
  blocks, one per data row of the grid (``split_rows``, uneven; rows
  left without items sit out): CLIP's batch, and the families whose
  weights ``replicate`` copies onto each row (ResNet, R(2+1)D, VGGish
  and the fused flow windows). The flow nets and I3D split a frame axis
  instead (sequence parallelism): ``halo_split`` gives each row its
  frames plus its right neighbour's first, so its pairs are its own, and
  ``temporal_halo`` lends each of I3D's time blocks the frames its
  temporal kernels reach across the block's edges. Under
  ``--mesh_context`` CLIP's batch is replicated on every row
  (``place_batch``) and its tokens shard inside attention;
- ``model``: Megatron tensor parallelism inside each transformer block
  (``clip_vit_shard_state``): the q/k/v projections and the MLP's
  ``c_fc`` split by output rows (column parallel), ``attn.out_proj`` and
  ``mlp.c_proj`` by input columns (row parallel); their partial products
  are summed over the model axis (``all_reduce_sum``) before the bias.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from video_features_tpu_torch.extract import ingest
from video_features_tpu_torch.parallel import distributed

AXES = ("data", "model")


class Mesh:
    """A ``(data, model)`` grid of ``torch.device``s; repeats allowed.
    ``owners[i]`` is the rank of the process that drives data row ``i``
    (all this process's, ``rank``, outside a launched group); the grid
    holds a device only in this process's rows, None in the others."""

    def __init__(self, devices: np.ndarray, owners: Optional[Sequence[int]] = None,
                 rank: int = 0) -> None:
        if devices.ndim != 2:
            raise ValueError(f"a mesh is a 2-d grid of devices, got shape {devices.shape}")
        self.devices = devices
        self.shape = {"data": int(devices.shape[0]), "model": int(devices.shape[1])}
        self.owners = list(owners) if owners is not None else [rank] * self.shape["data"]
        self.rank = rank
        self.local_rows = [i for i, o in enumerate(self.owners) if o == rank]
        # rows on several processes: the collectives cross processes
        self.multiprocess = len(set(self.owners)) > 1

    @property
    def first(self) -> torch.device:
        """This process's first device (its first row's first cell):
        where a gathered output lands."""
        return self.devices[self.local_rows[0], 0]

    def axis_devices(self, axis_name: str, index: int = 0) -> List[Optional[torch.device]]:
        """The devices along ``axis_name`` at ``index`` of the other axis
        (None in another process's rows)."""
        grid = self.devices if axis_name == "data" else self.devices.T
        return list(grid[:, index])

    def running(self, sizes: Optional[Sequence[int]]) -> List[int]:
        """This process's rows that run for a split of row ``sizes`` (all
        of them for a replicated batch, ``sizes`` None), in order: the
        rows of the parts ``split_rows``/``halo_split`` placed."""
        return [r for r in self.local_rows if sizes is None or sizes[r]]

    def __repr__(self) -> str:
        cells = " ".join(str(d) if d is not None else f"rank{self.owners[i]}"
                         for i, row in enumerate(self.devices) for d in row)
        return f"mesh(data={self.shape['data']}, model={self.shape['model']}: {cells})"


def make_mesh(
    devices: Optional[Sequence[torch.device]] = None,
    data: Optional[int] = None,
    model: int = 1,
) -> Mesh:
    """A (data, model) mesh over ``devices`` (default: every visible CUDA
    device), in row-major order. In a launched process group
    (``distributed.multihost``) ``devices`` are this process's and the
    mesh is global: each process's ``len(devices) / model`` rows, in rank
    order (one gather of the row counts); ``model`` must divide the local
    device count, as the model axis stays inside a process."""
    if devices is None:
        from video_features_tpu_torch.parallel.devices import resolve_devices

        devices = resolve_devices()
    n = len(devices)
    if distributed.multihost():
        return _global_mesh(devices, data, model)
    if data is None:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs more than {n} devices")
    arr = np.empty(data * model, dtype=object)
    arr[:] = list(devices[: data * model])
    return Mesh(arr.reshape(data, model))


def _global_mesh(devices: Sequence[torch.device], data: Optional[int], model: int) -> Mesh:
    n, rank = len(devices), distributed.process_index()
    if n % model:
        raise ValueError(
            f"--mesh_model {model} must divide this process's {n} device(s): the model axis "
            f"stays inside a process (rank {rank} of {distributed.process_count()})")
    counts = distributed.all_gather_int(n // model)
    if data is not None and data != sum(counts):
        raise ValueError(f"mesh data={data}, but the processes hold {sum(counts)} rows "
                         f"({counts} by rank)")
    owners = [r for r, c in enumerate(counts) for _ in range(c)]
    arr = np.full((len(owners), model), None, dtype=object)
    local = np.empty(n, dtype=object)
    local[:] = list(devices)
    first = sum(counts[:rank])
    arr[first:first + counts[rank]] = local.reshape(-1, model)
    return Mesh(arr, owners, rank)


def is_mesh(device) -> bool:
    return isinstance(device, Mesh)


# --- batches --------------------------------------------------------------


class Rows(NamedTuple):
    """A host batch on the mesh's data rows: the parts of this process's
    rows that run (``Mesh.running``), and every row's size (None: the
    batch is replicated on every row)."""

    parts: List
    sizes: Optional[List[int]]


def place_batch(x, mesh: Mesh) -> Rows:
    """One host batch replicated on each of this process's data rows, on
    the row's first device (``ingest.place_batch``: pinned, non-blocking):
    ``--mesh_context``, where the tokens shard inside attention instead.
    The data split is ``split_rows``."""
    rows = mesh.axis_devices("data")
    return Rows([ingest.place_batch(x, rows[r]) for r in mesh.local_rows], None)


def row_sizes(n: int, data: int, block: int = 1) -> List[int]:
    """``n`` items over ``data`` rows in contiguous blocks: each row takes
    ``ceil(n / data)`` rounded up to a multiple of ``block``, until the
    items run out; the last row that gets any may be ragged, and the rows
    after it get 0."""
    per = -(-max(-(-n // data), 1) // block) * block
    return [max(min(per, n - r * per), 0) for r in range(data)]


def split_rows(x, mesh: Mesh, block: int = 1) -> Rows:
    """Axis 0 of one host batch in contiguous blocks, one a data row
    (``row_sizes``: every block but the last a multiple of ``block``),
    this process's placed on their row's first device
    (``ingest.place_batch``). A row left without items sits out: it gets
    no tensor and so no launch. Returns (the placed blocks of this
    process's rows that run, every row's size), the sizes being what
    ``gather_rows`` checks. Counterpart of the JAX package's
    ``pad_batch_for`` + ``place_batch``, without the zero rows: a list of
    tensors may be uneven."""
    sizes = row_sizes(x.shape[0], mesh.shape["data"], block)
    return Rows(_place_rows(x, mesh, sizes, halo=0), sizes)


def halo_split(frames, mesh: Mesh, block: int = 1) -> Rows:
    """The flow nets' neighbour exchange: the ``T - 1`` consecutive pairs
    of ``T`` host frames in ``row_sizes`` blocks, and data row ``r`` gets
    the frames of its block plus the first frame of the next block, so
    the pairs it forms are exactly the global pairs of its block (the last
    row's block ends at the last frame: no extra). This process's parts
    are placed on their row's first device; a row without pairs sits out.
    Returns (parts, every row's pair count).

    Counterpart of the JAX package's sharded frame axis, where the
    models' consecutive-pair views become GSPMD halo exchanges
    (``models/common/flow_extract.py``). Here the one frame is exchanged
    at the input (every process holds the host frames), so the models run
    unchanged on each row; the cost is that each row boundary encodes its
    frame twice (once on each side). Moving the exchange to the feature
    maps would save that."""
    sizes = row_sizes(frames.shape[0] - 1, mesh.shape["data"], block)
    return Rows(_place_rows(frames, mesh, sizes, halo=1), sizes)


def _place_rows(x, mesh: Mesh, sizes: Sequence[int], halo: int) -> List[torch.Tensor]:
    """This process's row ``r``'s block of ``sizes[r]`` entries of ``x``
    and the next ``halo`` after it, on the row's first device; rows of
    size 0 get none."""
    parts, off = [], 0
    for r, (size, dev) in enumerate(zip(sizes, mesh.axis_devices("data"))):
        if size and mesh.owners[r] == mesh.rank:
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
                  ends: bool = True, mesh: Optional[Mesh] = None) -> List[torch.Tensor]:
    """Sequence parallelism's halo exchange for a temporal kernel: each
    part (a contiguous time block of an NCDHW tensor, on its device) gets
    the last ``lo`` frames of the blocks before it prepended and the first
    ``hi`` of the blocks after it appended (a short neighbour lends what
    it has and its own neighbour the rest). Where the global sequence
    ends, ``ends`` fills the missing frames with zeros, which is the
    TF-SAME zero padding the unsharded op applies with ``F.pad``; without
    ``ends`` nothing is added there (a valid, unpadded kernel). Counterpart
    of the halos GSPMD inserts for the JAX package's sharded time axis.

    On a ``mesh`` ``parts`` is the global list of blocks (``stand_ins``),
    another process's block standing in as a tensor on the ``meta``
    device of its shape: every process gives its own blocks' first ``hi``
    and last ``lo`` frames to one gather of edges
    (``distributed.all_gather_rows``, no collective on one process),
    ``_edge`` runs over the list with each remote block replaced by its
    edges, and a stand-in comes back as a stand-in of its padded shape."""
    dim = 2
    lefts = rights = parts
    if mesh is not None:
        lefts, rights = _remote_edges(parts, lo, hi, mesh)
    out = []
    for i, p in enumerate(parts):
        if p.is_meta:
            got_lo = min(lo, sum(q.shape[dim] for q in parts[:i]))
            got_hi = min(hi, sum(q.shape[dim] for q in parts[i + 1:]))
            t = p.shape[dim] + (lo + hi if ends else got_lo + got_hi)
            out.append(p.new_empty(p.shape[:dim] + (t,) + p.shape[dim + 1:]))
            continue
        left = _edge(lefts[:i], lo, dim, last=True, device=p.device) if lo else []
        right = _edge(rights[i + 1:], hi, dim, last=False, device=p.device) if hi else []
        got_lo = sum(t.shape[dim] for t in left)
        got_hi = sum(t.shape[dim] for t in right)
        if ends and got_lo < lo:
            left.insert(0, p.new_zeros(p.shape[:dim] + (lo - got_lo,) + p.shape[dim + 1:]))
        if ends and got_hi < hi:
            right.append(p.new_zeros(p.shape[:dim] + (hi - got_hi,) + p.shape[dim + 1:]))
        out.append(torch.cat([*left, p, *right], dim=dim) if left or right else p)
    return out


def _remote_edges(parts: Sequence[torch.Tensor], lo: int, hi: int,
                  mesh: Mesh) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """``parts`` with each stand-in replaced by its block's last
    ``min(lo, t)`` frames (for the blocks after it) and its first
    ``min(hi, t)`` (for the blocks before it), gathered from the processes
    that hold them: what ``_edge`` reads of a block is no more than that."""
    dim = 2
    mine = {i: (p.narrow(dim, p.shape[dim] - min(lo, p.shape[dim]), min(lo, p.shape[dim])),
                p.narrow(dim, 0, min(hi, p.shape[dim])))
            for i, p in enumerate(parts) if not p.is_meta}
    every = distributed.all_gather_rows(mine, len(parts), mesh.first)
    lefts = [p if not p.is_meta else every[i][0] for i, p in enumerate(parts)]
    rights = [p if not p.is_meta else every[i][1] for i, p in enumerate(parts)]
    return lefts, rights


def stand_ins(parts: Sequence[torch.Tensor], mesh: Mesh, sizes: Sequence[int],
              block_shape: Callable[[int], Tuple[int, ...]]) -> List[torch.Tensor]:
    """The parts of every row that runs (``sizes[r]`` > 0), in row order:
    this process's as they are, another process's as an empty tensor on
    the ``meta`` device of ``block_shape(sizes[r])``, for a forward that
    walks the global list of blocks (``I3D.forward_sharded``). Every
    process knows every row's size, so no shape is exchanged. On one
    process: ``parts``."""
    mine = dict(zip(mesh.running(sizes), parts))
    return [mine[r] if r in mine else torch.empty(block_shape(size), device="meta")
            for r, size in enumerate(sizes) if size]


class Replicas(nn.Module):
    """One module's copies over a mesh's data rows (``replicate``):
    ``rows[r]`` is the copy on row ``r``'s device, the same object for
    rows that share a device, None for another process's row. Calling it
    runs this process's parts through their rows' copies; the module's
    device (``device_of``) is this process's first."""

    def __init__(self, mesh: Mesh, copies: Dict[torch.device, nn.Module]) -> None:
        super().__init__()
        self.mesh = mesh
        self.copies = nn.ModuleList(copies.values())
        self.rows = [copies.get(d) for d in mesh.axis_devices("data")]
        self._stand_in: List[nn.Module] = []

    @property
    def device(self) -> torch.device:
        return self.mesh.first

    def forward(self, parts: Sequence[torch.Tensor]) -> list:
        """Part ``k`` through the copy of this process's ``k``-th row (the
        parts of a split: ``Mesh.running``; rows past them sit out)."""
        return [self.rows[r](p) for r, p in zip(self.mesh.local_rows, parts)]

    def run(self, x, prepare: Optional[Callable] = None):
        """One host batch, data parallel: ``split_rows``, each part
        through ``prepare`` (on its device) and its row's copy, then the
        outputs (a tensor, or each tensor of a tuple) gathered onto this
        process's first device (``gather_rows``: on every process, in row
        order)."""
        parts, sizes = split_rows(x, self.mesh)
        if prepare is not None:
            parts = [prepare(p) for p in parts]
        return gather_rows(self(parts), self.device, sizes, self.mesh)

    def row_modules(self, sizes: Sequence[int]) -> List[nn.Module]:
        """The copies of every row that runs (``sizes[r]`` > 0), in row
        order, another process's row standing in as a copy on the
        ``meta`` device (made once): shapes through the module, no data
        and no launch. The modules for ``stand_ins``'s parts."""
        if any(size and m is None for m, size in zip(self.rows, sizes)) and not self._stand_in:
            self._stand_in.append(copy.deepcopy(self.copies[0]).to("meta"))
        return [m if m is not None else self._stand_in[0]
                for m, size in zip(self.rows, sizes) if size]


def replicate(build: Callable[[torch.device], nn.Module], mesh: Mesh) -> Replicas:
    """Data parallelism's weights: ``build`` once on the first device of
    this process's rows, and a copy of that module (its ``state_dict``,
    dtypes and options as built) on each other distinct device of them,
    so a grid of one repeated card holds one copy. Counterpart of the JAX
    package's ``place_params`` with no specs, which replicates."""
    distinct = [d for d in dict.fromkeys(mesh.axis_devices("data")) if d is not None]
    first = build(distinct[0])
    copies = {distinct[0]: first}
    for dev in distinct[1:]:
        copies[dev] = copy.deepcopy(first).to(dev)
    return Replicas(mesh, copies)


def place_raw_payload(payload, mesh: Mesh, place_taps: Callable = ingest.place_taps) -> Rows:
    """One ``--preprocess device`` payload, the ``(frames, (wt_y, idx_y),
    (wt_x, idx_x))`` triple, onto the mesh's data rows: the uint8 frame
    axis split over the rows (``split_rows``), the resample taps
    replicated on each (kilobytes next to the frames). Returns the rows'
    ``(frames_i, taps_i)`` pairs and sizes; ``place_taps(taps, device)``
    lets the caller reuse taps it has placed before."""
    frames, wy, wx = payload
    parts, sizes = split_rows(frames, mesh)
    return Rows([(x, place_taps((wy, wx), x.device)) for x in parts], sizes)


# --- collectives ------------------------------------------------------------


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t.to(device, non_blocking=True)


def _local(parts: Sequence[torch.Tensor], what: str) -> None:
    if any(p is None or p.is_meta for p in parts):
        raise ValueError(f"{what} runs over the model axis, inside one process; a part "
                         "held by another process reached it")


def all_reduce_sum(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each part's device gets the sum of every part, added in the parts'
    order on every device, so all copies of the sum are equal. The model
    axis's sum: every part is this process's."""
    _local(parts, "all_reduce_sum")
    out = []
    for dst in parts:
        acc = _to(parts[0], dst.device)
        for p in parts[1:]:
            acc = acc + _to(p, dst.device)
        out.append(acc)
    return out


def all_gather(parts: Sequence[torch.Tensor], dim: int) -> List[torch.Tensor]:
    """Each part's device gets every part, concatenated along ``dim``. The
    model axis's gather: every part is this process's."""
    _local(parts, "all_gather")
    return [torch.cat([_to(p, dst.device) for p in parts], dim=dim) for dst in parts]


def all_gather_data(parts: Sequence[torch.Tensor], dim: int,
                    mesh: Optional[Mesh] = None) -> List[torch.Tensor]:
    """``all_gather`` over the data axis: on a ``mesh`` ``parts`` are this
    process's rows of it (``Mesh.local_rows``), and every row's part comes
    from the process that holds it."""
    if mesh is None:
        return all_gather(parts, dim)
    every = distributed.all_gather_rows(dict(zip(mesh.local_rows, ((p,) for p in parts))),
                                        mesh.shape["data"], mesh.first)
    return [torch.cat([_to(e[0], dst.device) for e in every], dim=dim) for dst in parts]


def gather(parts: Sequence[torch.Tensor], device: torch.device, dim: int = 0) -> torch.Tensor:
    """Every part onto ``device``, concatenated along ``dim``."""
    return torch.cat([_to(p, device) for p in parts], dim=dim)


def _gather_entries(entries: Dict[int, tuple], n: int, device: torch.device,
                    mesh: Optional[Mesh]) -> tuple:
    """The entries of an ``n``-long list (each a tuple of tensors; on a
    ``mesh``, this process's, every other from the process that holds it)
    onto ``device``, each column concatenated along axis 0 in index
    order: a tuple of tensors, or the one tensor of one column."""
    every = (distributed.all_gather_rows(entries, n, device) if mesh is not None
             else [entries.get(i) for i in range(n)])
    out = tuple(gather(list(column), device) for column in zip(*(e for e in every if e)))
    return out[0] if len(out) == 1 else out


def gather_rows(parts: Sequence, device: torch.device, sizes: Sequence[int],
                mesh: Optional[Mesh] = None):
    """The rows' outputs back onto ``device`` in row order, before the
    copy to the host (``gather`` along axis 0): ``parts`` are those of the
    rows that ran (``split_rows``, ``halo_split``; on a ``mesh`` this
    process's, ``Mesh.running``), each a tensor with that row's size along
    axis 0, or a tuple of such tensors (then a tuple of the gathered
    tensors is returned). On a mesh of several processes every row's
    output is gathered from the process that holds it
    (``distributed.all_gather_rows``), so each process gets the same full
    result, the counterpart of the JAX package's replicated mesh
    outputs."""
    tupled = [p if isinstance(p, tuple) else (p,) for p in parts]
    mine = (mesh.running(sizes) if mesh is not None
            else [r for r, s in enumerate(sizes) if s])
    if [t[0].shape[0] for t in tupled] != [sizes[r] for r in mine]:
        raise ValueError(f"gather_rows: parts of {[t[0].shape[0] for t in tupled]} rows for row "
                         f"sizes {list(sizes)}")
    return _gather_entries(dict(zip(mine, tupled)), len(sizes), device, mesh)


def gather_blocks(blocks: Sequence, device: torch.device, mesh: Optional[Mesh] = None):
    """The blocks of a global list (``stand_ins``: another process's block
    a ``meta`` tensor), each a tensor or a tuple of tensors, onto
    ``device`` concatenated along axis 0 in block order, as
    ``gather_rows``; on a ``mesh`` each remote block from the process that
    holds it."""
    tupled = [b if isinstance(b, tuple) else (b,) for b in blocks]
    mine = {i: t for i, t in enumerate(tupled) if not t[0].is_meta}
    return _gather_entries(mine, len(tupled), device, mesh)


def ring_permute(parts: Sequence[torch.Tensor], devices: Sequence[torch.device],
                 mesh: Optional[Mesh] = None) -> List[torch.Tensor]:
    """One hop around the ring: part ``i`` moves to ``devices[(i + 1) %
    n]``. On a ``mesh`` the ring is the mesh's data rows and ``parts`` (on
    ``devices``) are this process's rows of it (``Mesh.local_rows``): a
    hop between two of its rows is a copy, a hop to another process's row
    a send and one from it a receive, every one of them posted before any
    is waited for (``distributed.exchange``; nothing to exchange on one
    process)."""
    if mesh is None:
        n = len(parts)
        out: List[Optional[torch.Tensor]] = [None] * n
        for i, p in enumerate(parts):
            out[(i + 1) % n] = _to(p, devices[(i + 1) % n])
        return out
    n, owners, me, rows = mesh.shape["data"], mesh.owners, mesh.rank, mesh.local_rows
    at = {r: k for k, r in enumerate(rows)}
    out = [None] * len(parts)
    sends, recvs = [], []
    for k, r in enumerate(rows):
        nxt, prv = (r + 1) % n, (r - 1) % n
        if owners[nxt] == me:
            out[at[nxt]] = _to(parts[k], devices[at[nxt]])
        else:
            sends.append((parts[k], owners[nxt]))
        if owners[prv] != me:
            out[k] = torch.empty_like(parts[k])
            recvs.append((out[k], owners[prv]))
    distributed.exchange(sends, recvs)
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
