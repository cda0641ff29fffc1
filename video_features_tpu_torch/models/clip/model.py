"""CLIP visual transformer (``encode_image``) in PyTorch.

Counterpart of ``video_features_tpu/models/clip/model.py``. Parameter
names follow OpenAI's ``visual.*`` layout (``conv1``, fused
``attn.in_proj_weight``, ``transformer.resblocks.<i>``, ``mlp.c_fc``), so
an OpenAI checkpoint loads as it is. Pre-LN blocks, QuickGELU, LayerNorm
eps 1e-5 computed in fp32, class token + learned position embeddings,
``ln_post`` on the class token, then an fp32 ``@ proj`` to the embedding.

``--dtype bfloat16`` (``models/common/weights.py::cast_for_compute`` with
``exclude=FP32_PARAMS``): the patch conv, the residual stream, the q/k/v
and output projections and the MLP run in bf16, so the attention core
gets bf16 q/k/v; LayerNorm statistics, the softmax (inside every core),
``ln_post`` and the ``@ proj`` stay fp32. The output is fp32 either way.
"""

from __future__ import annotations

import copy
import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from video_features_tpu_torch.ops.attention import attention as fused_attention


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    embed_dim: int = 512
    image_size: int = 224
    eps: float = 1e-5

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


CLIP_VIT_B32 = CLIPVisionConfig(patch_size=32)
CLIP_VIT_B16 = CLIPVisionConfig(patch_size=16)

CONFIGS = {
    "CLIP-ViT-B/32": CLIP_VIT_B32,
    "CLIP-ViT-B/16": CLIP_VIT_B16,
    "CLIP4CLIP-ViT-B-32": CLIP_VIT_B32,
}

# the parameters a bf16 tower keeps fp32: the final projection
FP32_PARAMS = ("proj",)

AttnCore = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


class LayerNorm(nn.LayerNorm):
    """Statistics in fp32 whatever the activations' dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(x.dtype)


class QuickGELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(1.702 * x)


class Attention(nn.Module):
    """Multi-head self-attention with a swappable core: ``core(q, k, v)``
    on (N, H, L, hd) tensors, by default the fused core."""

    def __init__(self, width: int, heads: int, core: Optional[AttnCore] = None) -> None:
        super().__init__()
        self.heads = heads
        self.core = core or fused_attention
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (N, L, D)
        N, L, D = x.shape
        qkv = nn.functional.linear(x, self.in_proj_weight, self.in_proj_bias)
        # one copy gives contiguous (N, H, L, hd) heads for the core
        qkv = qkv.reshape(N, L, 3, self.heads, D // self.heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.contiguous().unbind(0)
        out = self.core(q, k, v)
        return self.out_proj(out.transpose(1, 2).reshape(N, L, D))


class Block(nn.Module):
    def __init__(self, width: int, heads: int, eps: float, core: Optional[AttnCore]) -> None:
        super().__init__()
        self.ln_1 = LayerNorm(width, eps=eps)
        self.attn = Attention(width, heads, core)
        self.ln_2 = LayerNorm(width, eps=eps)
        self.mlp = nn.Sequential(OrderedDict(
            c_fc=nn.Linear(width, 4 * width),
            gelu=QuickGELU(),
            c_proj=nn.Linear(4 * width, width),
        ))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, core: Optional[AttnCore]) -> None:
        super().__init__()
        self.resblocks = nn.ModuleList(
            Block(cfg.width, cfg.heads, cfg.eps, core) for _ in range(cfg.layers)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x)
        return x


class VisionTransformer(nn.Module):
    """``encode_image``: (N, 3, H, W) normalised fp32 -> (N, embed_dim) fp32."""

    def __init__(self, cfg: CLIPVisionConfig, core: Optional[AttnCore] = None) -> None:
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.conv1 = nn.Conv2d(3, w, cfg.patch_size, stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(torch.empty(cfg.grid * cfg.grid + 1, w))
        self.ln_pre = LayerNorm(w, eps=cfg.eps)
        self.transformer = Transformer(cfg, core)
        self.ln_post = LayerNorm(w, eps=cfg.eps)
        self.proj = nn.Parameter(torch.empty(w, cfg.embed_dim))

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """Images -> the (N, L, width) token stream entering the blocks."""
        x = self.conv1(x.to(self.conv1.weight.dtype))  # (N, width, grid, grid)
        x = x.flatten(2).transpose(1, 2)  # (N, grid*grid, width), row-major patches
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        return self.ln_pre(x)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The blocks' output -> the fp32 (N, embed_dim) embedding."""
        x = self.ln_post(x[:, 0].float())
        # the 512-d embedding is the user-facing contract: fp32 projection
        return x.float() @ self.proj.float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.transformer(self.embed(x)))


class _Shard(nn.Module):
    """One block's tensor-parallel shard on one device, its tensors
    registered (unsaved) so ``.parameters``/``.buffers`` walks count
    them; read as ``shard["in_w"]``."""

    def __init__(self, tensors: Dict[str, torch.Tensor]) -> None:
        super().__init__()
        for name, t in tensors.items():
            self.register_buffer(name, t, persistent=False)

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)


def _replica(model: VisionTransformer, device) -> VisionTransformer:
    """What every device of a mesh holds whole, as a copy on ``device``:
    the tower without its blocks (``embed``, ``head``) and each block's
    two LayerNorms (``norms[b]``). The blocks' weights are never copied."""
    empty = Transformer(dataclasses.replace(model.cfg, layers=0), None)
    rep = copy.deepcopy(model, {id(model.transformer): empty})
    rep.norms = nn.ModuleList(nn.ModuleList([copy.deepcopy(b.ln_1), copy.deepcopy(b.ln_2)])
                              for b in model.transformer.resblocks)
    return rep.to(device)


_GELU = QuickGELU()


class ShardedVisionTransformer(nn.Module):
    """``VisionTransformer``'s forward over a ``parallel.sharding.Mesh``
    (``--sharding mesh``), driven by one host thread.

    Each distinct device of the (data, model) grid holds the replicated
    parts once (``conv1``, the embeddings, the LayerNorms, ``proj``:
    ``_replica``), and cell ``(i, j)`` the ``j``-th tensor-parallel shard
    of every block (``sharding.clip_vit_shard_state``), so a device of a
    ``--mesh_model m`` mesh holds 1/m of the block weights per model
    shard it runs; the built model is not kept. Per block, each cell runs its
    column-parallel half (``in_proj`` rows of q, k and v; ``c_fc`` rows)
    on its heads, its row-parallel partial product (``out_proj`` and
    ``c_proj`` columns, no bias), the partials are summed over ``model``
    (``sharding.all_reduce_sum``) and the bias is added once. With one
    model shard the bias stays inside the matmul, as in the unsharded
    block. Where ``model`` does not divide the heads (a head split across
    shards), each cell gathers q/k/v over ``model`` and attends over the
    heads its columns touch.

    The attention core of a cell:

    - data parallel (the default): ``core`` on the cell's (N_i, H/m, L,
      hd) q/k/v: the fused core, or K1 under ``--attn flash``; the batch
      splits over ``data`` in uneven blocks (``place``:
      ``sharding.split_rows``; a row without images sits out) and the
      rows are gathered onto the first device at the end
      (``sharding.gather_rows``);
    - ``context`` (``--mesh_context``): the batch is replicated on every
      data row and each model shard runs a ring over its data devices
      (``parallel/ring_attention.py::context_parallel_attention``), the
      tokens sharded inside attention only; the first row's output is
      returned.

    In a mesh across launched processes a process holds and runs only
    its own data rows (``Mesh.local_rows``): the gather of the rows and
    the ring cross the processes, every process gets the whole output,
    and the model axis stays inside each process.
    """

    def __init__(self, model: VisionTransformer, mesh, core: Optional[AttnCore] = None,
                 context: bool = False) -> None:
        super().__init__()
        from video_features_tpu_torch.parallel.sharding import clip_vit_shard_state

        cfg = model.cfg
        m = mesh.shape["model"]
        if cfg.width % m:
            raise ValueError(f"--mesh_model {m} does not divide the CLIP width {cfg.width}")
        if context and cfg.heads % m:
            raise ValueError(f"head axis {cfg.heads} not divisible by mesh axis 'model' ({m})")
        self.cfg, self.mesh, self.context = cfg, mesh, context
        self.core = core or fused_attention
        grid = mesh.devices[mesh.local_rows]  # this process's rows
        # the first cell's replica comes first: the module's device is its
        # device, where the output lands
        distinct = list(dict.fromkeys(grid.flat))
        self.replicas = nn.ModuleList(_replica(model, dev) for dev in distinct)
        self._replicas = dict(zip(distinct, self.replicas))
        state = model.state_dict()
        names = (("in_w", "attn.in_proj_weight"), ("in_b", "attn.in_proj_bias"),
                 ("out_w", "attn.out_proj.weight"), ("out_b", "attn.out_proj.bias"),
                 ("fc_w", "mlp.c_fc.weight"), ("fc_b", "mlp.c_fc.bias"),
                 ("proj_w", "mlp.c_proj.weight"), ("proj_b", "mlp.c_proj.bias"))
        # (device, j) -> per block, the j-th shard; a copy even on the
        # model's own device, so no shard keeps a full tensor alive
        shards: Dict[tuple, nn.ModuleList] = {}
        for j in range(m):
            cut = clip_vit_shard_state(state, m, j)
            for dev in dict.fromkeys(grid[:, j]):
                shards[dev, j] = nn.ModuleList(
                    _Shard({k: cut[f"transformer.resblocks.{b}.{name}"].to(dev, copy=True)
                            for k, name in names}) for b in range(cfg.layers))
        self.shards = nn.ModuleList(shards.values())
        # data row -> its cells' shards (this process's rows)
        self._shards = {i: [shards[mesh.devices[i, j], j] for j in range(m)]
                        for i in mesh.local_rows}
        # cell j's columns of the width, and the heads they touch
        hd, cols = cfg.width // cfg.heads, cfg.width // m
        self._spans = [(j * cols // hd, -(-(j + 1) * cols // hd)) for j in range(m)]
        self._aligned = cfg.heads % m == 0

    def place(self, x):
        """A host batch onto the data rows: split in uneven blocks
        (``sharding.split_rows``), or under ``context`` replicated
        (``sharding.place_batch``). Returns ``sharding.Rows``: this
        process's parts and every row's size, what ``forward`` takes."""
        from video_features_tpu_torch.parallel.sharding import place_batch, split_rows

        if self.context:
            return place_batch(x, self.mesh)
        return split_rows(x, self.mesh)

    def forward(self, placed) -> torch.Tensor:
        """``place``'s ``(parts, sizes)`` -> the (rows, embed_dim) fp32
        embedding on this process's first device, every data row's rows
        in order (on every process of the mesh)."""
        from video_features_tpu_torch.parallel.sharding import gather_rows

        xs, sizes = placed
        rows = self.mesh.running(sizes)[:len(xs)]
        dev = self.mesh.devices
        grid = [[self._replicas[dev[i, j]].embed(x.to(dev[i, j], non_blocking=True))
                 for j in range(dev.shape[1])] for i, x in zip(rows, xs)]
        for b in range(self.cfg.layers):
            grid = self._attention(b, rows, grid)
            grid = self._mlp(b, rows, grid)
        outs = [self._replicas[dev[i, 0]].head(row[0]) for i, row in zip(rows, grid)]
        if self.context:
            return outs[0]
        return gather_rows(outs, self.mesh.first, sizes, self.mesh)

    def _norms(self, i: int, j: int, b: int) -> nn.ModuleList:
        """Block ``b``'s ``ln_1``, ``ln_2`` on cell ``(i, j)``'s device."""
        return self._replicas[self.mesh.devices[i, j]].norms[b]

    def _reduce(self, b: int, rows, grid, partials, bias: str):
        """x + (the sum over ``model`` of the partials + the bias, once)."""
        from video_features_tpu_torch.parallel.sharding import all_reduce_sum

        if self.mesh.shape["model"] == 1:  # the bias went into the matmul
            return [[x + p for x, p in zip(xr, pr)] for xr, pr in zip(grid, partials)]
        out = []
        for i, xr, pr in zip(rows, grid, partials):
            sums = all_reduce_sum(pr)
            out.append([x + (s + self._shards[i][j][b][bias])
                        for j, (x, s) in enumerate(zip(xr, sums))])
        return out

    def _attention(self, b: int, rows, grid):
        from video_features_tpu_torch.parallel.ring_attention import context_parallel_attention
        from video_features_tpu_torch.parallel.sharding import all_gather

        m = self.mesh.shape["model"]
        hd = self.cfg.width // self.cfg.heads
        qkv = [[F.linear(self._norms(i, j, b)[0](x), self._shards[i][j][b]["in_w"],
                         self._shards[i][j][b]["in_b"]).reshape(*x.shape[:2], 3, -1)
                for j, x in enumerate(row)] for i, row in zip(rows, grid)]
        if not self._aligned:  # a head spans shards: every cell sees all of q, k, v
            qkv = [all_gather(row, dim=3) for row in qkv]

        def heads(t, j):
            h0, h1 = self._spans[j]
            if not self._aligned:
                t = t[..., h0 * hd:h1 * hd]
            # one copy gives contiguous (N, H, L, hd) heads for the core
            t = t.reshape(*t.shape[:3], h1 - h0, hd).permute(2, 0, 3, 1, 4)
            return t.contiguous().unbind(0)

        qkv = [[heads(t, j) for j, t in enumerate(row)] for row in qkv]
        if self.context:
            cols = [context_parallel_attention(*([q[j][s] for q in qkv] for s in range(3)),
                                               mesh=self.mesh)
                    for j in range(m)]
            outs = [[cols[j][k] for j in range(m)] for k in range(len(rows))]
        else:
            outs = [[self.core(*t) for t in row] for row in qkv]
        cols = self.cfg.width // m
        partials = []
        for i, row in zip(rows, outs):
            pr = []
            for j, o in enumerate(row):
                o = o.transpose(1, 2).reshape(o.shape[0], o.shape[2], -1)
                if not self._aligned:  # this cell's columns of its heads
                    c0 = j * cols - self._spans[j][0] * hd
                    o = o[..., c0:c0 + cols]
                s = self._shards[i][j][b]
                pr.append(F.linear(o, s["out_w"], s["out_b"] if m == 1 else None))
            partials.append(pr)
        return self._reduce(b, rows, grid, partials, "out_b")

    def _mlp(self, b: int, rows, grid):
        m = self.mesh.shape["model"]
        partials = []
        for i, row in zip(rows, grid):
            pr = []
            for j, x in enumerate(row):
                s = self._shards[i][j][b]
                f = _GELU(F.linear(self._norms(i, j, b)[1](x), s["fc_w"], s["fc_b"]))
                pr.append(F.linear(f, s["proj_w"], s["proj_b"] if m == 1 else None))
            partials.append(pr)
        return self._reduce(b, rows, grid, partials, "proj_b")


def init_weights(model: VisionTransformer, seed: int = 0) -> VisionTransformer:
    """Seeded random weights for ``--allow_random_init``: LeCun-normal
    matrices, zero biases, unit LayerNorms, normal(width^-1/2) embeddings
    and projection (the JAX package's initialisers; the two frameworks'
    generators give different numbers for one seed)."""
    gen = torch.Generator().manual_seed(seed)
    std_embed = model.cfg.width ** -0.5
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in ("class_embedding", "positional_embedding", "proj"):
                p.copy_(torch.randn(p.shape, generator=gen) * std_embed)
            elif p.dim() == 1:  # LayerNorm scales (the only 1-d weights) and biases
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            else:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=gen) * fan_in ** -0.5)
    return model
