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

import dataclasses
from collections import OrderedDict
from typing import Callable, Optional

import torch
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x.to(self.conv1.weight.dtype))  # (N, width, grid, grid)
        x = x.flatten(2).transpose(1, 2)  # (N, grid*grid, width), row-major patches
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = self.transformer(self.ln_pre(x))
        x = self.ln_post(x[:, 0].float())
        # the 512-d embedding is the user-facing contract: fp32 projection
        return x.float() @ self.proj.float()


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
