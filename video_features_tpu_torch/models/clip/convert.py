"""Checkpoints into the port's CLIP visual tower.

Counterpart of ``video_features_tpu/models/clip/convert.py``. The port's
module uses OpenAI's ``visual.*`` names, so:

- ``from_openai``: an OpenAI ``clip`` checkpoint (full model or visual
  only, CLIP4CLIP fine-tunes too) loads by dropping the ``visual.``
  prefix; text-tower tensors are ignored.
- ``from_hf_vision``: a HuggingFace ``CLIPVisionModelWithProjection``
  state dict; split q/k/v projections are fused into ``in_proj``.
- ``params_from_jax``: the JAX package's Flax param tree (numpy leaves),
  the inverse of its ``from_openai``. It carries one set of weights into
  both packages for the parity tests.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from video_features_tpu_torch.models.common.weights import check_all_consumed

StateDict = Dict[str, torch.Tensor]


def _tensors(sd: Dict[str, np.ndarray]) -> StateDict:
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in sd.items()}


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def from_openai(sd: Dict[str, np.ndarray], layers: int = 12) -> StateDict:
    """OpenAI clip state dict -> the port's state dict."""
    v = {k[len("visual."):]: val for k, val in sd.items() if k.startswith("visual.")}
    if not v:
        raise ValueError("no 'visual.*' tensors found — not an OpenAI CLIP checkpoint?")
    keys = ["class_embedding", "positional_embedding", "proj", "conv1.weight",
            "ln_pre.weight", "ln_pre.bias", "ln_post.weight", "ln_post.bias"]
    for i in range(layers):
        p = f"transformer.resblocks.{i}"
        keys += [f"{p}.{name}" for name in (
            "attn.in_proj_weight", "attn.in_proj_bias", "attn.out_proj.weight",
            "attn.out_proj.bias", "ln_1.weight", "ln_1.bias", "ln_2.weight", "ln_2.bias",
            "mlp.c_fc.weight", "mlp.c_fc.bias", "mlp.c_proj.weight", "mlp.c_proj.bias",
        )]
    check_all_consumed(v, keys, "CLIP-visual(openai)")
    return _tensors({k: v[k] for k in keys})


def from_hf_vision(sd: Dict[str, np.ndarray], layers: int = 12) -> StateDict:
    """HF CLIPVisionModelWithProjection state dict -> the port's."""
    sd = {
        k: np.asarray(val, np.float32)
        for k, val in sd.items()
        if k.startswith(("vision_model.", "visual_projection."))
    }
    if not sd:
        raise ValueError("no 'vision_model.*' tensors found — not an HF CLIP checkpoint?")
    consumed = set()

    def take(key):
        consumed.add(key)
        return sd[key]

    emb = "vision_model.embeddings"
    out = {
        "class_embedding": take(f"{emb}.class_embedding"),
        "positional_embedding": take(f"{emb}.position_embedding.weight"),
        "proj": take("visual_projection.weight").T,
        "conv1.weight": take(f"{emb}.patch_embedding.weight"),
    }
    # HF really spells it 'pre_layrnorm'
    for ours, theirs in (("ln_pre", "vision_model.pre_layrnorm"),
                         ("ln_post", "vision_model.post_layernorm")):
        out[f"{ours}.weight"] = take(f"{theirs}.weight")
        out[f"{ours}.bias"] = take(f"{theirs}.bias")
    for i in range(layers):
        p, h = f"transformer.resblocks.{i}", f"vision_model.encoder.layers.{i}"
        qkv = ("q_proj", "k_proj", "v_proj")
        out[f"{p}.attn.in_proj_weight"] = np.concatenate(
            [take(f"{h}.self_attn.{n}.weight") for n in qkv])
        out[f"{p}.attn.in_proj_bias"] = np.concatenate(
            [take(f"{h}.self_attn.{n}.bias") for n in qkv])
        for ours, theirs in (("attn.out_proj", "self_attn.out_proj"), ("ln_1", "layer_norm1"),
                             ("ln_2", "layer_norm2"), ("mlp.c_fc", "mlp.fc1"),
                             ("mlp.c_proj", "mlp.fc2")):
            out[f"{p}.{ours}.weight"] = take(f"{h}.{theirs}.weight")
            out[f"{p}.{ours}.bias"] = take(f"{h}.{theirs}.bias")
    consumed.add(f"{emb}.position_ids")  # a buffer, not a weight
    check_all_consumed(sd, consumed, "CLIP-visual(hf)")
    return _tensors(out)


def convert_state_dict(sd: Dict[str, np.ndarray], layers: int = 12) -> StateDict:
    """Detect the checkpoint flavour and convert it."""
    if any(k.startswith("visual.") for k in sd):
        return from_openai(sd, layers)
    if any(k.startswith("vision_model.") for k in sd):
        return from_hf_vision(sd, layers)
    raise ValueError("unrecognized CLIP checkpoint format")


def params_from_jax(params) -> StateDict:
    """The JAX package's CLIP param tree (nested dicts of arrays) -> the
    port's state dict: Dense kernels (in, out) transpose to Linear
    weights, the NHWC conv kernel (kh, kw, in, out) to (out, in, kh, kw),
    and q/k/v_proj fuse back into ``in_proj``."""
    out = {
        "class_embedding": _f32(params["class_embedding"]),
        "positional_embedding": _f32(params["positional_embedding"]),
        "proj": _f32(params["proj"]),
        "conv1.weight": _f32(params["conv1"]["kernel"]).transpose(3, 2, 0, 1),
    }
    for ln in ("ln_pre", "ln_post"):
        out[f"{ln}.weight"] = _f32(params[ln]["scale"])
        out[f"{ln}.bias"] = _f32(params[ln]["bias"])
    layers = sum(1 for k in params if k.startswith("resblock_"))
    for i in range(layers):
        blk, p = params[f"resblock_{i}"], f"transformer.resblocks.{i}"
        attn = blk["attn"]
        qkv = ("q_proj", "k_proj", "v_proj")
        out[f"{p}.attn.in_proj_weight"] = np.concatenate([_f32(attn[n]["kernel"]).T for n in qkv])
        out[f"{p}.attn.in_proj_bias"] = np.concatenate([_f32(attn[n]["bias"]) for n in qkv])
        for ours, dense in (("attn.out_proj", attn["out_proj"]), ("mlp.c_fc", blk["c_fc"]),
                            ("mlp.c_proj", blk["c_proj"])):
            out[f"{p}.{ours}.weight"] = _f32(dense["kernel"]).T
            out[f"{p}.{ours}.bias"] = _f32(dense["bias"])
        for ln in ("ln_1", "ln_2"):
            out[f"{p}.{ln}.weight"] = _f32(blk[ln]["scale"])
            out[f"{p}.{ln}.bias"] = _f32(blk[ln]["bias"])
    return _tensors(out)
