"""The port's CLIP tower and converters against the JAX package's.

A small tower (2 layers, 64 wide, 4 heads, 32-d embedding) keeps 224 px
and patch 32, so L = 50 as at full width. One set of weights reaches both
packages (``params_from_jax``, or one OpenAI / HF state dict through each
package's converter); the outputs agree within 1e-4 (fp32 on both sides,
sums in other orders through 2 blocks).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_features_tpu.models.clip import convert as jax_convert
from video_features_tpu.models.clip import model as jax_model
from video_features_tpu_torch.models.clip.convert import (
    convert_state_dict,
    from_openai,
    params_from_jax,
)
from video_features_tpu_torch.models.clip.model import (
    CLIPVisionConfig,
    VisionTransformer,
    init_weights,
)
from video_features_tpu_torch.ops.attention import attention, blockwise_attention
from video_features_tpu_torch.ops.flash_attention import flash_attention

SMALL = dict(layers=2, width=64, heads=4, embed_dim=32)
ATOL = 1e-4
CORES = {"fused": attention, "flash": flash_attention, "blockwise": blockwise_attention}


def _frames(seed=0, n=3):
    return np.random.RandomState(seed).randn(n, 3, 224, 224).astype(np.float32)


def _port(sd, core=None):
    model = VisionTransformer(CLIPVisionConfig(**SMALL), core=core)
    model.load_state_dict(sd)
    return model.eval()


def _jax_forward(params, x):
    cfg = jax_model.CLIPVisionConfig(**SMALL)
    return np.asarray(jax_model.VisionTransformer(cfg).apply({"params": params}, jnp.asarray(x)))


def openai_state_dict(seed=1, cfg=SMALL):
    """A seeded OpenAI ``visual.*`` state dict (plus text-tower noise)."""
    rng = np.random.RandomState(seed)
    D, E = cfg["width"], cfg["embed_dim"]

    def w(*shape):
        return (rng.randn(*shape) * shape[-1] ** -0.5).astype(np.float32)

    def ln():
        return (1 + 0.1 * rng.randn(D)).astype(np.float32), (0.1 * rng.randn(D)).astype(np.float32)

    sd = {
        "visual.class_embedding": w(D),
        "visual.positional_embedding": w(50, D),
        "visual.proj": w(D, E),
        "visual.conv1.weight": w(D, 3, 32, 32),
        "token_embedding.weight": w(10, 4),
    }
    sd["visual.ln_pre.weight"], sd["visual.ln_pre.bias"] = ln()
    sd["visual.ln_post.weight"], sd["visual.ln_post.bias"] = ln()
    for i in range(cfg["layers"]):
        p = f"visual.transformer.resblocks.{i}"
        sd[f"{p}.attn.in_proj_weight"] = w(3 * D, D)
        sd[f"{p}.attn.in_proj_bias"] = w(3 * D)
        sd[f"{p}.attn.out_proj.weight"] = w(D, D)
        sd[f"{p}.attn.out_proj.bias"] = w(D)
        sd[f"{p}.ln_1.weight"], sd[f"{p}.ln_1.bias"] = ln()
        sd[f"{p}.ln_2.weight"], sd[f"{p}.ln_2.bias"] = ln()
        sd[f"{p}.mlp.c_fc.weight"] = w(4 * D, D)
        sd[f"{p}.mlp.c_fc.bias"] = w(4 * D)
        sd[f"{p}.mlp.c_proj.weight"] = w(D, 4 * D)
        sd[f"{p}.mlp.c_proj.bias"] = w(D)
    return sd


def hf_state_dict(sd):
    """The same weights under HF CLIPVisionModelWithProjection names."""
    emb = "vision_model.embeddings"
    out = {
        f"{emb}.class_embedding": sd["visual.class_embedding"],
        f"{emb}.position_embedding.weight": sd["visual.positional_embedding"],
        f"{emb}.patch_embedding.weight": sd["visual.conv1.weight"],
        f"{emb}.position_ids": np.arange(50)[None],
        "visual_projection.weight": sd["visual.proj"].T,
    }
    for ours, theirs in (("ln_pre", "pre_layrnorm"), ("ln_post", "post_layernorm")):
        for s in ("weight", "bias"):
            out[f"vision_model.{theirs}.{s}"] = sd[f"visual.{ours}.{s}"]
    for i in range(SMALL["layers"]):
        p, h = f"visual.transformer.resblocks.{i}", f"vision_model.encoder.layers.{i}"
        for s, key in (("weight", "in_proj_weight"), ("bias", "in_proj_bias")):
            for name, part in zip(("q_proj", "k_proj", "v_proj"), np.split(sd[f"{p}.attn.{key}"], 3)):
                out[f"{h}.self_attn.{name}.{s}"] = part
        for ours, theirs in (("attn.out_proj", "self_attn.out_proj"), ("ln_1", "layer_norm1"),
                             ("ln_2", "layer_norm2"), ("mlp.c_fc", "mlp.fc1"),
                             ("mlp.c_proj", "mlp.fc2")):
            for s in ("weight", "bias"):
                out[f"{h}.{theirs}.{s}"] = sd[f"{p}.{ours}.{s}"]
    return out


@pytest.mark.parametrize("core", sorted(CORES))
def test_params_from_jax_matches_jax_model(core):
    params = jax_model.init_params(jax_model.CLIPVisionConfig(**SMALL), seed=0)
    x = _frames()
    ref = _jax_forward(params, x)
    with torch.inference_mode():
        out = _port(params_from_jax(params), CORES[core])(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (3, SMALL["embed_dim"])
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("layout", ["openai", "hf"])
def test_one_checkpoint_gives_one_output(layout):
    """The port loads a checkpoint directly; JAX through its converter."""
    sd = openai_state_dict()
    if layout == "hf":
        sd = hf_state_dict(sd)
    x = _frames(seed=2)
    ref = _jax_forward(jax_convert.convert_state_dict(sd, layers=SMALL["layers"]), x)
    with torch.inference_mode():
        out = _port(convert_state_dict(sd, layers=SMALL["layers"]))(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_openai_converter_rejects_unconsumed_and_foreign():
    sd = openai_state_dict()
    sd["visual.transformer.resblocks.9.ln_1.weight"] = np.ones(4, np.float32)
    with pytest.raises(ValueError, match="unconsumed"):
        from_openai(sd, layers=SMALL["layers"])
    with pytest.raises(ValueError, match="unrecognized"):
        convert_state_dict({"foo.weight": np.ones(2, np.float32)})


def test_random_init_is_seeded_and_well_scaled():
    cfg = CLIPVisionConfig(**SMALL)
    a = init_weights(VisionTransformer(cfg), seed=0).state_dict()
    b = init_weights(VisionTransformer(cfg), seed=0).state_dict()
    c = init_weights(VisionTransformer(cfg), seed=1).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["proj"], c["proj"])
    assert torch.equal(a["ln_pre.weight"], torch.ones(64))
    model = VisionTransformer(cfg)
    model.load_state_dict(a)
    with torch.inference_mode():
        out = model(torch.from_numpy(_frames()))
    assert torch.isfinite(out).all() and 0.1 < out.std().item() < 10
