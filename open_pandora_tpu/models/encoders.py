"""Frozen conditioning encoders — OpenCLIP ViT-H text/vision + Perceiver
Resampler, in flax/JAX.

Behavioral spec: /root/reference/DynamiCrafter/lvdm/modules/encoders/
condition.py (FrozenOpenCLIPEmbedder :179-236 — penultimate layer: run
n_layers-1 blocks then ln_final; FrozenOpenCLIPImageEmbedderV2 :300-382 —
conv1 patches + cls + pos, ln_pre, FULL transformer, NO ln_post/pooling,
returns all 257 tokens) and resampler.py (Resampler :96-144,
PerceiverAttention :48-93 — kv over concat(image_feats, latents), softmax in
fp32 with the sqrt-sqrt scale split).

The text tower's causal mask and all softmax/LN statistics are fp32.
ViT-H-14: text width 1024/24 layers/16 heads; visual width 1280/32 layers/
16 heads (head_dim 80), patch 14, GELU (laion2b checkpoints, not QuickGELU).

Tokenization: BPE vocab files are an external asset; `empty_prompt_tokens`
covers the framework-internal need (the "" unconditional prompt,
model.py:723-725) without them, and `encode_tokens` takes pre-tokenized ids.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp

from open_pandora_tpu.core import nn
from open_pandora_tpu.core.config import (CLIPTextConfig, CLIPVisionConfig,
                                          ResamplerConfig)
from open_pandora_tpu.ops.attention import attention
from open_pandora_tpu.ops.norms import layer_norm

SOT_TOKEN = 49406
EOT_TOKEN = 49407

# OpenCLIP image preprocessing constants (condition.py:323-324)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def empty_prompt_tokens(batch: int = 1, context_length: int = 77) -> jnp.ndarray:
    """Token ids for the empty string: [SOT, EOT, 0, ...]."""
    ids = jnp.zeros((batch, context_length), dtype=jnp.int32)
    ids = ids.at[:, 0].set(SOT_TOKEN)
    ids = ids.at[:, 1].set(EOT_TOKEN)
    return ids


def clip_preprocess(images: jnp.ndarray, size: int = 224) -> jnp.ndarray:
    """images (b, h, w, 3) in [0, 1] -> resized + CLIP-normalized.

    (condition.py:326-339: torchvision Resize(224) bilinear + Normalize.)
    """
    b, h, w, c = images.shape
    if (h, w) != (size, size):
        images = jax.image.resize(images, (b, size, size, c), method="bilinear")
    mean = jnp.asarray(CLIP_MEAN, dtype=images.dtype)
    std = jnp.asarray(CLIP_STD, dtype=images.dtype)
    return (images - mean) / std


class LayerNorm(nn.Module):
    eps: float = 1e-5

    @nn.compact
    def __call__(self, x):
        c = x.shape[-1]
        scale = self.param("scale", nn.initializers.ones, (c,))
        bias = self.param("bias", nn.initializers.zeros, (c,))
        return layer_norm(x, scale, bias, eps=self.eps)


class ResidualAttentionBlock(nn.Module):
    """open_clip-style pre-LN block: ln_1 -> MHA -> +, ln_2 -> MLP(GELU) -> +."""

    heads: int
    causal: bool = False
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x):
        b, n, d = x.shape
        dh = d // self.heads
        y = LayerNorm(name="ln_1")(x)
        qkv = nn.Dense(3 * d, dtype=self.dtype, name="attn_in_proj")(y)
        q, k, v = jnp.split(qkv, 3, axis=-1)
        q = q.reshape(b, n, self.heads, dh)
        k = k.reshape(b, n, self.heads, dh)
        v = v.reshape(b, n, self.heads, dh)
        o = attention(q, k, v, causal=self.causal).reshape(b, n, d)
        x = x + nn.Dense(d, dtype=self.dtype, name="attn_out_proj")(o)
        y = LayerNorm(name="ln_2")(x)
        y = nn.Dense(4 * d, dtype=self.dtype, name="mlp_c_fc")(y)
        y = jax.nn.gelu(y, approximate=False)
        x = x + nn.Dense(d, dtype=self.dtype, name="mlp_c_proj")(y)
        return x


class CLIPTextEncoder(nn.Module):
    """FrozenOpenCLIPEmbedder, layer='penultimate' (condition.py:179-236)."""

    cfg: CLIPTextConfig
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, token_ids: jnp.ndarray) -> jnp.ndarray:
        cfg = self.cfg
        emb = self.param("token_embedding", nn.initializers.normal(0.02),
                         (cfg.vocab_size, cfg.width))
        pos = self.param("positional_embedding", nn.initializers.normal(0.01),
                         (cfg.context_length, cfg.width))
        x = emb[token_ids].astype(self.dtype) + pos.astype(self.dtype)
        n_blocks = cfg.layers - (1 if cfg.penultimate else 0)
        for i in range(n_blocks):
            x = ResidualAttentionBlock(heads=cfg.heads, causal=True,
                                       dtype=self.dtype,
                                       name=f"resblocks_{i}")(x)
        return LayerNorm(name="ln_final")(x)


class CLIPTextEmbeddingEncoder(nn.Module):
    """CLIPTextEmbeddingModel (model.py:1214-1306): a CLIP text transformer
    driven by inputs_embeds — the LLM-derived conditioning is fed straight
    into the causal encoder stack (NO token or position embeddings are
    added in the inputs_embeds path, model.py:1241-1246) and the final
    LayerNorm output is the conditioning. Only active under
    use_diffusion_text_encoder=True (the shipped checkpoint has it False,
    config_json.json)."""

    cfg: CLIPTextConfig
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, inputs_embeds: jnp.ndarray) -> jnp.ndarray:
        x = inputs_embeds.astype(self.dtype)
        for i in range(self.cfg.layers):
            x = ResidualAttentionBlock(heads=self.cfg.heads, causal=True,
                                       dtype=self.dtype,
                                       name=f"resblocks_{i}")(x)
        return LayerNorm(name="ln_final")(x)


class CLIPVisionEncoder(nn.Module):
    """FrozenOpenCLIPImageEmbedderV2 (condition.py:300-382): all patch+cls
    tokens, no ln_post, no pooling. Input: preprocessed (b, 224, 224, 3)."""

    cfg: CLIPVisionConfig
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, images: jnp.ndarray) -> jnp.ndarray:
        cfg = self.cfg
        b = images.shape[0]
        grid = cfg.image_size // cfg.patch_size
        x = nn.Conv(cfg.width, (cfg.patch_size, cfg.patch_size),
                    strides=cfg.patch_size, use_bias=False, padding="VALID",
                    dtype=self.dtype, name="conv1")(images)
        x = x.reshape(b, grid * grid, cfg.width)
        cls = self.param("class_embedding", nn.initializers.normal(0.02),
                         (cfg.width,))
        cls = jnp.broadcast_to(cls.astype(self.dtype), (b, 1, cfg.width))
        x = jnp.concatenate([cls, x], axis=1)
        pos = self.param("positional_embedding", nn.initializers.normal(0.01),
                         (grid * grid + 1, cfg.width))
        x = x + pos.astype(self.dtype)
        x = LayerNorm(name="ln_pre")(x)
        for i in range(cfg.layers):
            x = ResidualAttentionBlock(heads=cfg.heads, dtype=self.dtype,
                                       name=f"resblocks_{i}")(x)
        return x  # (b, 257, width) — includes the cls token


class PerceiverAttention(nn.Module):
    """resampler.py:48-93. kv over concat(x, latents); q,k each scaled by
    dim_head**-0.25 before the product (fp16-stable split), softmax fp32."""

    heads: int
    dim_head: int
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, latents):
        inner = self.heads * self.dim_head
        x = LayerNorm(name="norm1")(x)
        latents = LayerNorm(name="norm2")(latents)
        b, l, _ = latents.shape
        q = nn.Dense(inner, use_bias=False, dtype=self.dtype, name="to_q")(latents)
        kv_in = jnp.concatenate([x, latents], axis=-2)
        kv = nn.Dense(inner * 2, use_bias=False, dtype=self.dtype, name="to_kv")(kv_in)
        k, v = jnp.split(kv, 2, axis=-1)
        m = kv_in.shape[1]
        out = attention(
            q.reshape(b, l, self.heads, self.dim_head),
            k.reshape(b, m, self.heads, self.dim_head),
            v.reshape(b, m, self.heads, self.dim_head),
        ).reshape(b, l, inner)
        return nn.Dense(latents.shape[-1], use_bias=False, dtype=self.dtype,
                        name="to_out")(out)


class Resampler(nn.Module):
    """resampler.py:96-144 — image_proj_model: num_queries learned latents
    per frame, `depth` Perceiver blocks, projection to the UNet context dim."""

    cfg: ResamplerConfig
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        cfg = self.cfg
        nq = cfg.num_queries * (cfg.video_length or 1)
        latents = self.param(
            "latents",
            lambda key, shape: jax.random.normal(key, shape) / cfg.dim ** 0.5,
            (1, nq, cfg.dim))
        b = x.shape[0]
        lat = jnp.broadcast_to(latents, (b, nq, cfg.dim)).astype(self.dtype)
        x = nn.Dense(cfg.dim, dtype=self.dtype, name="proj_in")(x)
        for i in range(cfg.depth):
            lat = lat + PerceiverAttention(
                heads=cfg.heads, dim_head=cfg.dim_head, dtype=self.dtype,
                name=f"layers_{i}_attn")(x, lat)
            ff_in = LayerNorm(name=f"layers_{i}_ff_norm")(lat)
            h = nn.Dense(cfg.dim * cfg.ff_mult, use_bias=False,
                         dtype=self.dtype, name=f"layers_{i}_ff_1")(ff_in)
            h = jax.nn.gelu(h, approximate=False)
            lat = lat + nn.Dense(cfg.dim, use_bias=False, dtype=self.dtype,
                                 name=f"layers_{i}_ff_3")(h)
        out = nn.Dense(cfg.output_dim, dtype=self.dtype, name="proj_out")(lat)
        return LayerNorm(name="norm_out")(out)
