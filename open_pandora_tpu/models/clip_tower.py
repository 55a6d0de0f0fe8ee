"""CLIP ViT-L/14 vision tower for the LLM (ChatUniVi's frozen encoder).

Behavioral spec: /root/reference/ChatUniVi/model/multimodal_encoder/
clip_encoder.py:7-83 — HF CLIPVisionModel, output_hidden_states, select
layer -2, feature_select drops the CLS token -> 256 patch tokens per 224^2
image. HF CLIP-ViT-L specifics: quick_gelu activation, LayerNorm eps 1e-5,
class embedding + learned position embedding, pre_layrnorm before the
encoder, patch conv without bias.

Note vs the OpenCLIP towers in encoders.py: different weight layout
(separate q/k/v projections vs packed in_proj) and quick_gelu vs gelu —
kept as a separate module so each converts 1:1 from its torch family.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from open_pandora_tpu.core import nn
from open_pandora_tpu.core.config import CLIPTowerConfig
from open_pandora_tpu.ops.attention import attention
from open_pandora_tpu.ops.norms import layer_norm


def quick_gelu(x):
    return x * jax.nn.sigmoid(1.702 * x)


class LayerNorm(nn.Module):
    eps: float = 1e-5

    @nn.compact
    def __call__(self, x):
        c = x.shape[-1]
        scale = self.param("scale", nn.initializers.ones, (c,))
        bias = self.param("bias", nn.initializers.zeros, (c,))
        return layer_norm(x, scale, bias, eps=self.eps)


class CLIPEncoderLayer(nn.Module):
    heads: int
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x):
        b, n, d = x.shape
        dh = d // self.heads
        y = LayerNorm(name="layer_norm1")(x)
        q = nn.Dense(d, dtype=self.dtype, name="q_proj")(y)
        k = nn.Dense(d, dtype=self.dtype, name="k_proj")(y)
        v = nn.Dense(d, dtype=self.dtype, name="v_proj")(y)
        o = attention(q.reshape(b, n, self.heads, dh),
                      k.reshape(b, n, self.heads, dh),
                      v.reshape(b, n, self.heads, dh)).reshape(b, n, d)
        x = x + nn.Dense(d, dtype=self.dtype, name="out_proj")(o)
        y = LayerNorm(name="layer_norm2")(x)
        y = nn.Dense(4 * d, dtype=self.dtype, name="fc1")(y)
        y = quick_gelu(y)
        x = x + nn.Dense(d, dtype=self.dtype, name="fc2")(y)
        return x


class CLIPVisionTower(nn.Module):
    """Returns the select_layer hidden states WITHOUT the CLS token:
    (b, grid^2, width). Input: preprocessed (b, 224, 224, 3)."""

    cfg: CLIPTowerConfig
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, images: jnp.ndarray) -> jnp.ndarray:
        cfg = self.cfg
        b = images.shape[0]
        grid = cfg.image_size // cfg.patch_size
        x = nn.Conv(cfg.width, (cfg.patch_size, cfg.patch_size),
                    strides=cfg.patch_size, use_bias=False, padding="VALID",
                    dtype=self.dtype, name="patch_embedding")(images)
        x = x.reshape(b, grid * grid, cfg.width)
        cls = self.param("class_embedding", nn.initializers.normal(0.02),
                         (cfg.width,))
        x = jnp.concatenate(
            [jnp.broadcast_to(cls.astype(self.dtype), (b, 1, cfg.width)), x],
            axis=1)
        pos = self.param("position_embedding", nn.initializers.normal(0.01),
                         (grid * grid + 1, cfg.width))
        x = x + pos.astype(self.dtype)
        x = LayerNorm(name="pre_layrnorm")(x)  # (sic — HF's typo'd name)
        # select_layer=-2: run all but the last |select_layer|-1 layers
        n_run = cfg.layers + 1 + cfg.select_layer  # e.g. 24 + 1 - 2 = 23
        for i in range(n_run):
            x = CLIPEncoderLayer(heads=cfg.heads, dtype=self.dtype,
                                 name=f"layers_{i}")(x)
        return x[:, 1:]  # drop CLS (clip_encoder.py:34-43 'patch')
