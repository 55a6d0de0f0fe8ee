"""EVA-ViT-g vision tower — the alternative ChatUniVi tower.

Behavioral spec: /root/reference/ChatUniVi/model/multimodal_encoder/
eva_vit.py (VisionTransformer :249, create_eva_vit_g :421: patch 14,
embed 1408, depth 39, heads 16, mlp_ratio 4.3637, qkv_bias) and
eva_encoder.py (EVAVisionTower :7: intermediate-layer select + cls drop).
Selected when the tower name starts with "eva_vit_g"
(multimodal_encoder/builder.py:5-13); the shipped config uses the CLIP
ViT-L tower instead.

Quirks reproduced: fused qkv projection with LEARNED q/v biases and a
ZERO k bias (eva_vit.py:78-126); pre-LN blocks, eps 1e-6; absolute
position embeddings incl. cls; features taken from an INTERMEDIATE block
output (before the final norm), cls token dropped for 'patch' selection.
DropPath/dropout are inference-irrelevant (rate 0 in create_eva_vit_g).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from open_pandora_tpu.core import nn
from open_pandora_tpu.core.config import CLIPTowerConfig
from open_pandora_tpu.ops.attention_xla import mha_xla
from open_pandora_tpu.ops.norms import layer_norm


class _LN(nn.Module):
    eps: float = 1e-6

    @nn.compact
    def __call__(self, x):
        c = x.shape[-1]
        return layer_norm(x, self.param("scale", nn.initializers.ones, (c,)),
                          self.param("bias", nn.initializers.zeros, (c,)),
                          eps=self.eps)


class EVABlock(nn.Module):
    heads: int
    mlp_hidden: int
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x):
        b, n, c = x.shape
        dh = c // self.heads
        y = _LN(name="norm1")(x)
        qkv_w = self.param("qkv_kernel", nn.initializers.lecun_normal(),
                           (c, 3 * c))
        q_bias = self.param("q_bias", nn.initializers.zeros, (c,))
        v_bias = self.param("v_bias", nn.initializers.zeros, (c,))
        # k bias is hard-zero in the reference (eva_vit.py:124)
        bias = jnp.concatenate([q_bias, jnp.zeros_like(q_bias), v_bias])
        qkv = y @ qkv_w.astype(self.dtype) + bias.astype(self.dtype)
        q, k, v = jnp.split(qkv.reshape(b, n, 3, self.heads, dh), 3, axis=2)
        o = mha_xla(q[:, :, 0], k[:, :, 0], v[:, :, 0]).reshape(b, n, c)
        o = nn.Dense(c, dtype=self.dtype, name="proj")(o)
        x = x + o
        y = _LN(name="norm2")(x)
        h = nn.Dense(self.mlp_hidden, dtype=self.dtype, name="mlp_fc1")(y)
        h = jax.nn.gelu(h, approximate=False)
        h = nn.Dense(c, dtype=self.dtype, name="mlp_fc2")(h)
        return x + h


class EVAVisionTower(nn.Module):
    """(b, S, S, 3) preprocessed images -> (b, n_patches, width) features
    from config.select_layer, cls dropped (eva_encoder.py:32-40)."""

    cfg: CLIPTowerConfig
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, images: jnp.ndarray) -> jnp.ndarray:
        cfg = self.cfg
        b = images.shape[0]
        grid = cfg.image_size // cfg.patch_size
        mlp_hidden = int(cfg.width * cfg.mlp_ratio)
        x = nn.Conv(cfg.width, (cfg.patch_size, cfg.patch_size),
                    strides=cfg.patch_size, padding="VALID",
                    dtype=self.dtype, name="patch_embed")(
            images.astype(self.dtype))
        x = x.reshape(b, grid * grid, cfg.width)
        cls = self.param("cls_token", nn.initializers.zeros, (1, 1, cfg.width))
        x = jnp.concatenate(
            [jnp.broadcast_to(cls.astype(self.dtype), (b, 1, cfg.width)), x],
            axis=1)
        pos = self.param("pos_embed", nn.initializers.normal(0.02),
                         (1, grid * grid + 1, cfg.width))
        x = x + pos.astype(self.dtype)

        n_keep = cfg.layers + cfg.select_layer + 1 if cfg.select_layer < 0 \
            else cfg.select_layer + 1
        feats = None
        for i in range(cfg.layers):
            x = EVABlock(heads=cfg.heads, mlp_hidden=mlp_hidden,
                         dtype=self.dtype, name=f"blocks_{i}")(x)
            if i == n_keep - 1:
                feats = x
        assert feats is not None, "select_layer out of range"
        return feats[:, 1:]  # drop cls ('patch' selection)
