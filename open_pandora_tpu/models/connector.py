"""The trainable connector: learned [IMG_P] prefix + BLIP-2 Q-Former +
projections, mapping frozen-LLM hidden states into the diffusion model's
cross-attention space.

Behavioral spec: /root/reference/model.py:567-582 (modules) and :616-686
(get_diffusion_conditioning flow):
  - image_prefix = Linear(4096, 64, bias=False) whose WEIGHT ROWS are the 64
    learned prefix embeddings substituted at [IMG_P] positions (:642-654)
  - diffusion_qformer_proj: Linear 4096 -> 768
  - diffusion_qformer: HF Blip2QFormerModel (12 layers, hidden 768, BERT
    post-LN blocks, cross-attention every 2 layers, query-path FFN)
  - diffusion_query_tokens: (77, 768) learned queries
  - diffusion_proj: Linear 768 -> 1024 (SD2 UNet cross_attention_dim)

HF Blip2QFormer layer anatomy (transformers blip_2/modeling_blip_2.py):
self-attention (BERT style: q/k/v + output dense + residual LN eps 1e-12)
-> [cross-attention to encoder_hidden_states on even layers] ->
intermediate_query/output_query FFN (gelu). Query embeddings get a LayerNorm
+ dropout before the encoder.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp

from open_pandora_tpu.core import nn
from open_pandora_tpu.core.config import ConnectorConfig, QFormerConfig
from open_pandora_tpu.ops.attention import attention
from open_pandora_tpu.ops.norms import layer_norm


class LayerNorm(nn.Module):
    eps: float = 1e-12

    @nn.compact
    def __call__(self, x):
        c = x.shape[-1]
        scale = self.param("scale", nn.initializers.ones, (c,))
        bias = self.param("bias", nn.initializers.zeros, (c,))
        return layer_norm(x, scale, bias, eps=self.eps)


class BertAttention(nn.Module):
    """BERT-style attention block: MHA + output dense + residual LayerNorm."""

    heads: int
    eps: float = 1e-12
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, kv=None):
        kv = x if kv is None else kv
        b, n, d = x.shape
        m = kv.shape[1]
        dh = d // self.heads
        q = nn.Dense(d, dtype=self.dtype, name="query")(x)
        k = nn.Dense(d, dtype=self.dtype, name="key")(kv)
        v = nn.Dense(d, dtype=self.dtype, name="value")(kv)
        o = attention(q.reshape(b, n, self.heads, dh),
                      k.reshape(b, m, self.heads, dh),
                      v.reshape(b, m, self.heads, dh)).reshape(b, n, d)
        o = nn.Dense(d, dtype=self.dtype, name="output_dense")(o)
        return LayerNorm(self.eps, name="output_layernorm")(o + x)


class QFormerLayer(nn.Module):
    cfg: QFormerConfig
    has_cross: bool
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, encoder_hidden_states):
        cfg = self.cfg
        x = BertAttention(cfg.num_heads, cfg.layer_norm_eps, dtype=self.dtype,
                          name="attention")(x)
        if self.has_cross:
            x = BertAttention(cfg.num_heads, cfg.layer_norm_eps,
                              dtype=self.dtype, name="crossattention")(
                x, encoder_hidden_states)
        # query-path FFN (all our tokens are queries)
        y = nn.Dense(cfg.intermediate_size, dtype=self.dtype,
                     name="intermediate_query")(x)
        y = jax.nn.gelu(y, approximate=False)
        y = nn.Dense(cfg.hidden_size, dtype=self.dtype, name="output_query")(y)
        return LayerNorm(cfg.layer_norm_eps, name="output_query_layernorm")(y + x)


class QFormer(nn.Module):
    """Blip2QFormerModel over query embeddings with cross-attention to
    encoder_hidden_states (the projected LLM [IMG_P] hidden states)."""

    cfg: QFormerConfig
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, query_embeds, encoder_hidden_states):
        x = LayerNorm(self.cfg.layer_norm_eps, name="layernorm")(query_embeds)
        for i in range(self.cfg.num_layers):
            x = QFormerLayer(
                self.cfg,
                has_cross=(i % self.cfg.cross_attention_frequency == 0),
                dtype=self.dtype, name=f"layer_{i}")(x, encoder_hidden_states)
        return x


class Connector(nn.Module):
    """image_prefix rows + qformer_proj -> QFormer -> diffusion_proj."""

    cfg: ConnectorConfig
    qcfg: QFormerConfig
    dtype: Any = jnp.float32

    def setup(self):
        self.image_prefix = self.param(
            "image_prefix", nn.initializers.normal(0.02),
            (self.cfg.image_prefix_length, self.cfg.llm_hidden))
        self.qformer_proj = nn.Dense(self.cfg.qformer_proj_dim,
                                     dtype=self.dtype, name="qformer_proj")
        self.query_tokens = self.param(
            "query_tokens", nn.initializers.normal(0.02),
            (self.qcfg.num_query_tokens, self.qcfg.hidden_size))
        self.qformer = QFormer(self.qcfg, dtype=self.dtype, name="qformer")
        self.proj = nn.Dense(self.cfg.proj_out_dim, dtype=self.dtype,
                             name="proj")

    def prefix_embeddings(self) -> jnp.ndarray:
        """The 64 learned [IMG_P] prefix rows (model.py:649-653)."""
        return self.image_prefix

    def __call__(self, imgp_hidden: jnp.ndarray) -> jnp.ndarray:
        """imgp_hidden (n, 64, 4096) LLM hidden states at the [IMG_P]
        positions -> (n, 77, proj_out_dim) diffusion conditioning
        (model.py:678-686)."""
        n = imgp_hidden.shape[0]
        enc = self.qformer_proj(imgp_hidden.astype(self.dtype))
        queries = jnp.broadcast_to(
            self.query_tokens[None].astype(self.dtype),
            (n, *self.query_tokens.shape))
        out = self.qformer(queries, enc)
        return self.proj(out)
