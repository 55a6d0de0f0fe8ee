"""LLaMA-7B trunk on the `core.nn` module layer (prefill-oriented).

Behavioral spec: /root/reference/ChatUniVi/model/language_model/llama.py:12-121
(ChatUniViLlamaForCausalLM wraps HF LlamaModel; the WorldModel calls the BARE
trunk — `video_model.model(...)` at model.py:659 — on spliced inputs_embeds
and consumes hidden states only, never the lm_head). HF LLaMA semantics:
RMSNorm eps 1e-6 (fp32 stats, scale after cast-back), rotary embeddings
(theta 10000, full head dim), SwiGLU MLP, pre-norm residual blocks.

Token ids (reference model.py:636,848: "ugly hardcode"):
  <image> = 32000 (= vocab_size, the splice marker IMAGE_TOKEN_INDEX)
  [IMG_P] = 32001 (vocab_size + 1, the connector's learned-prefix slots)

Design: causal attention through the ops.attention dispatcher; the embedding table is exposed via embed() so the multimodal
splice can mix token embeddings with projected CLIP features
(arch.py:219-396 equivalent) before the trunk runs.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp

from open_pandora_tpu.core import nn
from open_pandora_tpu.core.config import LLaMAConfig
from open_pandora_tpu.ops.attention import attention
from open_pandora_tpu.ops.norms import rms_norm

IMAGE_TOKEN_ID = 32000
IMG_PREFIX_TOKEN_ID = 32001


class RMSNorm(nn.Module):
    eps: float = 1e-6

    @nn.compact
    def __call__(self, x):
        scale = self.param("scale", nn.initializers.ones, (x.shape[-1],))
        return rms_norm(x, scale, eps=self.eps)


def rotary_embed(x: jnp.ndarray, positions: jnp.ndarray,
                 theta: float = 10000.0) -> jnp.ndarray:
    """Apply RoPE. x: (b, n, h, d); positions: (b, n) or (n,).

    HF LLaMA layout: rotate_half with the dim split in two contiguous
    halves (not interleaved)."""
    d = x.shape[-1]
    inv_freq = 1.0 / (theta ** (jnp.arange(0, d, 2, dtype=jnp.float32) / d))
    if positions.ndim == 1:
        positions = positions[None, :]
    freqs = positions[..., None].astype(jnp.float32) * inv_freq  # (b, n, d/2)
    cos = jnp.cos(freqs)[:, :, None, :]  # (b, n, 1, d/2)
    sin = jnp.sin(freqs)[:, :, None, :]
    x1, x2 = jnp.split(x.astype(jnp.float32), 2, axis=-1)
    out = jnp.concatenate([x1 * cos - x2 * sin, x2 * cos + x1 * sin], axis=-1)
    return out.astype(x.dtype)


class Int8Dense(nn.Module):
    """Weight-only int8 projection (frozen-LLM deployment; models/quant.py).
    Params: kernel_q (in, out) int8 + scale (out,) fp32; dequant fused into
    the matmul read by XLA."""

    features: int
    dtype: Any = jnp.bfloat16

    @nn.compact
    def __call__(self, x):
        kq = self.param("kernel_q", nn.initializers.zeros,
                        (x.shape[-1], self.features), jnp.int8)
        scale = self.param("scale", nn.initializers.ones,
                           (self.features,), jnp.float32)
        w = (kq.astype(jnp.float32) * scale).astype(self.dtype)
        return x @ w


class Int4Dense(nn.Module):
    """Weight-only NF4 projection (the bitsandbytes load_in_4bit analog,
    ChatUniVi/model/builder.py:36-47; models/quant.py quantize_kernel_nf4).
    Params: kernel_p (in/2, out) uint8 — two 4-bit codebook indices per
    byte — + absmax (in/64, out) fp32 blockwise scales; the nibble unpack
    + codebook gather + rescale is fused by XLA into the matmul read."""

    features: int
    dtype: Any = jnp.bfloat16

    @nn.compact
    def __call__(self, x):
        from open_pandora_tpu.models.quant import (NF4_BLOCK,
                                                   dequantize_kernel_nf4)
        n_in = x.shape[-1]
        kp = self.param("kernel_p", nn.initializers.zeros,
                        (n_in // 2, self.features), jnp.uint8)
        absmax = self.param("absmax", nn.initializers.ones,
                            (-(-n_in // NF4_BLOCK), self.features),
                            jnp.float32)
        return x @ dequantize_kernel_nf4(kp, absmax, dtype=self.dtype)


def _base_dense(features, quantized, dtype, name):
    """quantized: False | True/'int8' | 'nf4'."""
    if quantized == "nf4":
        return Int4Dense(features, dtype=dtype, name=name)
    if quantized:
        return Int8Dense(features, dtype=dtype, name=name)
    return nn.Dense(features, use_bias=False, dtype=dtype, name=name)


class LoRADense(nn.Module):
    """Frozen base projection + low-rank adapter: y = xW + (xA)B * α/r
    (PEFT semantics: A kaiming-init, B zero-init so the delta starts at 0;
    ChatUniVi enables it over every linear except lm_head,
    train.py:98-103,162-173, r=64 α=16). Composes with the int8 base for
    QLoRA-style finetuning. The adapter matmuls never materialize AB.
    LoRA dropout is not applied (the SFT step is deterministic)."""

    features: int
    rank: int
    alpha: float = 16.0
    dtype: Any = jnp.float32
    quantized: Any = False

    @nn.compact
    def __call__(self, x):
        base = _base_dense(self.features, self.quantized, self.dtype,
                           "base")
        a = self.param("lora_a", nn.initializers.he_uniform(),
                       (x.shape[-1], self.rank))
        b = self.param("lora_b", nn.initializers.zeros,
                       (self.rank, self.features))
        scale = self.alpha / self.rank
        delta = (x @ a.astype(self.dtype)) @ b.astype(self.dtype)
        return base(x) + delta * scale


def _proj(features, quantized, dtype, name, lora: tuple = (0, 16.0)):
    rank, alpha = lora
    if rank:
        return LoRADense(features, rank=rank, alpha=alpha, dtype=dtype,
                         quantized=quantized, name=name)
    return _base_dense(features, quantized, dtype, name)


class LlamaAttention(nn.Module):
    cfg: LLaMAConfig
    dtype: Any = jnp.float32
    quantized: Any = False

    @nn.compact
    def __call__(self, x, positions, mask=None):
        cfg = self.cfg
        b, n, _ = x.shape
        h, dh = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        lora = (cfg.lora_rank, cfg.lora_alpha)
        q = _proj(cfg.hidden_size, self.quantized, self.dtype,
                  "q_proj", lora)(x).reshape(b, n, h, dh)
        k = _proj(cfg.hidden_size, self.quantized, self.dtype,
                  "k_proj", lora)(x).reshape(b, n, h, dh)
        v = _proj(cfg.hidden_size, self.quantized, self.dtype,
                  "v_proj", lora)(x).reshape(b, n, h, dh)
        q = rotary_embed(q, positions, cfg.rope_theta)
        k = rotary_embed(k, positions, cfg.rope_theta)
        o = attention(q, k, v, causal=True, mask=mask).reshape(b, n, -1)
        return _proj(cfg.hidden_size, self.quantized, self.dtype, "o_proj",
                     lora)(o)


class LlamaMLP(nn.Module):
    cfg: LLaMAConfig
    dtype: Any = jnp.float32
    quantized: Any = False

    @nn.compact
    def __call__(self, x):
        cfg = self.cfg
        lora = (cfg.lora_rank, cfg.lora_alpha)
        gate = _proj(cfg.intermediate_size, self.quantized, self.dtype,
                     "gate_proj", lora)(x)
        up = _proj(cfg.intermediate_size, self.quantized, self.dtype,
                   "up_proj", lora)(x)
        return _proj(cfg.hidden_size, self.quantized, self.dtype,
                     "down_proj", lora)(jax.nn.silu(gate) * up)


class LlamaLayer(nn.Module):
    cfg: LLaMAConfig
    dtype: Any = jnp.float32
    quantized: Any = False

    @nn.compact
    def __call__(self, x, positions, mask=None):
        x = x + LlamaAttention(self.cfg, dtype=self.dtype,
                               quantized=self.quantized, name="self_attn")(
            RMSNorm(self.cfg.rms_norm_eps, name="input_layernorm")(x),
            positions, mask)
        x = x + LlamaMLP(self.cfg, dtype=self.dtype,
                         quantized=self.quantized, name="mlp")(
            RMSNorm(self.cfg.rms_norm_eps, name="post_attention_layernorm")(x))
        return x


class LlamaTrunk(nn.Module):
    """The bare LlamaModel (no lm_head): inputs_embeds -> hidden states."""

    cfg: LLaMAConfig
    dtype: Any = jnp.float32
    remat: bool = False
    quantized: Any = False

    @nn.compact
    def __call__(self, inputs_embeds: jnp.ndarray,
                 positions: Optional[jnp.ndarray] = None,
                 attention_mask: Optional[jnp.ndarray] = None) -> jnp.ndarray:
        cfg = self.cfg
        b, n, _ = inputs_embeds.shape
        if positions is None:
            positions = jnp.arange(n, dtype=jnp.int32)
        mask = None
        if attention_mask is not None:
            # (b, n) key padding -> (b, 1, 1, n), combined with causal inside
            mask = attention_mask[:, None, None, :].astype(bool)
        x = inputs_embeds.astype(self.dtype)
        layer_cls = nn.remat(LlamaLayer) if self.remat else LlamaLayer
        for i in range(cfg.num_layers):
            x = layer_cls(cfg, dtype=self.dtype, quantized=self.quantized,
                          name=f"layers_{i}")(x, positions, mask)
        return RMSNorm(cfg.rms_norm_eps, name="norm")(x)


class LlamaForCausalLM(nn.Module):
    """Trunk + embedding + lm_head (needed only for ChatUniVi-standalone
    generation/eval, not by the WorldModel conditioning path)."""

    cfg: LLaMAConfig
    dtype: Any = jnp.float32
    quantized: Any = False

    def setup(self):
        self.embed_tokens = nn.Embed(self.cfg.total_vocab, self.cfg.hidden_size,
                                     dtype=self.dtype, name="embed_tokens")
        self.model = LlamaTrunk(self.cfg, dtype=self.dtype,
                                quantized=self.quantized, name="model")
        self.lm_head = _proj(self.cfg.total_vocab, self.quantized,
                             self.dtype, "lm_head")

    def embed(self, token_ids: jnp.ndarray) -> jnp.ndarray:
        return self.embed_tokens(token_ids)

    def trunk(self, inputs_embeds, positions=None, attention_mask=None):
        return self.model(inputs_embeds, positions, attention_mask)

    def __call__(self, token_ids: jnp.ndarray,
                 attention_mask: Optional[jnp.ndarray] = None) -> jnp.ndarray:
        h = self.model(self.embed_tokens(token_ids),
                       attention_mask=attention_mask)
        return self.lm_head(h)
