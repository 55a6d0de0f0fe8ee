"""Alternative conditioning encoders — the reference's non-shipped encoder
set (DynamiCrafter lvdm/modules/encoders/condition.py:29-176, 384-399):

  ClassEmbedder            condition.py:29-53   class-conditional embedding
                           with unconditional-guidance dropout to the extra
                           "ucg" class (n_classes - 1)
  T5Encoder                condition.py:62-91   FrozenT5Embedder — T5 v1.1
                           encoder last_hidden_state over max-length-padded
                           token ids (the reference passes NO attention
                           mask, so pads are attended; reproduced)
  HFCLIPTextEncoder        condition.py:94-138  FrozenCLIPEmbedder — the
                           huggingface CLIPTextModel with quick-GELU MLPs
                           and last / pooled / hidden layer select
  PooledCLIPImageEncoder   condition.py:141-176 ClipImageEmbedder — pooled
                           (cls-token) CLIP image embedding with CLIP
                           preprocessing and whole-sample ucg dropout
  CLIPT5Pair               condition.py:384-399 FrozenCLIPT5Encoder — the
                           [clip_z, t5_z] pair

None are used by the shipped Open-Pandora checkpoint (the live text/image
conditioners are the OpenCLIP pair in models/encoders.py); they complete
the encoder surface so every `target:` the reference yaml grammar can name
has a JAX equivalent. Tokenization is a host concern — all text
encoders take token ids (`pipeline/clip_bpe.py` covers CLIP; T5 ids come
from any sentencepiece host tokenizer).

Weight conversion from the torch checkpoints lives next to the modules
(convert_t5_encoder / convert_hf_clip_text); cross-implementation parity
vs transformers' T5EncoderModel / CLIPTextModel is machine-checked in
tests/test_encoders_extra.py.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp

from open_pandora_tpu.core import nn
from open_pandora_tpu.core.config import CLIPTextConfig, T5Config
from open_pandora_tpu.models.encoders import LayerNorm, clip_preprocess
from open_pandora_tpu.ops.attention import attention


# ---------------------------------------------------------------------------
# ClassEmbedder (condition.py:29-53)
# ---------------------------------------------------------------------------

class ClassEmbedder(nn.Module):
    """Class-conditional crossattn embedding. Labels (b,) int ->
    (b, 1, embed_dim). With ucg_rate > 0 and a PRNG key, each label is
    replaced by the unconditional class (n_classes - 1) with prob ucg_rate
    (the reference reserves the last class for ucg, condition.py:49-52)."""

    embed_dim: int
    n_classes: int = 1000
    ucg_rate: float = 0.1

    @nn.compact
    def __call__(self, labels: jnp.ndarray, *,
                 key: Optional[jax.Array] = None,
                 disable_dropout: bool = False) -> jnp.ndarray:
        table = self.param("embedding", nn.initializers.normal(0.02),
                           (self.n_classes, self.embed_dim))
        if self.ucg_rate > 0.0 and not disable_dropout:
            if key is None:
                raise ValueError("ucg dropout needs a PRNG key")
            drop = jax.random.bernoulli(key, self.ucg_rate, labels.shape)
            labels = jnp.where(drop, self.n_classes - 1, labels)
        return table[labels][:, None, :]

    def unconditional_labels(self, batch: int) -> jnp.ndarray:
        return jnp.full((batch,), self.n_classes - 1, jnp.int32)


# ---------------------------------------------------------------------------
# T5 v1.1 encoder (condition.py:62-91)
# ---------------------------------------------------------------------------

def _rms_norm(x: jnp.ndarray, w: jnp.ndarray, eps: float) -> jnp.ndarray:
    """T5LayerNorm: no mean subtraction, fp32 variance, no bias."""
    xf = x.astype(jnp.float32)
    var = jnp.mean(xf * xf, axis=-1, keepdims=True)
    return (w * (xf * jax.lax.rsqrt(var + eps)).astype(x.dtype))


def _relative_position_bucket(rel: jnp.ndarray, num_buckets: int,
                              max_distance: int) -> jnp.ndarray:
    """Bidirectional bucket map (HF modeling_t5._relative_position_bucket
    with bidirectional=True): half the buckets for each sign, log-spaced
    beyond num_buckets//4 exact positions."""
    num_buckets //= 2
    ret = (rel > 0).astype(jnp.int32) * num_buckets
    n = jnp.abs(rel)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    large = max_exact + (
        jnp.log(n.astype(jnp.float32) / max_exact + 1e-9)
        / jnp.log(max_distance / max_exact)
        * (num_buckets - max_exact)).astype(jnp.int32)
    large = jnp.minimum(large, num_buckets - 1)
    return ret + jnp.where(is_small, n, large)


class _T5Attention(nn.Module):
    cfg: T5Config
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, pos_bias):
        cfg = self.cfg
        b, n, _ = x.shape
        inner = cfg.num_heads * cfg.d_kv
        dense = lambda name: nn.Dense(inner, use_bias=False,
                                      dtype=self.dtype, name=name)
        q = dense("q")(x).reshape(b, n, cfg.num_heads, cfg.d_kv)
        k = dense("k")(x).reshape(b, n, cfg.num_heads, cfg.d_kv)
        v = dense("v")(x).reshape(b, n, cfg.num_heads, cfg.d_kv)
        # T5 quirk: NO 1/sqrt(d) score scaling; additive position bias.
        s = jnp.einsum("bnhd,bmhd->bhnm", q.astype(jnp.float32),
                       k.astype(jnp.float32))
        s = s + pos_bias.astype(jnp.float32)
        p = jax.nn.softmax(s, axis=-1).astype(v.dtype)
        o = jnp.einsum("bhnm,bmhd->bnhd", p, v).reshape(b, n, inner)
        return nn.Dense(self.cfg.d_model, use_bias=False, dtype=self.dtype,
                        name="o")(o)


class T5Encoder(nn.Module):
    """T5 v1.1 encoder stack -> last_hidden_state (b, n, d_model).

    Reproduces FrozenT5Embedder(condition.py:62-91)'s exact behavior:
    token ids padded to max_length, no attention mask (pads attended),
    shared relative-position bias from block 0, gated-GELU v1.1 FF,
    RMS norms, final_layer_norm. Eval only (dropout 0)."""

    cfg: T5Config
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, token_ids: jnp.ndarray) -> jnp.ndarray:
        cfg = self.cfg
        n = token_ids.shape[1]
        emb = self.param("shared_embedding", nn.initializers.normal(1.0),
                         (cfg.vocab_size, cfg.d_model))
        x = emb[token_ids].astype(self.dtype)

        # relative position bias, computed once, shared by every layer
        # (has_relative_attention_bias only on encoder block 0)
        rel_table = self.param(
            "relative_attention_bias", nn.initializers.normal(1.0),
            (cfg.relative_buckets, cfg.num_heads))
        pos = jnp.arange(n)
        rel = pos[None, :] - pos[:, None]          # memory - query
        bucket = _relative_position_bucket(
            rel, cfg.relative_buckets, cfg.relative_max_distance)
        pos_bias = rel_table[bucket]               # (n, n, heads)
        pos_bias = jnp.transpose(pos_bias, (2, 0, 1))[None]  # (1, h, n, n)

        for i in range(cfg.num_layers):
            w0 = self.param(f"block_{i}_ln0", nn.initializers.ones,
                            (cfg.d_model,))
            h = _rms_norm(x, w0, cfg.layer_norm_eps)
            x = x + _T5Attention(cfg, dtype=self.dtype,
                                 name=f"block_{i}_attn")(h, pos_bias)
            w1 = self.param(f"block_{i}_ln1", nn.initializers.ones,
                            (cfg.d_model,))
            h = _rms_norm(x, w1, cfg.layer_norm_eps)
            # v1.1 gated-GELU FF (DenseGatedActDense, gelu_new)
            g = nn.Dense(cfg.d_ff, use_bias=False, dtype=self.dtype,
                         name=f"block_{i}_wi0")(h)
            u = nn.Dense(cfg.d_ff, use_bias=False, dtype=self.dtype,
                         name=f"block_{i}_wi1")(h)
            h = jax.nn.gelu(g, approximate=True) * u
            x = x + nn.Dense(cfg.d_model, use_bias=False, dtype=self.dtype,
                             name=f"block_{i}_wo")(h)

        wf = self.param("final_ln", nn.initializers.ones, (cfg.d_model,))
        return _rms_norm(x, wf, cfg.layer_norm_eps)


def convert_t5_encoder(state: dict, cfg: T5Config) -> dict:
    """transformers T5EncoderModel state_dict -> T5Encoder params."""
    import numpy as np

    def t(name):
        return jnp.asarray(np.asarray(state[name].detach().cpu().numpy()
                           if hasattr(state[name], "detach")
                           else state[name]))

    p: dict = {"shared_embedding": t("shared.weight"),
               "relative_attention_bias": t(
                   "encoder.block.0.layer.0.SelfAttention"
                   ".relative_attention_bias.weight"),
               "final_ln": t("encoder.final_layer_norm.weight")}
    for i in range(cfg.num_layers):
        pre = f"encoder.block.{i}.layer"
        p[f"block_{i}_ln0"] = t(f"{pre}.0.layer_norm.weight")
        p[f"block_{i}_ln1"] = t(f"{pre}.1.layer_norm.weight")
        p[f"block_{i}_attn"] = {
            nm: {"kernel": t(f"{pre}.0.SelfAttention.{nm}.weight").T}
            for nm in ("q", "k", "v", "o")}
        p[f"block_{i}_wi0"] = {
            "kernel": t(f"{pre}.1.DenseReluDense.wi_0.weight").T}
        p[f"block_{i}_wi1"] = {
            "kernel": t(f"{pre}.1.DenseReluDense.wi_1.weight").T}
        p[f"block_{i}_wo"] = {
            "kernel": t(f"{pre}.1.DenseReluDense.wo.weight").T}
    return {"params": p}


# ---------------------------------------------------------------------------
# huggingface CLIP text encoder (condition.py:94-138)
# ---------------------------------------------------------------------------

def _quick_gelu(x: jnp.ndarray) -> jnp.ndarray:
    return x * jax.nn.sigmoid(1.702 * x)


class _HFCLIPBlock(nn.Module):
    heads: int
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x):
        b, n, d = x.shape
        dh = d // self.heads
        y = LayerNorm(name="ln_1")(x)
        mk = lambda name: nn.Dense(d, dtype=self.dtype, name=name)
        q = mk("q_proj")(y).reshape(b, n, self.heads, dh)
        k = mk("k_proj")(y).reshape(b, n, self.heads, dh)
        v = mk("v_proj")(y).reshape(b, n, self.heads, dh)
        o = attention(q, k, v, causal=True).reshape(b, n, d)
        x = x + mk("out_proj")(o)
        y = LayerNorm(name="ln_2")(x)
        y = nn.Dense(4 * d, dtype=self.dtype, name="mlp_fc1")(y)
        y = _quick_gelu(y)
        return x + nn.Dense(d, dtype=self.dtype, name="mlp_fc2")(y)


class HFCLIPTextEncoder(nn.Module):
    """FrozenCLIPEmbedder (condition.py:94-138): huggingface CLIPTextModel
    (quick-GELU MLPs, learned positions) with the reference's layer select:
    'last' -> final_layer_norm output; 'pooled' -> eos-token row of the
    final output, (b, 1, d); 'hidden' -> hidden_states[layer_idx]
    (embeddings = index 0, pre-final-LN block outputs after)."""

    cfg: CLIPTextConfig
    layer: str = "last"
    layer_idx: Optional[int] = None
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, token_ids: jnp.ndarray) -> jnp.ndarray:
        cfg = self.cfg
        assert self.layer in ("last", "pooled", "hidden")
        emb = self.param("token_embedding", nn.initializers.normal(0.02),
                         (cfg.vocab_size, cfg.width))
        pos = self.param("position_embedding", nn.initializers.normal(0.01),
                         (cfg.context_length, cfg.width))
        n = token_ids.shape[1]
        x = emb[token_ids].astype(self.dtype) + pos[:n].astype(self.dtype)
        hidden = [x]
        for i in range(cfg.layers):
            x = _HFCLIPBlock(heads=cfg.heads, dtype=self.dtype,
                             name=f"layers_{i}")(x)
            hidden.append(x)
        if self.layer == "hidden":
            idx = self.layer_idx
            assert idx is not None
            return hidden[idx if idx >= 0 else len(hidden) + idx]
        z = LayerNorm(name="ln_final")(x)
        if self.layer == "pooled":
            # CLIP pooling: the eos position = argmax token id per row
            eos = jnp.argmax(token_ids, axis=-1)
            return z[jnp.arange(z.shape[0]), eos][:, None, :]
        return z


def convert_hf_clip_text(state: dict, cfg: CLIPTextConfig) -> dict:
    """transformers CLIPTextModel state_dict -> HFCLIPTextEncoder params."""
    import numpy as np

    def t(name):
        a = state[name]
        return jnp.asarray(np.asarray(a.detach().cpu().numpy()
                                      if hasattr(a, "detach") else a))

    base = "text_model."
    p: dict = {
        "token_embedding": t(base + "embeddings.token_embedding.weight"),
        "position_embedding": t(
            base + "embeddings.position_embedding.weight"),
        "ln_final": {"scale": t(base + "final_layer_norm.weight"),
                     "bias": t(base + "final_layer_norm.bias")},
    }
    for i in range(cfg.layers):
        pre = f"{base}encoder.layers.{i}."
        blk = {
            "ln_1": {"scale": t(pre + "layer_norm1.weight"),
                     "bias": t(pre + "layer_norm1.bias")},
            "ln_2": {"scale": t(pre + "layer_norm2.weight"),
                     "bias": t(pre + "layer_norm2.bias")},
            "mlp_fc1": {"kernel": t(pre + "mlp.fc1.weight").T,
                        "bias": t(pre + "mlp.fc1.bias")},
            "mlp_fc2": {"kernel": t(pre + "mlp.fc2.weight").T,
                        "bias": t(pre + "mlp.fc2.bias")},
        }
        for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
            blk[nm] = {"kernel": t(pre + f"self_attn.{nm}.weight").T,
                       "bias": t(pre + f"self_attn.{nm}.bias")}
        p[f"layers_{i}"] = blk
    return {"params": p}


# ---------------------------------------------------------------------------
# pooled CLIP image embedder (condition.py:141-176)
# ---------------------------------------------------------------------------

class PooledCLIPImageEncoder(nn.Module):
    """ClipImageEmbedder equivalent on the open_clip-layout visual tower:
    CLIP preprocess of [-1, 1] images, transformer, ln_post on the cls
    token, projection -> (b, output_dim); optional whole-sample ucg
    zeroing (condition.py:170-174)."""

    cfg: Any  # CLIPVisionConfig
    output_dim: int = 1024
    ucg_rate: float = 0.0
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, images: jnp.ndarray, *,
                 key: Optional[jax.Array] = None,
                 no_dropout: bool = False) -> jnp.ndarray:
        from open_pandora_tpu.models.encoders import CLIPVisionEncoder

        x = clip_preprocess((images + 1.0) / 2.0, size=self.cfg.image_size)
        tokens = CLIPVisionEncoder(self.cfg, dtype=self.dtype,
                                   name="visual")(x)
        cls = LayerNorm(name="ln_post")(tokens[:, 0])
        proj = self.param("proj", nn.initializers.normal(0.02),
                          (cls.shape[-1], self.output_dim))
        out = cls @ proj.astype(cls.dtype)
        if self.ucg_rate > 0.0 and not no_dropout:
            if key is None:
                raise ValueError("ucg dropout needs a PRNG key")
            keep = jax.random.bernoulli(key, 1.0 - self.ucg_rate,
                                        (out.shape[0], 1))
            out = out * keep.astype(out.dtype)
        return out


class CLIPT5Pair(nn.Module):
    """FrozenCLIPT5Encoder (condition.py:384-399): [clip_z, t5_z]."""

    clip_cfg: CLIPTextConfig
    t5_cfg: T5Config
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, clip_ids: jnp.ndarray, t5_ids: jnp.ndarray):
        return [HFCLIPTextEncoder(self.clip_cfg, dtype=self.dtype,
                                  name="clip")(clip_ids),
                T5Encoder(self.t5_cfg, dtype=self.dtype, name="t5")(t5_ids)]
