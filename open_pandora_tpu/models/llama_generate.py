"""Autoregressive generation for the ChatUniVi LLM (KV-cache greedy/sampled
decode).

The WorldModel conditioning path never decodes (model.py:659 uses the bare
trunk), but the reference's ChatUniVi eval stack does
(ChatUniVi/eval/model_video_qa.py etc. call .generate). This implements the
decode loop for XLA: fixed-size per-layer KV cache buffers, one jitted
prefill + a lax.scan over decode steps.

Cache layout: {layer_i: {"k": (b, max_len, h, dh), "v": ...}}; positions
are absolute, RoPE applied at write time (HF semantics).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from open_pandora_tpu.core.config import LLaMAConfig
from open_pandora_tpu.models.llama import (LlamaForCausalLM, rotary_embed)
from open_pandora_tpu.ops.attention_xla import NEG_INF
from open_pandora_tpu.ops.norms import rms_norm


def _p(params, *path):
    node = params["params"]
    for k in path:
        node = node[k]
    return node


def _dense(x, leaf):
    if "kernel_q" in leaf:  # int8 weight-only layout (models/quant.py)
        w = (leaf["kernel_q"].astype(jnp.float32) * leaf["scale"]).astype(x.dtype)
        return x @ w
    if "kernel_p" in leaf:  # nf4 weight-only layout (models/quant.py)
        from open_pandora_tpu.models.quant import dequantize_kernel_nf4
        return x @ dequantize_kernel_nf4(leaf["kernel_p"], leaf["absmax"],
                                         dtype=x.dtype)
    return x @ leaf["kernel"]


def _layer_step(cfg: LLaMAConfig, lp, x, pos, cache_k, cache_v, max_len):
    """One decoder layer for ONE new position. x: (b, 1, d). Returns
    (x_out, new_k, new_v)."""
    h, dh = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    b = x.shape[0]
    y = rms_norm(x, lp["input_layernorm"]["scale"], eps=cfg.rms_norm_eps)
    q = _dense(y, lp["self_attn"]["q_proj"]).reshape(b, 1, h, dh)
    k = _dense(y, lp["self_attn"]["k_proj"]).reshape(b, 1, h, dh)
    v = _dense(y, lp["self_attn"]["v_proj"]).reshape(b, 1, h, dh)
    posb = jnp.broadcast_to(pos[None], (b, 1)) if pos.ndim == 0 else pos
    q = rotary_embed(q, posb, cfg.rope_theta)
    k = rotary_embed(k, posb, cfg.rope_theta)
    cache_k = jax.lax.dynamic_update_slice(
        cache_k, k.astype(cache_k.dtype), (0, pos.astype(jnp.int32), 0, 0))
    cache_v = jax.lax.dynamic_update_slice(
        cache_v, v.astype(cache_v.dtype), (0, pos.astype(jnp.int32), 0, 0))
    # attend over cache[0..pos]
    s = jnp.einsum("bqhd,bmhd->bhqm", q, cache_k,
                   preferred_element_type=jnp.float32) * (dh ** -0.5)
    idx = jnp.arange(max_len)
    mask = idx[None, None, None, :] <= pos
    s = jnp.where(mask, s, NEG_INF)
    p = jax.nn.softmax(s, axis=-1)
    o = jnp.einsum("bhqm,bmhd->bqhd", p.astype(cache_v.dtype), cache_v,
                   preferred_element_type=jnp.float32)
    o = o.reshape(b, 1, cfg.hidden_size).astype(x.dtype)
    x = x + _dense(o, lp["self_attn"]["o_proj"])
    y = rms_norm(x, lp["post_attention_layernorm"]["scale"],
                 eps=cfg.rms_norm_eps)
    gate = _dense(y, lp["mlp"]["gate_proj"])
    up = _dense(y, lp["mlp"]["up_proj"])
    x = x + _dense(jax.nn.silu(gate) * up, lp["mlp"]["down_proj"])
    return x, cache_k, cache_v


def prefill_cache(model: LlamaForCausalLM, params, inputs_embeds,
                  max_len: int) -> Tuple[jnp.ndarray, Dict]:
    """Run the trunk over the prompt while recording K/V per layer.

    Returns (last_hidden (b, d), cache). Uses the module for the forward
    (identical math) and recomputes K/V from layer inputs via the params —
    one extra pass of cheap projections, no module surgery."""
    cfg = model.cfg
    b, L, d = inputs_embeds.shape
    h, dh = cfg.num_heads, d // cfg.num_heads
    positions = jnp.arange(L, dtype=jnp.int32)

    # capture per-layer inputs with a manual forward (mirrors LlamaTrunk)
    x = inputs_embeds
    cache = {}
    mp = _p(params, "model")
    for i in range(cfg.num_layers):
        lp = mp[f"layers_{i}"]
        y = rms_norm(x, lp["input_layernorm"]["scale"], eps=cfg.rms_norm_eps)
        q = _dense(y, lp["self_attn"]["q_proj"]).reshape(b, L, h, dh)
        k = _dense(y, lp["self_attn"]["k_proj"]).reshape(b, L, h, dh)
        v = _dense(y, lp["self_attn"]["v_proj"]).reshape(b, L, h, dh)
        q = rotary_embed(q, positions, cfg.rope_theta)
        k = rotary_embed(k, positions, cfg.rope_theta)
        from open_pandora_tpu.ops.attention import attention
        o = attention(q, k, v, causal=True).reshape(b, L, d)
        x = x + _dense(o, lp["self_attn"]["o_proj"])
        y2 = rms_norm(x, lp["post_attention_layernorm"]["scale"],
                      eps=cfg.rms_norm_eps)
        gate = _dense(y2, lp["mlp"]["gate_proj"])
        up = _dense(y2, lp["mlp"]["up_proj"])
        x = x + _dense(jax.nn.silu(gate) * up, lp["mlp"]["down_proj"])
        pad = max_len - L
        cache[f"layers_{i}"] = {
            "k": jnp.pad(k, ((0, 0), (0, pad), (0, 0), (0, 0))),
            "v": jnp.pad(v, ((0, 0), (0, pad), (0, 0), (0, 0))),
        }
    x = rms_norm(x, mp["norm"]["scale"], eps=cfg.rms_norm_eps)
    return x[:, -1], cache


def first_token_logits(model: LlamaForCausalLM, params,
                       inputs_embeds: jnp.ndarray) -> jnp.ndarray:
    """(b, vocab) logits for the token that would follow the prompt.

    The reference's scienceqa runner generates with output_scores=True and
    reads scores[0][0] — the pre-softmax logits of the FIRST generated
    token — to score the candidate answer letters
    (ChatUniVi/eval/model_vqa_scienceqa.py:101-125)."""
    last_hidden, _ = prefill_cache(model, params, inputs_embeds,
                                   inputs_embeds.shape[1])
    return _dense(last_hidden, _p(params, "lm_head"))


def greedy_generate(
    model: LlamaForCausalLM,
    params,
    inputs_embeds: jnp.ndarray,
    max_new_tokens: int = 64,
    eos_token_id: int = 2,
    temperature: float = 0.0,
    key: Optional[jax.Array] = None,
) -> jnp.ndarray:
    """-> (b, max_new_tokens) int32 token ids (eos-padded after stop)."""
    cfg = model.cfg
    b, L, _ = inputs_embeds.shape
    max_len = L + max_new_tokens
    last_hidden, cache = prefill_cache(model, params, inputs_embeds, max_len)
    lm_head = _p(params, "lm_head")
    embed = _p(params, "embed_tokens")["embedding"]
    mp = _p(params, "model")

    first_logits = _dense(last_hidden, lm_head)
    first_tok = jnp.argmax(first_logits, axis=-1).astype(jnp.int32)

    def step(carry, i):
        tok, cache, done = carry
        pos = L + i
        x = embed[tok][:, None, :]  # (b, 1, d)
        new_cache = {}
        for li in range(cfg.num_layers):
            lk = f"layers_{li}"
            x, ck, cv = _layer_step(cfg, mp[lk], x, jnp.asarray(pos),
                                    cache[lk]["k"], cache[lk]["v"], max_len)
            new_cache[lk] = {"k": ck, "v": cv}
        hnorm = rms_norm(x[:, 0], mp["norm"]["scale"], eps=cfg.rms_norm_eps)
        logits = _dense(hnorm, lm_head)
        if temperature > 0.0 and key is not None:
            nk = jax.random.fold_in(key, i)
            nxt = jax.random.categorical(nk, logits / temperature, axis=-1)
        else:
            nxt = jnp.argmax(logits, axis=-1)
        nxt = nxt.astype(jnp.int32)
        done = jnp.logical_or(done, tok == eos_token_id)
        nxt = jnp.where(done, eos_token_id, nxt)
        return (nxt, new_cache, done), tok

    init = (first_tok, cache, jnp.zeros((b,), bool))
    (_, _, _), toks = jax.lax.scan(step, init, jnp.arange(max_new_tokens))
    return jnp.swapaxes(toks, 0, 1)  # (b, n)
