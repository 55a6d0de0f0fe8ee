"""Sequence-parallel ring attention over a device mesh.

The reference has NO sequence/context parallelism (SURVEY §2.7: its answer
to long sequences is algorithmic — clustering, factorized attention,
per-frame VAE). This module adds the real thing as a new JAX
capability: the attention sequence axis is sharded over a mesh axis, each
device computes flash attention against its local KV shard, and KV shards
rotate around the ring with `jax.lax.ppermute` (neighbor exchange)
while partial outputs merge with online-softmax (log-sum-exp) algebra.
Memory per device is O(seq/n) and the KV transfer overlaps compute — the
standard blockwise-ring recipe, expressed with shard_map + collectives
rather than hand-written RDMA.

Use case: 576x1024 spatial self-attention (9216 tokens x 16 frames) sharded
4-8 ways, or any future resolution where a single device's attention
memory or FLOPs bound the step. Non-causal and causal (global-index masks;
the LLaMA prefill path below)."""

from __future__ import annotations

import functools
from contextlib import contextmanager
from typing import Optional

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P


_MASKED = -1e30  # finite big-negative: a fully-masked block yields a
# finite lse ~ _MASKED whose merge weight underflows to exactly 0 — no
# -inf/-inf NaNs in the online-softmax algebra.


def _attn_with_lse(q, k, v, sm_scale: Optional[float] = None, mask=None):
    """(B, N, H, D) x (B, M, H, D) -> (out (B,N,H,D), lse (B,N,H)).
    fp32 softmax statistics (matches ops.attention_xla). `mask` is an
    optional (N, M) bool (True = attend) broadcast over batch/heads."""
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    s = jnp.einsum("bnhd,bmhd->bhnm", q, k,
                   preferred_element_type=jnp.float32) * scale
    if mask is not None:
        s = jnp.where(mask[None, None], s, _MASKED)
    m = jnp.max(s, axis=-1, keepdims=True)
    p = jnp.exp(s - m)
    l = jnp.sum(p, axis=-1, keepdims=True)
    o = jnp.einsum("bhnm,bmhd->bnhd", (p / l).astype(v.dtype), v,
                   preferred_element_type=jnp.float32).astype(q.dtype)
    lse = (m + jnp.log(l))[..., 0]              # (B, H, N)
    return o, jnp.transpose(lse, (0, 2, 1))     # lse -> (B, N, H)


def _merge(o_a, l_a, o_b, l_b):
    """Online-softmax merge of two attention partials."""
    l_new = jnp.logaddexp(l_a, l_b)
    w_a = jnp.exp(l_a - l_new)[..., None].astype(o_a.dtype)
    w_b = jnp.exp(l_b - l_new)[..., None].astype(o_b.dtype)
    return o_a * w_a + o_b * w_b, l_new


def ring_attention(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    *,
    mesh,
    axis: str = "data",
    sm_scale: Optional[float] = None,
    causal: bool = False,
) -> jnp.ndarray:
    """Self-attention with the SEQUENCE axis sharded over `axis` of `mesh`.

    q/k/v: (B, N, H, D) global arrays (N divisible by the axis size).
    Returns the exact (up to fp reassociation) full-attention result with
    per-device memory O(N/n) — each ring step attends the local q shard to
    a rotating KV shard and merges via log-sum-exp.

    causal=True applies the global-index causal mask (LLM prefill): each
    ring step reconstructs the KV shard's global offset from the rotation
    count and masks q_global >= k_global. Blocks strictly above the
    diagonal still circulate (simple ring; a zigzag schedule would skip
    them) but contribute zero weight via the finite `_MASKED` fill."""
    n_dev = mesh.shape[axis]
    assert q.shape[1] % n_dev == 0, (
        f"sequence {q.shape[1]} not divisible by mesh axis {axis}={n_dev}")
    n_local = q.shape[1] // n_dev
    perm = [(j, (j + 1) % n_dev) for j in range(n_dev)]

    def local_fn(q_l, k_l, v_l):
        me = jax.lax.axis_index(axis)
        iota_q = jnp.arange(n_local)

        def blk_mask(step):
            # after `step` rotations this device holds the KV shard that
            # started on device (me - step) mod n_dev
            src = (me - step) % n_dev
            qg = me * n_local + iota_q[:, None]
            kg = src * n_local + iota_q[None, :]
            return qg >= kg

        o, lse = _attn_with_lse(q_l, k_l, v_l, sm_scale,
                                blk_mask(0) if causal else None)

        def body(i, carry):
            k_c, v_c, o_a, l_a = carry
            k_c = jax.lax.ppermute(k_c, axis, perm)
            v_c = jax.lax.ppermute(v_c, axis, perm)
            o_i, l_i = _attn_with_lse(q_l, k_c, v_c, sm_scale,
                                      blk_mask(i + 1) if causal else None)
            o_m, l_m = _merge(o_a, l_a, o_i, l_i)
            return k_c, v_c, o_m, l_m

        _, _, o, lse = jax.lax.fori_loop(0, n_dev - 1, body,
                                         (k_l, v_l, o, lse))
        return o

    spec = P(None, axis, None, None)
    return shard_map(local_fn, mesh=mesh, in_specs=(spec, spec, spec),
                     out_specs=spec)(q, k, v)


# ------------------------------------------------------------- wiring
# Trace-time SP context: while active, ops.attention routes eligible
# causal self-attention (LLaMA prefill) through ring_attention over the
# given mesh axis. The UNet side is deliberately NOT wired: a conv UNet
# would need halo exchange around every conv to sequence-shard
# activations, and the zero-comm stream/frame sharding
# (parallel/sharded_infer.py) dominates at every product shape — see
# PERF.md. The LLM side is where sequence actually grows (multi-round
# <image>x16 histories, reference model.py:1055).

_SP_STACK: list = []


@contextmanager
def sequence_parallel(mesh, axis: str = "data"):
    """Route causal prefill attention through the ring while tracing."""
    _SP_STACK.append((mesh, axis))
    try:
        yield
    finally:
        _SP_STACK.pop()


def current_sp() -> Optional[tuple]:
    return _SP_STACK[-1] if _SP_STACK else None


def sp_eligible(q_shape, k_shape, causal: bool, mask) -> bool:
    """Ring-route only clean causal self-attention whose sequence divides
    the mesh axis (prefill; decode steps have N=1 and never qualify)."""
    ctx = current_sp()
    if ctx is None or not causal or mask is not None:
        return False
    mesh, axis = ctx
    n_dev = mesh.shape[axis]
    return (q_shape[1] == k_shape[1] and q_shape[1] % n_dev == 0
            and q_shape[1] // n_dev >= 8)


def sp_llama_prefill(model, params, inputs_embeds, *, mesh,
                     axis: str = "data"):
    """LLaMA trunk forward with every layer's causal self-attention ring-
    sharded over `axis` (sequence-parallel long-context prefill). Returns
    (b, n, hidden) final hidden states; numerics match the single-device
    trunk up to fp reassociation."""
    import jax as _jax

    def fwd(p, e):
        with sequence_parallel(mesh, axis):
            return model.apply(p, e, method=type(model).trunk)

    emb_spec = _jax.sharding.NamedSharding(mesh, P(None, axis, None))
    return _jax.jit(fwd, in_shardings=(None, emb_spec))(params,
                                                        inputs_embeds)
