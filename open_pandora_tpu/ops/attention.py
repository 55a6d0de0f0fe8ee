"""The attention dispatcher: the one place that picks an implementation.

`choose_implementation` is a pure function of (platform, dtype, mask,
shape), so the rule is testable without a GPU:

  - "cudnn": cuDNN's fused flash attention through
    `jax.nn.dot_product_attention(implementation="cudnn")`. Taken on the
    GPU for bf16/fp16 inputs without an arbitrary mask, head dim <= 128
    and a multiple of 8, once the score matrix has at least
    CUDNN_MIN_SCORES entries per (batch, head).
  - "xla": `mha_xla`, the plain fp32-softmax attention that XLA fuses.
    Everything else: the CPU, float32 (the golden path), masked LLaMA
    prefill, and short sequences such as the t=16 temporal attention,
    where cuDNN's per-tile overhead loses to XLA's fused softmax.

Timed on one H100 (PERF.md, "Attention routes"): at the 320x512 spatial
self-attention (N=2560) cuDNN takes a sixth of XLA's time; at N=M=16
temporal attention and at N=M=160 XLA is faster.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from open_pandora_tpu.ops.attention_xla import mha_xla

# Smallest N*M (queries x keys) routed to cuDNN: between the 160x160
# spatial site (XLA faster) and the 2560x77 text cross-attention (cuDNN
# faster) of the 320x512 UNet eval.
CUDNN_MIN_SCORES = 256 * 256


def choose_implementation(platform: str, dtype, q_shape: Sequence[int],
                          k_shape: Sequence[int], *, causal: bool,
                          has_mask: bool) -> str:
    """'cudnn' or 'xla' for q (B, N, H, D) against k (B, M, H, D).

    cuDNN aligns a causal mask to the first keys, so causal attention with
    M != N (queries aligned to the last keys) stays on XLA."""
    _, n, _, d = q_shape
    m = k_shape[1]
    if (platform == "gpu"
            and jnp.dtype(dtype) in (jnp.dtype(jnp.bfloat16),
                                     jnp.dtype(jnp.float16))
            and not has_mask
            and not (causal and n != m)
            and d <= 128 and d % 8 == 0
            and n * m >= CUDNN_MIN_SCORES):
        return "cudnn"
    return "xla"


def attention(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    *,
    causal: bool = False,
    mask: Optional[jnp.ndarray] = None,
    sm_scale: Optional[float] = None,
) -> jnp.ndarray:
    """Multi-head attention, q (B, N, H, D), k/v (B, M, H, D) -> (B, N, H, D).

    mask: boolean, broadcastable to (B, H, N, M), True = attend. With
    `causal` and M > N the queries align to the last N keys.

    Under an active `parallel.sp.sequence_parallel(mesh, axis)` context,
    eligible causal self-attention (LLaMA prefill) is ring-sharded over
    the mesh axis instead (sequence-parallel long-context path).
    """
    from open_pandora_tpu.parallel.sp import (current_sp, ring_attention,
                                              sp_eligible)
    if sp_eligible(q.shape, k.shape, causal, mask):
        mesh, axis = current_sp()
        return ring_attention(q, k, v, mesh=mesh, axis=axis,
                              sm_scale=sm_scale, causal=True)
    impl = choose_implementation(jax.default_backend(), q.dtype, q.shape,
                                 k.shape, causal=causal,
                                 has_mask=mask is not None)
    if impl == "cudnn":
        return jax.nn.dot_product_attention(
            q, k, v, scale=sm_scale, is_causal=causal,
            implementation="cudnn")
    return mha_xla(q, k, v, causal=causal, mask=mask, sm_scale=sm_scale)
