"""Normalization primitives with fp32 statistics.

Behavioral spec:
  - UNet GroupNorm(32), eps 1e-5, stats in fp32 regardless of input dtype
    (reference lvdm/basics.py:76-88 GroupNormSpecific casts to float)
  - VAE / transformer GroupNorm(32) eps 1e-6 (ae_modules.py:16,
    attention.py:265,330)
  - LayerNorm eps 1e-5 (torch default, transformer blocks attention.py:244)
  - RMSNorm eps 1e-6 for LLaMA (HF LlamaRMSNorm)

All are channel-last: x (..., C). XLA fuses the normalize+affine+SiLU
chain into its neighbours.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp


def group_norm(
    x: jnp.ndarray,
    scale: jnp.ndarray,
    bias: jnp.ndarray,
    *,
    num_groups: int = 32,
    eps: float = 1e-5,
    silu: bool = False,
) -> jnp.ndarray:
    """GroupNorm over channel-last x (..., C); optional fused SiLU."""
    orig_dtype = x.dtype
    c = x.shape[-1]
    xf = x.astype(jnp.float32).reshape(*x.shape[:-1], num_groups, c // num_groups)
    # stats over all spatial dims + within-group channels
    red_axes = tuple(range(1, xf.ndim - 2)) + (xf.ndim - 1,)
    mean = jnp.mean(xf, axis=red_axes, keepdims=True)
    var = jnp.mean(jnp.square(xf - mean), axis=red_axes, keepdims=True)
    xf = (xf - mean) / jnp.sqrt(var + eps)
    xf = xf.reshape(x.shape)
    out = xf * scale.astype(jnp.float32) + bias.astype(jnp.float32)
    if silu:
        out = out * jnp.reciprocal(1.0 + jnp.exp(-out))
    return out.astype(orig_dtype)


def layer_norm(
    x: jnp.ndarray,
    scale: Optional[jnp.ndarray],
    bias: Optional[jnp.ndarray],
    *,
    eps: float = 1e-5,
) -> jnp.ndarray:
    orig_dtype = x.dtype
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(xf - mean), axis=-1, keepdims=True)
    out = (xf - mean) / jnp.sqrt(var + eps)
    if scale is not None:
        out = out * scale.astype(jnp.float32)
    if bias is not None:
        out = out + bias.astype(jnp.float32)
    return out.astype(orig_dtype)


def rms_norm(x: jnp.ndarray, scale: jnp.ndarray, *, eps: float = 1e-6) -> jnp.ndarray:
    """LLaMA RMSNorm (HF semantics: fp32 variance, scale applied after the
    cast back)."""
    orig_dtype = x.dtype
    xf = x.astype(jnp.float32)
    var = jnp.mean(jnp.square(xf), axis=-1, keepdims=True)
    out = (xf / jnp.sqrt(var + eps)).astype(orig_dtype)
    return out * scale
