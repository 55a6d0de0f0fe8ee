"""Explicit dtype policy.

The reference mixes bf16 schedule buffers (ddpm3d.py:139), fp32 DDIM recasts
(ddim.py:27-29), bf16 timestep-frequency math (utils_diffusion.py:20) and
autocast regions (trainer.py:90). Here precision is a single explicit policy:

  - params:   storage dtype of weights
  - compute:  matmul/conv input dtype (bf16 by default)
  - accum:    reductions/softmax/schedule dtype (always fp32)

`golden_fp32_policy()` is the strict-parity mode used by the fp32
frame-for-frame acceptance config (BASELINE.md config 1).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp


@dataclass(frozen=True)
class DTypePolicy:
    param_dtype: jnp.dtype
    compute_dtype: jnp.dtype
    accum_dtype: jnp.dtype = jnp.float32

    def cast_compute(self, x):
        return x.astype(self.compute_dtype) if x.dtype != self.compute_dtype else x

    def cast_accum(self, x):
        return x.astype(self.accum_dtype) if x.dtype != self.accum_dtype else x


def default_policy() -> DTypePolicy:
    return DTypePolicy(param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16)


def golden_fp32_policy() -> DTypePolicy:
    return DTypePolicy(param_dtype=jnp.float32, compute_dtype=jnp.float32)


def policy_from_name(name: str) -> DTypePolicy:
    if name in ("bf16", "bfloat16", "mixed"):
        return default_policy()
    if name in ("fp32", "float32", "golden"):
        return golden_fp32_policy()
    raise ValueError(f"unknown dtype policy {name!r}")
