"""EMA shadow parameters (reference LitEma, lvdm/ema.py:5-75).

The reference keeps torch-buffer shadow copies with decay 0.9999 and a
warmup ramp `min(decay, (1 + updates) / (10 + updates))`; shipped configs
have `use_ema: False` but the capability is part of the DynamiCrafter
training surface (ddpm3d.py ema_scope). JAX form: the shadow tree
is an extra field on the TrainState, updated functionally inside the
jitted step — no buffers, no copy-to/restore context manager needed
(sampling with EMA weights is just passing `state.ema`)."""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp


def ema_init(params: Any) -> Any:
    """Shadow starts as an fp32 copy of the trainable params (ema.py:15-22).

    fp32 regardless of param dtype: with bf16 params the (1-0.9999)-scale
    delta would round to zero on a bf16 shadow and the EMA would freeze
    after warmup. Cast to the param dtype only at the point of use
    (sampling with `state.ema`)."""
    return jax.tree_util.tree_map(lambda p: jnp.asarray(p, jnp.float32), params)


def ema_decay_for_step(step: jnp.ndarray, decay: float = 0.9999,
                       warmup: bool = True) -> jnp.ndarray:
    """ema.py:29-35: decay ramps in as (1+n)/(10+n), capped at `decay`."""
    n = step.astype(jnp.float32)
    ramp = (1.0 + n) / (10.0 + n)
    return jnp.minimum(jnp.asarray(decay, jnp.float32), ramp) if warmup \
        else jnp.asarray(decay, jnp.float32)


def ema_update(shadow: Any, params: Any, step: jnp.ndarray,
               decay: float = 0.9999, warmup: bool = True) -> Any:
    """One EMA step: s <- s - (1-d) * (s - p) (ema.py:37-52), computed in
    fp32 regardless of param dtype so tiny updates don't vanish in bf16."""
    d = ema_decay_for_step(step, decay, warmup)

    def upd(s, p):
        s32 = s.astype(jnp.float32)
        out = s32 - (1.0 - d) * (s32 - p.astype(jnp.float32))
        return out.astype(s.dtype)

    return jax.tree_util.tree_map(upd, shadow, params)
