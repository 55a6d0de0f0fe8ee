"""SD 2D autoencoder (AutoencoderKL) — NHWC implementation on `core.nn`.

Behavioral spec: /root/reference/DynamiCrafter/lvdm/models/autoencoder.py:14-130
and lvdm/modules/networks/ae_modules.py (Encoder :364, Decoder :466,
ResnetBlock :151, AttnBlock :26, Downsample :90 with asymmetric (0,1,0,1)
padding, Upsample :111 nearest-2x). Posterior: lvdm/distributions.py:24-65
(logvar clamped to [-30, 20]).

Differences from the reference:
  - NHWC layout end-to-end (the converter transposes torch OIHW kernels to
    HWIO)
  - GroupNorm statistics in fp32 via ops.norms regardless of compute dtype
  - the reference's per-frame Python loop (`perframe_ae`, ddpm3d.py:614-628)
    becomes `lax.map` over frame chunks in encode_video/decode_video —
    bounded memory, single compiled loop body
  - the mid-block attention goes through the ops.attention dispatcher

Module/param names mirror the torch state-dict keys (down.0.block.1.norm1
-> down_0/block_1/norm1) so weight conversion is a mechanical rename.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from open_pandora_tpu.core import nn
from open_pandora_tpu.core.config import VAEConfig
from open_pandora_tpu.ops.attention import attention
from open_pandora_tpu.ops.norms import group_norm


class GroupNorm(nn.Module):
    """GN32 with torch parameter names (scale/bias as weight-like leaves)."""

    eps: float = 1e-6

    @nn.compact
    def __call__(self, x, silu: bool = False):
        c = x.shape[-1]
        scale = self.param("scale", nn.initializers.ones, (c,))
        bias = self.param("bias", nn.initializers.zeros, (c,))
        return group_norm(x, scale, bias, num_groups=32, eps=self.eps,
                          silu=silu)


def swish(x):
    return x * jax.nn.sigmoid(x)


class ResnetBlock(nn.Module):
    """ae_modules.py:151-209 (no temb path — VAE never uses it)."""

    out_ch: int
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x):
        in_ch = x.shape[-1]
        h = GroupNorm(name="norm1")(x, silu=True)
        h = nn.Conv(self.out_ch, (3, 3), padding=1, dtype=self.dtype, name="conv1")(h)
        h = GroupNorm(name="norm2")(h, silu=True)
        h = nn.Conv(self.out_ch, (3, 3), padding=1, dtype=self.dtype, name="conv2")(h)
        if in_ch != self.out_ch:
            x = nn.Conv(self.out_ch, (1, 1), dtype=self.dtype, name="nin_shortcut")(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head h*w self-attention (ae_modules.py:26-78)."""

    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x):
        b, hh, ww, c = x.shape
        h = GroupNorm(name="norm")(x)
        q = nn.Conv(c, (1, 1), dtype=self.dtype, name="q")(h)
        k = nn.Conv(c, (1, 1), dtype=self.dtype, name="k")(h)
        v = nn.Conv(c, (1, 1), dtype=self.dtype, name="v")(h)
        # (b, n, 1 head, c)
        q = q.reshape(b, hh * ww, 1, c)
        k = k.reshape(b, hh * ww, 1, c)
        v = v.reshape(b, hh * ww, 1, c)
        out = attention(q, k, v).reshape(b, hh, ww, c)
        out = nn.Conv(c, (1, 1), dtype=self.dtype, name="proj_out")(out)
        return x + out


class Downsample(nn.Module):
    """Stride-2 conv with asymmetric (0,1,0,1) padding (ae_modules.py:90-108)."""

    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x):
        c = x.shape[-1]
        x = jnp.pad(x, ((0, 0), (0, 1), (0, 1), (0, 0)))
        return nn.Conv(c, (3, 3), strides=2, padding="VALID", dtype=self.dtype,
                       name="conv")(x)


class Upsample(nn.Module):
    """Nearest-neighbor 2x + conv (ae_modules.py:111-127)."""

    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x):
        b, h, w, c = x.shape
        x = jax.image.resize(x, (b, h * 2, w * 2, c), method="nearest")
        return nn.Conv(c, (3, 3), padding=1, dtype=self.dtype, name="conv")(x)


class Encoder(nn.Module):
    """ae_modules.py:364-463."""

    cfg: VAEConfig
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x):
        cfg = self.cfg
        h = nn.Conv(cfg.base_channels, (3, 3), padding=1, dtype=self.dtype,
                    name="conv_in")(x)
        for i, mult in enumerate(cfg.channel_mult):
            out_ch = cfg.base_channels * mult
            for j in range(cfg.num_res_blocks):
                h = ResnetBlock(out_ch, dtype=self.dtype,
                                name=f"down_{i}_block_{j}")(h)
            if i != len(cfg.channel_mult) - 1:
                h = Downsample(dtype=self.dtype, name=f"down_{i}_downsample")(h)
        h = ResnetBlock(h.shape[-1], dtype=self.dtype, name="mid_block_1")(h)
        h = AttnBlock(dtype=self.dtype, name="mid_attn_1")(h)
        h = ResnetBlock(h.shape[-1], dtype=self.dtype, name="mid_block_2")(h)
        h = GroupNorm(name="norm_out")(h, silu=True)
        z_out = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        return nn.Conv(z_out, (3, 3), padding=1, dtype=self.dtype,
                       name="conv_out")(h)


class Decoder(nn.Module):
    """ae_modules.py:466-569."""

    cfg: VAEConfig
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, z):
        cfg = self.cfg
        block_in = cfg.base_channels * cfg.channel_mult[-1]
        h = nn.Conv(block_in, (3, 3), padding=1, dtype=self.dtype,
                    name="conv_in")(z)
        h = ResnetBlock(block_in, dtype=self.dtype, name="mid_block_1")(h)
        h = AttnBlock(dtype=self.dtype, name="mid_attn_1")(h)
        h = ResnetBlock(block_in, dtype=self.dtype, name="mid_block_2")(h)
        for i in reversed(range(len(cfg.channel_mult))):
            out_ch = cfg.base_channels * cfg.channel_mult[i]
            for j in range(cfg.num_res_blocks + 1):
                h = ResnetBlock(out_ch, dtype=self.dtype,
                                name=f"up_{i}_block_{j}")(h)
            if i != 0:
                h = Upsample(dtype=self.dtype, name=f"up_{i}_upsample")(h)
        h = GroupNorm(name="norm_out")(h, silu=True)
        return nn.Conv(cfg.out_channels, (3, 3), padding=1, dtype=self.dtype,
                       name="conv_out")(h)


@dataclass
class DiagonalGaussian:
    """lvdm/distributions.py:24-65."""

    mean: jnp.ndarray
    logvar: jnp.ndarray

    @classmethod
    def from_params(cls, moments: jnp.ndarray) -> "DiagonalGaussian":
        mean, logvar = jnp.split(moments, 2, axis=-1)
        return cls(mean=mean, logvar=jnp.clip(logvar, -30.0, 20.0))

    def sample(self, key: jax.Array) -> jnp.ndarray:
        std = jnp.exp(0.5 * self.logvar)
        return self.mean + std * jax.random.normal(key, self.mean.shape,
                                                   dtype=self.mean.dtype)

    def mode(self) -> jnp.ndarray:
        return self.mean

    def kl(self) -> jnp.ndarray:
        return 0.5 * jnp.sum(
            jnp.square(self.mean) + jnp.exp(self.logvar) - 1.0 - self.logvar,
            axis=tuple(range(1, self.mean.ndim)),
        )


class AutoencoderKL(nn.Module):
    """autoencoder.py:14-130: encoder + quant convs + decoder."""

    cfg: VAEConfig
    dtype: Any = jnp.float32

    def setup(self):
        self.encoder = Encoder(self.cfg, dtype=self.dtype, name="encoder")
        self.decoder = Decoder(self.cfg, dtype=self.dtype, name="decoder")
        self.quant_conv = nn.Conv(2 * self.cfg.embed_dim if self.cfg.double_z
                                  else self.cfg.embed_dim,
                                  (1, 1), dtype=self.dtype, name="quant_conv")
        self.post_quant_conv = nn.Conv(self.cfg.z_channels, (1, 1),
                                       dtype=self.dtype, name="post_quant_conv")

    def encode(self, x: jnp.ndarray) -> DiagonalGaussian:
        moments = self.quant_conv(self.encoder(x))
        return DiagonalGaussian.from_params(moments)

    def decode(self, z: jnp.ndarray) -> jnp.ndarray:
        return self.decoder(self.post_quant_conv(z))

    def __call__(self, x, key: Optional[jax.Array] = None, sample: bool = False):
        posterior = self.encode(x)
        z = posterior.sample(key) if sample else posterior.mode()
        return self.decode(z), posterior


# ---------------------------------------------------------------------------
# video (frame-mapped) wrappers — the reference's perframe_ae loop
# (ddpm3d.py:614-628, 638-647) as lax.map over frame chunks
# ---------------------------------------------------------------------------


def encode_video(
    model: AutoencoderKL,
    params,
    video: jnp.ndarray,
    *,
    scale_factor: float = 0.18215,
    frame_chunk: int = 1,
    key: Optional[jax.Array] = None,
) -> jnp.ndarray:
    """video (b, t, h, w, c) -> latents (b, t, h/8, w/8, z) * scale.

    The reference ALWAYS samples the posterior (get_first_stage_encoding,
    ddpm3d.py:595-602) with untracked torch RNG; pass `key` to reproduce
    that, or None for the deterministic mode() latent (bit-stable
    conditioning — a deliberate, documented improvement).
    """
    b, t, h, w, c = video.shape

    def enc(frames):  # (b*fc, h, w, c) -> raw moments
        post = model.apply(params, frames, method=AutoencoderKL.encode)
        return jnp.concatenate([post.mean, post.logvar], axis=-1)

    chunks = t // frame_chunk if t % frame_chunk == 0 else t
    fc = frame_chunk if t % frame_chunk == 0 else 1
    x = video.reshape(b, chunks, fc, h, w, c).swapaxes(0, 1)
    m = jax.lax.map(lambda fr: enc(fr.reshape(b * fc, h, w, c)), x)
    hz, wz = m.shape[-3], m.shape[-2]
    m = m.reshape(chunks, b, fc, hz, wz, -1).swapaxes(0, 1)
    m = m.reshape(b, t, hz, wz, -1)
    post = DiagonalGaussian.from_params(m)
    z = post.mode() if key is None else post.sample(key)
    return z * scale_factor


def decode_video(
    model: AutoencoderKL,
    params,
    z: jnp.ndarray,
    *,
    scale_factor: float = 0.18215,
    frame_chunk: int = 1,
) -> jnp.ndarray:
    """latents (b, t, h', w', z) -> video (b, t, 8h', 8w', 3)."""
    b, t, h, w, zc = z.shape
    z = z / scale_factor

    def dec(frames):
        return model.apply(params, frames, method=AutoencoderKL.decode)

    chunks = t // frame_chunk if t % frame_chunk == 0 else t
    fc = frame_chunk if t % frame_chunk == 0 else 1
    x = z.reshape(b, chunks, fc, h, w, zc).swapaxes(0, 1)
    out = jax.lax.map(lambda fr: dec(fr.reshape(b * fc, h, w, zc)), x)
    ho, wo = out.shape[-3], out.shape[-2]
    out = out.reshape(chunks, b, fc, ho, wo, -1).swapaxes(0, 1)
    return out.reshape(b, t, ho, wo, -1)
