"""DynamiCrafter UNet3D — NHWC implementation on the `core.nn` module layer.

Behavioral spec: /root/reference/DynamiCrafter/lvdm/modules/networks/
openaimodel3d.py (UNetModel :284, ResBlock :112, TemporalConvBlock :242,
Up/Downsample :51-108, forward :552-607) and lvdm/modules/attention.py
(CrossAttention :42 incl. dual text/image KV streams :89-144,
BasicTransformerBlock :212, SpatialTransformer :249, TemporalTransformer :313,
GEGLU feed-forward :412-437).

Shipped config (configs/inference_512_v1.0.yaml): 320ch, mult (1,2,4,4),
2 res blocks/level, attn at ds 1/2/4, head_dim 64, context 1024, use_linear,
temporal conv+attention (self-only, no relative position), addition_attention
(init temporal attn), image cross-attention (non-learnable scale), fps cond.

Design:
  - NHWC; spatial stream is (b*t, h, w, c), temporal stream (b*h*w, t, c)
  - every attention goes through the ops.attention dispatcher
  - the reference's hardcoded `77 + t*16` context split
    (openaimodel3d.py:558-567) is config: text_context_len /
    img_tokens_per_frame
  - fp32 GroupNorm/softmax statistics; params/compute dtype via policy
  - gradient checkpointing = nn.remat over transformer/res blocks when
    cfg.use_checkpoint (the reference's checkpoint wrapper common.py:81-94)
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from open_pandora_tpu.core import flags, nn
from open_pandora_tpu.core.config import UNet3DConfig
from open_pandora_tpu.diffusion.schedule import timestep_embedding
from open_pandora_tpu.ops.attention import attention
from open_pandora_tpu.ops.norms import group_norm, layer_norm


class GroupNorm32(nn.Module):
    """GN(32) with fp32 stats. eps 1e-5 in ResBlocks (torch default,
    basics.py:76-88), 1e-6 in transformer pre-norms (attention.py:265,330)."""

    eps: float = 1e-5

    @nn.compact
    def __call__(self, x, silu: bool = False):
        c = x.shape[-1]
        scale = self.param("scale", nn.initializers.ones, (c,))
        bias = self.param("bias", nn.initializers.zeros, (c,))
        return group_norm(x, scale, bias, num_groups=32, eps=self.eps,
                          silu=silu)


class LayerNorm(nn.Module):
    eps: float = 1e-5

    @nn.compact
    def __call__(self, x):
        c = x.shape[-1]
        scale = self.param("scale", nn.initializers.ones, (c,))
        bias = self.param("bias", nn.initializers.zeros, (c,))
        return layer_norm(x, scale, bias, eps=self.eps)


def zeros_init():
    return nn.initializers.zeros


class CrossAttention(nn.Module):
    """attention.py:42-144. context=None -> self-attention. With
    image_cross_attention and a context, the context is split into
    [text (text_len tokens) | image (rest)], each with its own KV
    projection; outputs are summed with an optional learnable tanh gate
    (attention.py:138-142)."""

    heads: int
    dim_head: int
    context_dim: Optional[int] = None
    image_cross_attention: bool = False
    image_ca_scale_learnable: bool = False
    text_context_len: int = 77
    dropout: float = 0.0
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, context=None, deterministic: bool = True, mask=None):
        inner = self.heads * self.dim_head
        q = nn.Dense(inner, use_bias=False, dtype=self.dtype, name="to_q")(x)
        self_attn = context is None
        ctx = x if self_attn else context

        b, n, _ = x.shape
        qh = q.reshape(b, n, self.heads, self.dim_head)

        if self.image_cross_attention and not self_attn:
            ctx_text = ctx[:, : self.text_context_len]
            ctx_img = ctx[:, self.text_context_len:]
            k = nn.Dense(inner, use_bias=False, dtype=self.dtype, name="to_k")(ctx_text)
            v = nn.Dense(inner, use_bias=False, dtype=self.dtype, name="to_v")(ctx_text)
            k_ip = nn.Dense(inner, use_bias=False, dtype=self.dtype, name="to_k_ip")(ctx_img)
            v_ip = nn.Dense(inner, use_bias=False, dtype=self.dtype, name="to_v_ip")(ctx_img)
            m = ctx_text.shape[1]
            mi = ctx_img.shape[1]
            gate = jnp.ones((), self.dtype)
            if self.image_ca_scale_learnable:
                alpha = self.param("alpha", nn.initializers.zeros, ())
                gate = jnp.tanh(alpha) + 1.0
            out = attention(qh, k.reshape(b, m, self.heads, self.dim_head),
                            v.reshape(b, m, self.heads, self.dim_head))
            out_ip = attention(
                qh, k_ip.reshape(b, mi, self.heads, self.dim_head),
                v_ip.reshape(b, mi, self.heads, self.dim_head))
            out = (out + gate * out_ip.astype(out.dtype)).reshape(b, n, inner)
        else:
            if not self_attn:
                ctx = ctx[:, : self.text_context_len]
            m = ctx.shape[1]
            k = nn.Dense(inner, use_bias=False, dtype=self.dtype, name="to_k")(ctx)
            v = nn.Dense(inner, use_bias=False, dtype=self.dtype, name="to_v")(ctx)
            out = attention(qh, k.reshape(b, m, self.heads, self.dim_head),
                            v.reshape(b, m, self.heads, self.dim_head),
                            mask=mask).reshape(b, n, inner)

        out = nn.Dense(x.shape[-1], dtype=self.dtype, name="to_out_0")(out)
        out = nn.Dropout(self.dropout, deterministic=deterministic)(out)
        return out


class FeedForward(nn.Module):
    """GEGLU FF (attention.py:412-437): Dense(2*4d) -> gelu-gate -> Dense(d).

    At 576x1024 the temporal-site FF intermediate is (9216, 16, 2*4*1280) =
    1.5G elements, the biggest temporary of the training backward. When
    the intermediate exceeds the threshold the leading token axis is
    processed in chunks sharing one set of Dense params; remat then
    recomputes per chunk, bounding live activations."""

    mult: int = 4
    dropout: float = 0.0
    dtype: Any = jnp.float32

    # elements of the GEGLU intermediate above which chunking kicks in
    # (256M elems = 512 MB bf16); chunks target <= 128M elems each
    CHUNK_THRESHOLD = 256 * 2 ** 20
    CHUNK_TARGET = 128 * 2 ** 20

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        d = x.shape[-1]
        inner = d * self.mult
        proj_in = nn.Dense(inner * 2, dtype=self.dtype, name="net_0_proj")
        proj_out = nn.Dense(d, dtype=self.dtype, name="net_2")

        def ff(chunk):
            h = proj_in(chunk)
            h, gate = jnp.split(h, 2, axis=-1)
            h = h * jax.nn.gelu(gate, approximate=False)  # torch F.gelu: erf
            h = nn.Dropout(self.dropout, deterministic=deterministic)(h)
            return proj_out(h)

        import math
        n = x.shape[0]
        elems = math.prod(x.shape[:-1]) * inner * 2
        if elems <= self.CHUNK_THRESHOLD:
            return ff(x)
        chunks = 2
        while elems // chunks > self.CHUNK_TARGET and (
                n % (chunks * 2) == 0):
            chunks *= 2
        if n % chunks:
            return ff(x)
        step = n // chunks
        return jnp.concatenate(
            [ff(x[i * step:(i + 1) * step]) for i in range(chunks)], axis=0)


class BasicTransformerBlock(nn.Module):
    """pre-LN self-attn -> cross-attn -> GEGLU FF (attention.py:212-246)."""

    heads: int
    dim_head: int
    context_dim: Optional[int] = None
    image_cross_attention: bool = False
    image_ca_scale_learnable: bool = False
    text_context_len: int = 77
    dropout: float = 0.0
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, context=None, deterministic: bool = True,
                 self_mask=None):
        attn_cls = CrossAttention
        fine_remat = flags.flag("PANDORA_FINE_REMAT") and not deterministic
        if fine_remat:
            # nested remat for memory-critical training (576x1024):
            # checkpoint each attention/FF separately so one block's
            # backward never materializes attn1 + attn2 + FF temporaries
            # together
            attn_cls = nn.remat(CrossAttention, static_argnums=(3,))
        x = x + attn_cls(
            heads=self.heads, dim_head=self.dim_head, dropout=self.dropout,
            dtype=self.dtype, name="attn1",
        )(LayerNorm(name="norm1")(x), None, deterministic, self_mask)
        x = x + attn_cls(
            heads=self.heads, dim_head=self.dim_head,
            context_dim=self.context_dim,
            image_cross_attention=self.image_cross_attention,
            image_ca_scale_learnable=self.image_ca_scale_learnable,
            text_context_len=self.text_context_len,
            dropout=self.dropout, dtype=self.dtype, name="attn2",
        )(LayerNorm(name="norm2")(x), context, deterministic)
        # context=None -> CrossAttention self-attends on the NORMED
        # input (attention.py:243-244 passes norm2(x) and CrossAttention
        # defaults context to it) — not on the raw residual stream.
        ff_cls = (nn.remat(FeedForward, static_argnums=(2,)) if fine_remat
                  else FeedForward)
        x = x + ff_cls(dropout=self.dropout, dtype=self.dtype, name="ff")(
            LayerNorm(name="norm3")(x), deterministic)
        return x


class SpatialTransformer(nn.Module):
    """attention.py:249-310 with use_linear=True (shipped config)."""

    heads: int
    dim_head: int
    depth: int = 1
    context_dim: Optional[int] = None
    image_cross_attention: bool = False
    image_ca_scale_learnable: bool = False
    text_context_len: int = 77
    dropout: float = 0.0
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, context=None, deterministic: bool = True):
        # x: (bt, h, w, c)
        bt, h, w, c = x.shape
        inner = self.heads * self.dim_head
        x_in = x
        y = GroupNorm32(eps=1e-6, name="norm")(x)
        y = y.reshape(bt, h * w, c)
        y = nn.Dense(inner, dtype=self.dtype, name="proj_in")(y)
        for d in range(self.depth):
            y = BasicTransformerBlock(
                heads=self.heads, dim_head=self.dim_head,
                context_dim=self.context_dim,
                image_cross_attention=self.image_cross_attention,
                image_ca_scale_learnable=self.image_ca_scale_learnable,
                text_context_len=self.text_context_len,
                dropout=self.dropout, dtype=self.dtype,
                name=f"transformer_blocks_{d}",
            )(y, context, deterministic)
        y = nn.Dense(c, kernel_init=nn.initializers.zeros, dtype=self.dtype,
                     name="proj_out")(y)
        return x_in + y.reshape(bt, h, w, c)


class TemporalTransformer(nn.Module):
    """attention.py:313-410, only_self_att=True path: self-attention over the
    t axis, batched over b*h*w; use_linear projections; optional causal mask."""

    heads: int
    dim_head: int
    depth: int = 1
    causal: bool = False
    dropout: float = 0.0
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        # x: (b, t, h, w, c)
        b, t, h, w, c = x.shape
        inner = self.heads * self.dim_head
        x_in = x
        y = GroupNorm32(eps=1e-6, name="norm")(x)
        # (b, h, w, t, c) -> (b*h*w, t, c)
        y = y.transpose(0, 2, 3, 1, 4).reshape(b * h * w, t, c)
        y = nn.Dense(inner, dtype=self.dtype, name="proj_in")(y)
        mask = None
        if self.causal:
            row = jax.lax.broadcasted_iota(jnp.int32, (t, t), 0)
            col = jax.lax.broadcasted_iota(jnp.int32, (t, t), 1)
            mask = (col <= row)[None, None]  # (1, 1, t, t)
        for d in range(self.depth):
            y = BasicTransformerBlock(
                heads=self.heads, dim_head=self.dim_head,
                dropout=self.dropout, dtype=self.dtype,
                name=f"transformer_blocks_{d}",
            )(y, None, deterministic, self_mask=mask)
        y = nn.Dense(c, kernel_init=nn.initializers.zeros, dtype=self.dtype,
                     name="proj_out")(y)
        y = y.reshape(b, h, w, t, c).transpose(0, 3, 1, 2, 4)
        return x_in + y


def _conv3x3(features, name, dtype, zero=False):
    """Stride-1 same-pad 3x3 spatial conv (cuDNN through lax.conv)."""
    return nn.Conv(features, (3, 3), padding=1,
                   kernel_init=(nn.initializers.zeros if zero
                                else nn.initializers.lecun_normal()),
                   dtype=dtype, name=name)


class _TConv3(nn.Module):
    """k=(3,1,1) temporal conv as three shifted t-axis matmuls.

    Param tree is identical to nn.Conv's ({kernel: (3,1,1,cin,cout),
    bias: (cout,)}), so checkpoints are interchangeable with the Conv3D
    twin that PANDORA_DISABLE_TCONV_DOT selects. The three dots over the
    padded t axis keep the (b, t, h, w, c) layout; which form is faster on
    the GPU is not measured yet."""

    features: int
    zero: bool = False
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x):
        c_in = x.shape[-1]
        kernel = self.param(
            "kernel",
            nn.initializers.zeros if self.zero
            else nn.initializers.lecun_normal(),
            (3, 1, 1, c_in, self.features))
        bias = self.param("bias", nn.initializers.zeros, (self.features,))
        w = jnp.asarray(kernel, self.dtype)[:, 0, 0]  # (3, cin, cout)
        t = x.shape[1]
        xp = jnp.pad(x, ((0, 0), (1, 1), (0, 0), (0, 0), (0, 0)))
        y = (xp[:, :t] @ w[0] + xp[:, 1:t + 1] @ w[1]
             + xp[:, 2:t + 2] @ w[2])
        return y + jnp.asarray(bias, y.dtype)


class TemporalConvBlock(nn.Module):
    """4x (GN + SiLU + Conv3d k=(3,1,1)) residual, zero-init final conv
    (openaimodel3d.py:242-281). x: (b, t, h, w, c)."""

    dropout: float = 0.1
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        c = x.shape[-1]
        use_dot = not flags.flag("PANDORA_DISABLE_TCONV_DOT")

        def conv3(name, zero=False):
            if use_dot:
                return _TConv3(features=c, zero=zero, dtype=self.dtype,
                               name=name)
            return nn.Conv(
                c, (3, 1, 1), padding=((1, 1), (0, 0), (0, 0)),
                kernel_init=nn.initializers.zeros if zero
                else nn.initializers.lecun_normal(),
                bias_init=nn.initializers.zeros,
                dtype=self.dtype, name=name)

        ident = x
        h = GroupNorm32(name="conv1_norm")(x, silu=True)
        h = conv3("conv1")(h)
        for i, zero in ((2, False), (3, False), (4, True)):
            h = GroupNorm32(name=f"conv{i}_norm")(h, silu=True)
            h = nn.Dropout(self.dropout, deterministic=deterministic)(h)
            h = conv3(f"conv{i}", zero)(h)
        return ident + h


class ResBlock(nn.Module):
    """openaimodel3d.py:112-240: GN+SiLU+conv, +emb, GN+SiLU+drop+zeroconv,
    skip; optional temporal conv afterwards. x: (bt, h, w, c), emb: (bt, e)."""

    out_ch: int
    use_temporal_conv: bool = False
    dropout: float = 0.0
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, emb, batch_size: int, deterministic: bool = True):
        in_ch = x.shape[-1]
        h = GroupNorm32(name="in_norm")(x, silu=True)
        h = _conv3x3(self.out_ch, "in_conv", self.dtype)(h)
        e = nn.Dense(self.out_ch, dtype=self.dtype, name="emb_layers_1")(
            jax.nn.silu(emb))
        h = h + e[:, None, None, :].astype(h.dtype)
        h = GroupNorm32(name="out_norm")(h, silu=True)
        h = nn.Dropout(self.dropout, deterministic=deterministic)(h)
        h = _conv3x3(self.out_ch, "out_conv", self.dtype, zero=True)(h)
        if in_ch != self.out_ch:
            x = nn.Conv(self.out_ch, (1, 1), dtype=self.dtype,
                        name="skip_connection")(x)
        h = x + h
        if self.use_temporal_conv:
            bt, hh, ww, c = h.shape
            t = bt // batch_size
            hv = h.reshape(batch_size, t, hh, ww, c)
            hv = TemporalConvBlock(dropout=0.1, dtype=self.dtype,
                                   name="temporal_conv")(hv, deterministic)
            h = hv.reshape(bt, hh, ww, c)
        return h


class Downsample(nn.Module):
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x):
        return nn.Conv(x.shape[-1], (3, 3), strides=2, padding=1,
                       dtype=self.dtype, name="op")(x)


class Upsample(nn.Module):
    """Nearest 2x (computed fp32, openaimodel3d.py:100-106) + conv."""

    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x):
        b, h, w, c = x.shape
        dt = x.dtype
        y = jax.image.resize(x.astype(jnp.float32), (b, h * 2, w * 2, c),
                             method="nearest").astype(dt)
        return _conv3x3(c, "conv", self.dtype)(y)


class UNetModel(nn.Module):
    """The full UNet3D (openaimodel3d.py:284-607)."""

    cfg: UNet3DConfig
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(
        self,
        x: jnp.ndarray,            # (b, t, h, w, c_in)  latent+concat-cond
        timesteps: jnp.ndarray,    # (b,)
        context: jnp.ndarray,      # (b, L, context_dim)
        fs: Optional[jnp.ndarray] = None,  # (b,) frame-stride/fps cond
        deterministic: bool = True,
    ) -> jnp.ndarray:
        cfg = self.cfg
        b, t, hh, ww, _ = x.shape
        mc = cfg.model_channels
        time_embed_dim = mc * 4

        t_emb = timestep_embedding(timesteps, mc).astype(self.dtype)
        emb = nn.Dense(time_embed_dim, dtype=self.dtype, name="time_embed_0")(t_emb)
        emb = nn.Dense(time_embed_dim, dtype=self.dtype, name="time_embed_2")(
            jax.nn.silu(emb))

        if cfg.fs_condition:
            if fs is None:
                fs = jnp.full((b,), cfg.default_fs, dtype=jnp.int32)
            fs_emb = timestep_embedding(fs, mc).astype(self.dtype)
            fse = nn.Dense(time_embed_dim, dtype=self.dtype,
                           name="fps_embedding_0")(fs_emb)
            fse = nn.Dense(time_embed_dim, kernel_init=nn.initializers.zeros,
                           dtype=self.dtype, name="fps_embedding_2")(
                jax.nn.silu(fse))
            emb = emb + fse

        # context split: [text | per-frame image tokens]
        L = context.shape[1]
        per_frame_ctx = cfg.text_context_len + t * cfg.img_tokens_per_frame
        if L == per_frame_ctx:
            ctx_text = context[:, : cfg.text_context_len]
            ctx_img = context[:, cfg.text_context_len:]
            ctx_text = jnp.repeat(ctx_text, t, axis=0)  # (b*t, 77, d)
            ctx_img = ctx_img.reshape(b * t, cfg.img_tokens_per_frame, -1)
            ctx = jnp.concatenate([ctx_text, ctx_img], axis=1)
        else:
            ctx = jnp.repeat(context, t, axis=0)
        emb_bt = jnp.repeat(emb, t, axis=0)  # (b*t, e)

        h = x.reshape(b * t, hh, ww, x.shape[-1]).astype(self.dtype)

        # gradient checkpointing over res/transformer blocks during training
        # (reference checkpoint wrapper common.py:81-94, use_checkpoint: True)
        use_remat = cfg.use_checkpoint and not deterministic
        res_cls = nn.remat(ResBlock, static_argnums=(3, 4)) if use_remat \
            else ResBlock
        spatial_cls = nn.remat(SpatialTransformer, static_argnums=(3,)) \
            if use_remat else SpatialTransformer
        temporal_cls = nn.remat(TemporalTransformer, static_argnums=(2,)) \
            if use_remat else TemporalTransformer

        def make_res(out_ch, name):
            return res_cls(out_ch=out_ch, use_temporal_conv=cfg.temporal_conv,
                           dropout=cfg.dropout, dtype=self.dtype, name=name)

        def make_spatial(ch, name):
            heads = ch // cfg.num_head_channels
            return spatial_cls(
                heads=heads, dim_head=cfg.num_head_channels,
                depth=cfg.transformer_depth, context_dim=cfg.context_dim,
                image_cross_attention=cfg.image_cross_attention,
                image_ca_scale_learnable=cfg.image_cross_attention_scale_learnable,
                text_context_len=cfg.text_context_len,
                dropout=cfg.dropout, dtype=self.dtype, name=name)

        def make_temporal(ch, name, heads=None):
            heads = heads if heads is not None else ch // cfg.num_head_channels
            return temporal_cls(
                heads=heads, dim_head=cfg.num_head_channels,
                depth=cfg.transformer_depth, causal=cfg.use_causal_attention,
                dropout=cfg.dropout, dtype=self.dtype, name=name)

        def temporal_apply(h, mod):
            bt, sh, sw, c = h.shape
            hv = h.reshape(b, t, sh, sw, c)
            return mod(hv, deterministic).reshape(bt, sh, sw, c)

        # ---- input blocks ----
        h = _conv3x3(mc, "input_blocks_0_0", self.dtype)(h)
        if cfg.addition_attention:
            h = temporal_apply(h, make_temporal(mc, "init_attn", heads=8))
        hs = [h]
        ch = mc
        ds = 1
        block_idx = 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                h = make_res(mult * mc, f"input_blocks_{block_idx}_0")(
                    h, emb_bt, b, deterministic)
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    h = make_spatial(ch, f"input_blocks_{block_idx}_1")(
                        h, ctx, deterministic)
                    if cfg.temporal_attention:
                        h = temporal_apply(
                            h, make_temporal(ch, f"input_blocks_{block_idx}_2"))
                hs.append(h)
                block_idx += 1
            if level != len(cfg.channel_mult) - 1:
                h = Downsample(dtype=self.dtype,
                               name=f"input_blocks_{block_idx}_0")(h)
                hs.append(h)
                block_idx += 1
                ds *= 2

        # ---- middle ----
        h = make_res(ch, "middle_block_0")(h, emb_bt, b, deterministic)
        h = make_spatial(ch, "middle_block_1")(h, ctx, deterministic)
        if cfg.temporal_attention:
            h = temporal_apply(h, make_temporal(ch, "middle_block_2"))
        h = make_res(ch, "middle_block_3")(h, emb_bt, b, deterministic)

        # ---- output blocks ----
        block_idx = 0
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                skip = hs.pop()
                h = jnp.concatenate([h, skip], axis=-1)
                h = make_res(mult * mc, f"output_blocks_{block_idx}_0")(
                    h, emb_bt, b, deterministic)
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    h = make_spatial(ch, f"output_blocks_{block_idx}_1")(
                        h, ctx, deterministic)
                    if cfg.temporal_attention:
                        h = temporal_apply(
                            h, make_temporal(ch, f"output_blocks_{block_idx}_2"))
                if level and i == cfg.num_res_blocks:
                    h = Upsample(dtype=self.dtype,
                                 name=f"output_blocks_{block_idx}_up")(h)
                    ds //= 2
                block_idx += 1

        h = GroupNorm32(name="out_norm")(h, silu=True)
        y = nn.Conv(cfg.out_channels, (3, 3), padding=1,
                    kernel_init=nn.initializers.zeros, dtype=self.dtype,
                    name="out_conv")(h)
        y = y.reshape(b, t, hh, ww, cfg.out_channels)
        return y.astype(x.dtype)
