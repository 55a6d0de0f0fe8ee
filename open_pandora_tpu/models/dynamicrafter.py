"""DynamiCrafter latent video diffusion — the composite image+text->video
model (UNet3D + VAE + OpenCLIP text/image + Resampler) with DDIM sampling.

Behavioral spec:
  - LatentVisualDiffusion: /root/reference/DynamiCrafter/lvdm/models/
    ddpm3d.py:456-1057 (scale_factor 0.18215, dynamic rescale, hybrid
    conditioning key: channel-concat c_concat + cross-attn context,
    DiffusionWrapper :1060-1081)
  - image_guided_synthesis: /root/reference/model.py:703-781 (image context
    via embedder+Resampler, cond latent z tiled to temporal_length, "" +
    zero-image unconditional, 2-way CFG, DDIM)
  - get_latent_z tiling: model.py:690-701 (t=1 -> x16, t=4 -> tile x4)

Design: everything here is functional over a params pytree; sampling is
the lax.scan DDIM from diffusion/ddim.py with batched CFG (one UNet call per
step). PRNG is explicit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from open_pandora_tpu.core.config import PandoraConfig
from open_pandora_tpu.diffusion.ddim import (ddim_sample, make_cfg_model_fn,
                                             make_ddim_schedule)
from open_pandora_tpu.diffusion.schedule import DiffusionSchedule, make_schedule
from open_pandora_tpu.models.encoders import (CLIPTextEncoder,
                                              CLIPVisionEncoder, Resampler,
                                              clip_preprocess,
                                              empty_prompt_tokens)
from open_pandora_tpu.models.unet3d import UNetModel
from open_pandora_tpu.models.vae import AutoencoderKL, decode_video, encode_video


def random_params(model, seed: int = 0, dtype=None,
                  zero_std: Optional[float] = None) -> Dict[str, Any]:
    """Random weights from the model's own initializers, for runs without a
    checkpoint. `model` is a DynamiCrafter or a WorldModel.

    Made op by op, not in one jitted program: jitted initializers of the
    full model did not finish compiling in 25 minutes on an H100 machine,
    with threefry keys for the whole WorldModel in one program, nor in 10
    minutes with RngBitGenerator keys for the DynamiCrafter's five parts
    compiled side by side (PERF.md). The dummy inputs are 64x64, as
    parameter shapes do not depend on the spatial size. Float32 leaves are
    cast to `dtype` one at a time, so each float32 copy is freed as the
    next is cast. With `zero_std`, zero-initialised float leaves (out
    convs, proj_outs) become noise of that std, so that an eval depends on
    every layer."""
    params = model.init_params(jax.random.PRNGKey(seed), height=64, width=64)
    leaves, tree = jax.tree_util.tree_flatten(params)
    del params
    noise = jax.random.PRNGKey(seed + 1)
    for i, p in enumerate(leaves):
        if (zero_std and jnp.issubdtype(p.dtype, jnp.floating)
                and not bool(jnp.any(p != 0))):
            p = zero_std * jax.random.normal(jax.random.fold_in(noise, i),
                                             p.shape, p.dtype)
        if dtype is not None and p.dtype == jnp.float32:
            p = p.astype(dtype)
        leaves[i] = p
    return jax.tree_util.tree_unflatten(tree, leaves)


class DynamiCrafter:
    """Functional composite. Params pytree layout:
    {'unet': ..., 'vae': ..., 'clip_text': ..., 'clip_img': ..., 'resampler': ...}
    """

    def __init__(self, cfg: PandoraConfig, dtype=jnp.float32):
        self.cfg = cfg
        self.dtype = dtype
        self.unet = UNetModel(cfg.unet, dtype=dtype)
        self.vae = AutoencoderKL(cfg.vae, dtype=dtype)
        self.clip_text = CLIPTextEncoder(cfg.clip_text, dtype=dtype)
        self.clip_img = CLIPVisionEncoder(cfg.clip_vision, dtype=dtype)
        self.resampler = Resampler(cfg.resampler, dtype=dtype)
        self.schedule: DiffusionSchedule = make_schedule(cfg.diffusion)

    # -- init ---------------------------------------------------------------

    def init_params(self, key: jax.Array, *, height: int = 320,
                    width: int = 512) -> Dict[str, Any]:
        cfg = self.cfg
        t = cfg.unet.temporal_length
        ku, kv, kt, ki, kr = jax.random.split(key, 5)
        hz, wz = height // 8, width // 8
        x = jnp.zeros((1, t, hz, wz, cfg.unet.in_channels), self.dtype)
        ctx = jnp.zeros(
            (1, cfg.unet.text_context_len + t * cfg.unet.img_tokens_per_frame,
             cfg.unet.context_dim), self.dtype)
        grid = cfg.clip_vision.image_size
        return {
            "unet": self.unet.init(ku, x, jnp.zeros((1,), jnp.int32), ctx),
            "vae": self.vae.init(kv, jnp.zeros((1, height, width, 3), self.dtype)),
            "clip_text": self.clip_text.init(
                kt, empty_prompt_tokens(1, cfg.clip_text.context_length)),
            "clip_img": self.clip_img.init(
                ki, jnp.zeros((1, grid, grid, 3), self.dtype)),
            "resampler": self.resampler.init(
                kr, jnp.zeros((1, (grid // cfg.clip_vision.patch_size) ** 2 + 1,
                               cfg.clip_vision.width), self.dtype)),
        }

    # -- conditioning -------------------------------------------------------

    def encode_text(self, params, token_ids: jnp.ndarray) -> jnp.ndarray:
        """(b, 77) ids -> (b, 77, 1024) penultimate-layer embedding."""
        return self.clip_text.apply(params["clip_text"], token_ids)

    def encode_image_context(self, params, images: jnp.ndarray) -> jnp.ndarray:
        """images (b, h, w, 3) in [0,1] -> (b, 16*video_length, 1024)
        cross-attn image tokens (embedder -> Resampler, model.py:711-712)."""
        x = clip_preprocess(images.astype(self.dtype),
                            size=self.cfg.clip_vision.image_size)
        feats = self.clip_img.apply(params["clip_img"], x)
        return self.resampler.apply(params["resampler"], feats)

    def get_latent_z(self, params, frames: jnp.ndarray,
                     key: Optional[jax.Array] = None) -> jnp.ndarray:
        """frames (b, t_cond, h, w, 3) in [-1,1] -> (b, T, h/8, w/8, 4)
        conditioning latents tiled to temporal_length (model.py:690-701)."""
        T = self.cfg.unet.temporal_length
        z = encode_video(self.vae, params["vae"], frames,
                         scale_factor=self.cfg.diffusion.scale_factor, key=key)
        t = z.shape[1]
        if t == 1:
            z = jnp.tile(z, (1, 4, 1, 1, 1))
            t = 4
        reps = T // t
        return jnp.tile(z, (1, reps, 1, 1, 1))

    # -- denoiser -----------------------------------------------------------

    def apply_model(self, params, x_noisy: jnp.ndarray, t: jnp.ndarray,
                    context: jnp.ndarray, concat_cond: jnp.ndarray,
                    fs: Optional[jnp.ndarray] = None,
                    deterministic: bool = True,
                    rngs: Optional[dict] = None) -> jnp.ndarray:
        """Hybrid conditioning (ddpm3d.py:1077-1081): channel-concat the
        cond latents, cross-attend the context."""
        x_in = jnp.concatenate([x_noisy, concat_cond], axis=-1)
        return self.unet.apply(params["unet"], x_in, t, context, fs=fs,
                               deterministic=deterministic,
                               rngs=rngs or {})

    # -- sampling -----------------------------------------------------------

    def image_guided_synthesis(
        self,
        params,
        *,
        text_context: jnp.ndarray,     # (b, 77, 1024) text or LLM conditioning
        cond_images: jnp.ndarray,      # (b, h, w, 3) in [0,1] for CLIP
        cond_frames: jnp.ndarray,      # (b, t_c, h, w, 3) in [-1,1] for VAE
        key: jax.Array,
        ddim_steps: int = 50,
        guidance_scale: float = 7.5,
        eta: float = 1.0,
        fs: int = 15,
        guidance_rescale: float = 0.0,
        timestep_spacing: str = "uniform_trailing",
        uncond_text_context: Optional[jnp.ndarray] = None,
        cfg_img: Optional[float] = None,
        _apply_model=None,
    ) -> jnp.ndarray:
        """model.py:703-781. Returns latents (b, T, h/8, w/8, 4).

        cfg_img enables 3-way CFG (ddim_multiplecond.py:210-234 +
        inference.py:196-202): the extra stream is uncond text + COND image
        embedding.

        _apply_model: optional override with the apply_model signature
        (params, x, t, ctx, concat, fs) — the hook parallel/sharded_infer.py
        uses to shard the CFG-stream batch over a mesh."""
        streams = self._synthesis_streams(
            params, text_context, cond_images, cond_frames,
            guidance_scale=guidance_scale,
            uncond_text_context=uncond_text_context, cfg_img=cfg_img, fs=fs)
        model_fn = self._synthesis_model_fn(params, streams,
                                            _apply_model=_apply_model)
        dd = make_ddim_schedule(
            self.schedule, ddim_steps, eta, timestep_spacing,
            use_dynamic_rescale=self.cfg.diffusion.use_dynamic_rescale)

        x_T, k_samp = self._synthesis_init_noise(streams, key)
        return ddim_sample(
            model_fn, dd, x_T, k_samp,
            guidance_scale=guidance_scale,
            cfg_img=cfg_img if streams["uncond_img_ctx"] is not None else None,
            guidance_rescale=guidance_rescale,
            parameterization=self.cfg.diffusion.parameterization)

    def _synthesis_streams(self, params, text_context, cond_images,
                           cond_frames, *, guidance_scale,
                           uncond_text_context, cfg_img, fs) -> dict:
        """Encoder pass of image_guided_synthesis: CLIP image context, VAE
        conditioning latents, and the per-CFG-stream cross-attn contexts."""
        cfg = self.cfg
        b = text_context.shape[0]

        img_ctx = self.encode_image_context(params, cond_images)
        z_cond = self.get_latent_z(params, cond_frames)
        cond_ctx = jnp.concatenate([text_context, img_ctx], axis=1)

        uncond_ctx = uncond_img_ctx = None
        if guidance_scale != 1.0:
            if uncond_text_context is None:
                uncond_text_context = self.encode_text(
                    params, empty_prompt_tokens(b, cfg.clip_text.context_length))
            # zero-image embedder for the uncond stream (model.py:726-731)
            uc_img_ctx = self.encode_image_context(
                params, jnp.zeros_like(cond_images))
            uncond_ctx = jnp.concatenate([uncond_text_context, uc_img_ctx],
                                         axis=1)
            if cfg_img is not None and cfg_img != 1.0:
                uncond_img_ctx = jnp.concatenate(
                    [uncond_text_context, img_ctx], axis=1)

        return {"cond_ctx": cond_ctx, "uncond_ctx": uncond_ctx,
                "uncond_img_ctx": uncond_img_ctx, "z_cond": z_cond,
                "fs": jnp.full((b,), fs, dtype=jnp.int32)}

    def _synthesis_model_fn(self, params, streams: dict, _apply_model=None):
        """CFG ModelFn over precomputed streams (one batched UNet call)."""
        z_cond, fs_arr = streams["z_cond"], streams["fs"]
        b = z_cond.shape[0]

        raw_apply = _apply_model or (
            lambda p, x, t, ctx, concat, fs: self.apply_model(
                p, x, t, ctx, concat, fs=fs))

        def apply(x, t, ctx):
            bb = x.shape[0]
            reps = bb // b
            return raw_apply(
                params, x, t, ctx,
                jnp.concatenate([z_cond] * reps, axis=0),
                jnp.concatenate([fs_arr] * reps, axis=0))

        # context is the only stream-dependent leaf; concat_cond/fs repeat
        return make_cfg_model_fn(
            lambda x, t, ctx: apply(x, t, ctx),
            streams["cond_ctx"], streams["uncond_ctx"],
            uncond_img=streams["uncond_img_ctx"],
            batched_cfg=self.cfg.sampler.batched_cfg)

    def _synthesis_init_noise(self, streams: dict, key: jax.Array):
        z_cond = streams["z_cond"]
        b, T, hz, wz = z_cond.shape[:4]
        k_noise, k_samp = jax.random.split(key)
        x_T = jax.random.normal(
            k_noise, (b, T, hz, wz, self.cfg.vae.z_channels),
            dtype=self.dtype)
        return x_T, k_samp

    def image_guided_synthesis_segmented(
        self,
        params,
        *,
        text_context: jnp.ndarray,
        cond_images: jnp.ndarray,
        cond_frames: jnp.ndarray,
        key: jax.Array,
        segment_steps: int = 10,
        ddim_steps: int = 50,
        guidance_scale: float = 7.5,
        eta: float = 1.0,
        fs: int = 15,
        guidance_rescale: float = 0.0,
        timestep_spacing: str = "uniform_trailing",
        uncond_text_context: Optional[jnp.ndarray] = None,
        cfg_img: Optional[float] = None,
    ) -> jnp.ndarray:
        """image_guided_synthesis as a HOST-side driver over bounded device
        programs: one jitted encoder/setup program, then the DDIM scan
        dispatched in <=segment_steps chunks (one compiled segment reused
        with a traced start index; a shorter remainder segment compiles
        separately). Per-step noise keys use the global step index, so the
        result is IDENTICAL to the single-program sampler for any
        segment_steps.

        The product path (ChatWM) runs the single-program sampler; whether
        this host-driven form stays is an open roadmap item. Do NOT wrap
        this method in jax.jit — that would refuse the host loop and
        rebuild the single long program."""
        cfg = self.cfg
        if not hasattr(self, "_segmented_jit_cache"):
            self._segmented_jit_cache = {}
        static_key = (
            text_context.shape, cond_images.shape, cond_frames.shape,
            None if uncond_text_context is None else uncond_text_context.shape,
            segment_steps, ddim_steps, guidance_scale, eta, fs,
            guidance_rescale, timestep_spacing, cfg_img)
        entry = self._segmented_jit_cache.get(static_key)
        if entry is None:
            dd = make_ddim_schedule(
                self.schedule, ddim_steps, eta, timestep_spacing,
                use_dynamic_rescale=cfg.diffusion.use_dynamic_rescale)

            def setup(params, tc, ci, cf, utc, key):
                streams = self._synthesis_streams(
                    params, tc, ci, cf, guidance_scale=guidance_scale,
                    uncond_text_context=utc, cfg_img=cfg_img, fs=fs)
                x_T, k_samp = self._synthesis_init_noise(streams, key)
                return streams, x_T, k_samp

            def make_segment(length):
                def segment(params, x, streams, k_samp, start):
                    model_fn = self._synthesis_model_fn(params, streams)
                    return ddim_sample(
                        model_fn, dd, x, k_samp,
                        guidance_scale=guidance_scale,
                        cfg_img=(cfg_img
                                 if streams["uncond_img_ctx"] is not None
                                 else None),
                        guidance_rescale=guidance_rescale,
                        parameterization=cfg.diffusion.parameterization,
                        start=start, length=length)
                return jax.jit(segment)

            lengths = {min(segment_steps, ddim_steps - s)
                       for s in range(0, ddim_steps, segment_steps)}
            entry = (jax.jit(setup),
                     {length: make_segment(length) for length in lengths})
            self._segmented_jit_cache[static_key] = entry

        setup_fn, segment_fns = entry
        streams, x, k_samp = setup_fn(params, text_context, cond_images,
                                      cond_frames, uncond_text_context, key)
        for s in range(0, ddim_steps, segment_steps):
            length = min(segment_steps, ddim_steps - s)
            x = segment_fns[length](params, x, streams, k_samp,
                                    jnp.int32(s))
        return x

    def decode(self, params, z: jnp.ndarray, frame_chunk: int = 1) -> jnp.ndarray:
        """latents -> video (b, t, h, w, 3) in [-1, 1] (clamped by caller)."""
        return decode_video(self.vae, params["vae"], z,
                            scale_factor=self.cfg.diffusion.scale_factor,
                            frame_chunk=frame_chunk)
