"""Jitted data-parallel train steps with ZeRO-2 optimizer-state sharding.

Behavioral spec: /root/reference/model.py:926-949 training_step +
get_batch_input :828-884 (VAE-encode video, conditioning, CFG dropout via
torch.where on the text conditioning :860-868, fps cond), loss from
ddpm3d.py p_losses; DeepSpeed ZeRO-2 grad/opt sharding (config/config.yaml:22)
expressed as sharding specs (parallel/mesh.py zero2_opt_spec).

Batch contract (the dataset-side of WorldModel.get_batch_input kwargs,
SURVEY.md L1):
  video        (b, T, H, W, 3) in [-1, 1]
  cond_frames  (b, t_c, H, W, 3) in [-1, 1]  — VAE conditioning frames
  cond_images  (b, hc, wc, 3) in [0, 1]      — CLIP image for cross-attn
  text_tokens  (b, 77) int32                 — tokenized caption
  fps          (b,) int32
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from open_pandora_tpu.core.config import TrainConfig
from open_pandora_tpu.diffusion.losses import diffusion_loss
from open_pandora_tpu.models.dynamicrafter import DynamiCrafter
from open_pandora_tpu.models.encoders import empty_prompt_tokens
from open_pandora_tpu.models.vae import encode_video
from open_pandora_tpu.parallel.mesh import (MeshSpec, data_sharding,
                                            fsdp_param_spec, replicated,
                                            zero2_opt_spec)
from open_pandora_tpu.train.optim import (deep_merge, make_optimizer,
                                           trainable_partition)


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["step", "trainable", "frozen", "opt_state",
                                "ema"],
                   meta_fields=[])
@dataclasses.dataclass(frozen=True)
class TrainState:
    step: jnp.ndarray
    trainable: Any
    frozen: Any
    opt_state: Any
    ema: Any = None  # optional EMA shadow of `trainable` (train/ema.py)

    @classmethod
    def create(cls, params: dict, stage: str,
               tx: optax.GradientTransformation, use_ema: bool = False):
        from open_pandora_tpu.train.ema import ema_init
        trainable, frozen = trainable_partition(params, stage)
        return cls(step=jnp.zeros((), jnp.int32), trainable=trainable,
                   frozen=frozen, opt_state=tx.init(trainable),
                   ema=ema_init(trainable) if use_ema else None)

    @property
    def params(self) -> dict:
        return deep_merge(self.trainable, self.frozen)

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def _finetune_loss(model: DynamiCrafter, tcfg: TrainConfig, trainable, frozen,
                   batch: Dict[str, jnp.ndarray], key: jax.Array):
    params = deep_merge(trainable, frozen)
    cfg = model.cfg
    k_enc, k_drop, k_diff, k_dropout = jax.random.split(key, 4)

    # clean latents — the reference SAMPLES the posterior during training
    # (ddpm3d.py:595-602)
    z = encode_video(model.vae, params["vae"], batch["video"],
                     scale_factor=cfg.diffusion.scale_factor, key=k_enc)

    text_ctx = model.encode_text(params, batch["text_tokens"])
    img_ctx = model.encode_image_context(params, batch["cond_images"])
    z_cond = model.get_latent_z(params, batch["cond_frames"])

    # CFG dropout on the text conditioning only (model.py:860-868)
    if tcfg.uncond_prob > 0:
        b = text_ctx.shape[0]
        null_ctx = model.encode_text(
            params, empty_prompt_tokens(b, cfg.clip_text.context_length))
        mask = jax.random.bernoulli(k_drop, tcfg.uncond_prob, (b, 1, 1))
        text_ctx = jnp.where(mask, null_ctx, text_ctx)

    ctx = jnp.concatenate([text_ctx, img_ctx], axis=1)
    fs = batch["fps"].astype(jnp.int32)

    def apply(x_noisy, t, _cond):
        return model.apply_model(params, x_noisy, t, ctx, z_cond, fs=fs,
                                 deterministic=False,
                                 rngs={"dropout": k_dropout})

    return diffusion_loss(
        apply, model.schedule, z, None, k_diff,
        parameterization=cfg.diffusion.parameterization,
        use_dynamic_rescale=cfg.diffusion.use_dynamic_rescale,
        l_simple_weight=cfg.diffusion.l_simple_weight)


def make_wm_finetune_step(wm, tcfg: TrainConfig,
                          mesh_spec: Optional[MeshSpec] = None):
    """Full finetune stage (model.py:926-949 + get_batch_input :828-884):
    conditioning comes from the frozen-LLM path (get_diffusion_conditioning
    per step, :855-856), trains UNet + connector; CFG dropout swaps the LLM
    conditioning for the OpenCLIP null prompt (:860-868)."""
    from open_pandora_tpu.models.encoders import (CLIP_MEAN, CLIP_STD,
                                                  empty_prompt_tokens)
    from open_pandora_tpu.models.world_model import round1_prompt

    model = wm.diffusion

    def loss_fn(trainable, frozen, batch, key):
        params = deep_merge(trainable, frozen)
        cfg = wm.cfg
        k_enc, k_drop, k_diff, k_dropout = jax.random.split(key, 4)

        z = encode_video(model.vae, params["vae"], batch["video"],
                         scale_factor=cfg.diffusion.scale_factor, key=k_enc)

        imgs = batch["cond_images"]
        tower_imgs = (imgs - jnp.asarray(CLIP_MEAN, imgs.dtype)) / jnp.asarray(
            CLIP_STD, imgs.dtype)
        prompt = round1_prompt(
            batch["llm_text_tokens"], images=tower_imgs[:, None],
            prefix_len=cfg.connector.image_prefix_length)
        text_ctx = wm.get_diffusion_conditioning(params, prompt)[:, -1]

        if tcfg.uncond_prob > 0:
            b = text_ctx.shape[0]
            null_ctx = model.encode_text(
                params, empty_prompt_tokens(b, cfg.clip_text.context_length))
            mask = jax.random.bernoulli(k_drop, tcfg.uncond_prob, (b, 1, 1))
            text_ctx = jnp.where(mask, null_ctx, text_ctx)

        img_ctx = model.encode_image_context(params, batch["cond_images"])
        z_cond = model.get_latent_z(params, batch["cond_frames"])
        ctx = jnp.concatenate([text_ctx, img_ctx], axis=1)
        fs = batch["fps"].astype(jnp.int32)

        def apply(x_noisy, t, _cond):
            return model.apply_model(params, x_noisy, t, ctx, z_cond, fs=fs,
                                     deterministic=False,
                                     rngs={"dropout": k_dropout})

        return diffusion_loss(
            apply, model.schedule, z, None, k_diff,
            parameterization=cfg.diffusion.parameterization,
            use_dynamic_rescale=cfg.diffusion.use_dynamic_rescale,
            l_simple_weight=cfg.diffusion.l_simple_weight)

    return make_finetune_step(model, tcfg, mesh_spec=mesh_spec,
                              stage="finetune", loss_fn=loss_fn)


def make_offloaded_latent_step(model: DynamiCrafter, tcfg: TrainConfig):
    """Single-device latent finetune step with the AdamW moments resident
    in PINNED HOST memory (jax memories API), an analog of ZeRO-offload.
    XLA streams the moments across PCIe around the update; the step gets
    slower but the device footprint drops by the full optimizer state.
    Multi-device training should prefer ZeRO-2 sharding (zero2_opt_spec)
    instead.

    Returns (step, tx, put_state) — run `state = put_state(state)` once to
    move the moments to host before stepping."""
    import jax.sharding as jsh

    base_step, tx = make_latent_finetune_step(model, tcfg)
    dev = jax.devices()[0]
    on_dev = jsh.SingleDeviceSharding(dev)
    on_host = jsh.SingleDeviceSharding(dev, memory_kind="pinned_host")

    def state_shardings(state: TrainState) -> TrainState:
        return TrainState(
            step=on_dev,
            trainable=jax.tree_util.tree_map(lambda _: on_dev,
                                             state.trainable),
            frozen=jax.tree_util.tree_map(lambda _: on_dev, state.frozen),
            opt_state=jax.tree_util.tree_map(lambda _: on_host,
                                             state.opt_state),
        )

    cache = {}

    raw = base_step.raw_step

    def offloaded(state, batch, key):
        # explicit memory-space round-trip: host moments -> device for the
        # update, back to host after. XLA's latency-hiding scheduler
        # pipelines the per-leaf transfers, so the moments never all live
        # in device memory at once.
        opt_dev = jax.tree_util.tree_map(
            lambda x: jax.device_put(x, on_dev), state.opt_state)
        new_state, metrics = raw(state.replace(opt_state=opt_dev), batch, key)
        new_opt = jax.tree_util.tree_map(
            lambda x: jax.device_put(x, on_host), new_state.opt_state)
        return new_state.replace(opt_state=new_opt), metrics

    def step(state, batch, key):
        if "fn" not in cache:
            ss = state_shardings(state)
            bs = jax.tree_util.tree_map(lambda _: on_dev, batch)
            # donate the state: without input/output aliasing the old and
            # new params coexist
            cache["fn"] = jax.jit(offloaded,
                                  in_shardings=(ss, bs, on_dev),
                                  out_shardings=(ss, None),
                                  donate_argnums=(0,))
        return cache["fn"](state, batch, key)

    def put_state(state: TrainState) -> TrainState:
        ss = state_shardings(state)
        return jax.tree_util.tree_map(jax.device_put, state, ss)

    return step, tx, put_state


def _latent_loss_fn(model: DynamiCrafter):
    """Diffusion loss over PRECOMPUTED latents + conditioning — shared by
    the fused and split latent steps. Batch contract: see
    make_latent_finetune_step."""
    cfg = model.cfg

    def loss_fn(trainable, frozen, batch, key):
        params = deep_merge(trainable, frozen)
        k_diff, k_dropout = jax.random.split(key)

        def apply(x_noisy, t, _cond):
            return model.apply_model(params, x_noisy, t, batch["ctx"],
                                     batch["z_cond"],
                                     fs=batch["fps"].astype(jnp.int32),
                                     deterministic=False,
                                     rngs={"dropout": k_dropout})

        return diffusion_loss(
            apply, model.schedule, batch["z"], None, k_diff,
            parameterization=cfg.diffusion.parameterization,
            use_dynamic_rescale=cfg.diffusion.use_dynamic_rescale,
            l_simple_weight=cfg.diffusion.l_simple_weight)

    return loss_fn


def make_latent_finetune_step(model: DynamiCrafter, tcfg: TrainConfig,
                              mesh_spec: Optional[MeshSpec] = None):
    """Finetune step over PRECOMPUTED latents + conditioning: batch =
    {z (b,T,hz,wz,4), ctx (b,L,ctx_dim), z_cond (b,T,hz,wz,4), fps (b,)}.

    Everything in the loss except the UNet is frozen (model.py:951-965
    optimizer param groups), so the VAE/CLIP encoders can run once outside
    the step — their params and activations then stay out of the step's
    memory footprint. The frozen partition of the TrainState may be left
    empty."""
    return make_finetune_step(model, tcfg, mesh_spec=mesh_spec,
                              stage="dynamicrafter",
                              loss_fn=_latent_loss_fn(model))


def make_split_latent_step(model: DynamiCrafter, tcfg: TrainConfig):
    """Latent finetune step as TWO jits — grad phase, then update phase.

    In the fused step, XLA may schedule the optimizer update concurrently
    with the tail of the backward pass, so the peak live set holds remat
    temporaries AND the update's buffers at once. Splitting puts a hard
    barrier between the two regimes:

      grad phase   peak = params + resident moments + grads + remat temps
      update phase peak = params + grads + moments + new params/moments

    The extra cost is one dispatch boundary and re-reading the grads.
    Multi-device training should prefer ZeRO-2 sharding
    (make_latent_finetune_step with a mesh) instead. EMA is not updated by
    this step."""
    lfn = _latent_loss_fn(model)
    tx = make_optimizer(tcfg)

    @jax.jit
    def grad_phase(trainable, frozen, batch, key):
        (_, metrics), grads = jax.value_and_grad(lfn, has_aux=True)(
            trainable, frozen, batch, key)
        return grads, metrics

    @jax.jit
    def update_phase(state, grads):
        updates, new_opt = tx.update(grads, state.opt_state, state.trainable)
        new_trainable = optax.apply_updates(state.trainable, updates)
        return state.replace(step=state.step + 1, trainable=new_trainable,
                             opt_state=new_opt), optax.global_norm(grads)

    def step(state: TrainState, batch, key):
        grads, metrics = grad_phase(state.trainable, state.frozen, batch, key)
        new_state, gnorm = update_phase(state, grads)
        return new_state, {**metrics, "grad_norm": gnorm}

    return step, tx


def make_alignment_step(wm, tcfg: TrainConfig,
                        mesh_spec: Optional[MeshSpec] = None):
    """Alignment stage (model.py:886-923 + config_align.yaml): trains the
    connector only, KL against the frozen OpenCLIP text embedding.

    Batch contract: cond_images (b,224,224,3) in [0,1], llm_text_tokens
    (b, L) LLaMA ids (bos + caption), text_tokens (b, 77) CLIP ids."""
    from open_pandora_tpu.models.encoders import CLIP_MEAN, CLIP_STD
    from open_pandora_tpu.models.world_model import round1_prompt

    def loss_fn(trainable, frozen, batch, key):
        params = deep_merge(trainable, frozen)
        imgs = batch["cond_images"]
        imgs = (imgs - jnp.asarray(CLIP_MEAN, imgs.dtype)) / jnp.asarray(
            CLIP_STD, imgs.dtype)
        prompt = round1_prompt(
            batch["llm_text_tokens"], images=imgs[:, None],
            prefix_len=wm.cfg.connector.image_prefix_length)
        loss = wm.alignment_loss(params, prompt, batch["text_tokens"])
        return loss, {"loss": loss}

    return make_finetune_step(wm.diffusion, tcfg, mesh_spec=mesh_spec,
                              stage="alignment", loss_fn=loss_fn)


def make_finetune_step(
    model: DynamiCrafter,
    tcfg: TrainConfig,
    mesh_spec: Optional[MeshSpec] = None,
    stage: str = "dynamicrafter",
    loss_fn: Optional[Callable] = None,
    fsdp: bool = False,
) -> Tuple[Callable, optax.GradientTransformation]:
    """Build (jitted_step, tx). jitted_step(state, batch, key) ->
    (state, metrics). With a MeshSpec: batch sharded over the data axis,
    params replicated, optimizer state ZeRO-2-sharded; XLA inserts the
    gradient psum (DDP semantics) and opt-state collectives.

    fsdp=True additionally shards every large parameter leaf (trainable,
    frozen, and EMA shadows) over the data axis — the FSDP/ZeRO-3 analog
    for LLM-scale training (ChatUniVi/train/train.py:974); GSPMD inserts
    the per-layer all-gathers and gradient reduce-scatters.
    """
    tx = make_optimizer(tcfg)
    lfn = loss_fn or functools.partial(_finetune_loss, model, tcfg)

    def step(state: TrainState, batch, key):
        (loss, metrics), grads = jax.value_and_grad(lfn, has_aux=True)(
            state.trainable, state.frozen, batch, key)
        updates, new_opt = tx.update(grads, state.opt_state, state.trainable)
        new_trainable = optax.apply_updates(state.trainable, updates)
        gnorm = optax.global_norm(grads)
        new_ema = state.ema
        if state.ema is not None:
            from open_pandora_tpu.train.ema import ema_update
            new_ema = ema_update(state.ema, new_trainable, state.step,
                                 decay=tcfg.ema_decay)
        new_state = state.replace(step=state.step + 1, trainable=new_trainable,
                                  opt_state=new_opt, ema=new_ema)
        return new_state, {**metrics, "grad_norm": gnorm}

    if mesh_spec is None:
        # the state is not donated yet, so old and new params and moments
        # coexist on the device: donation waits for the four-GPU check of
        # this step (`chip_smoke.py --four-cards`, ROADMAP D3)
        jitted = jax.jit(step)
        jitted.raw_step = step  # type: ignore[attr-defined] (offload path)
        return jitted, tx

    def param_specs(tree):
        if fsdp:
            return fsdp_param_spec(mesh_spec, tree)
        return jax.tree_util.tree_map(lambda _: replicated(mesh_spec), tree)

    def state_shardings(state: TrainState):
        return TrainState(
            step=replicated(mesh_spec),
            trainable=param_specs(state.trainable),
            frozen=param_specs(state.frozen),
            opt_state=zero2_opt_spec(mesh_spec, state.opt_state),
            ema=param_specs(state.ema) if state.ema is not None else None)

    def shard_state(state: TrainState) -> TrainState:
        """Device-put a TrainState with ZeRO-2 (+ FSDP) shardings applied."""
        return jax.tree_util.tree_map(jax.device_put, state,
                                      state_shardings(state))

    def batch_shardings(batch):
        return jax.tree_util.tree_map(
            lambda x: data_sharding(mesh_spec, jnp.ndim(x)), batch)

    cache = {}

    def jitted(state, batch, key):
        # memoize the jit wrapper per batch pytree structure — a fresh
        # jax.jit per call would re-trace every step
        sig = jax.tree_util.tree_structure(batch)
        fn = cache.get(sig)
        if fn is None:
            ss = state_shardings(state)
            fn = jax.jit(
                step,
                in_shardings=(ss, batch_shardings(batch),
                              replicated(mesh_spec)),
                out_shardings=(ss, None),
            )
            cache[sig] = fn
        return fn(state, batch, key)

    jitted.shard_state = shard_state  # type: ignore[attr-defined]
    return jitted, tx
