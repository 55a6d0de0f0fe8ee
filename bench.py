"""Benchmark: the FULL product clip — LLM conditioning + DDIM-50 sampling
(batched CFG, incl. OpenCLIP image/text encoders + Resampler) + chunked VAE
decode — for one 2s 320x512 16-frame round on one GPU, the path a ChatWM
round actually runs (reference model.py:1007-1048).

Prints ONE JSON line: {"metric", "value", "unit", "device", "breakdown"}.
breakdown adds frames/sec/device, the per-phase seconds, one real
576x1024 DDIM-50 synthesis call and one real 5-round ChatWM session, cold
AND warm (unless PANDORA_BENCH_FAST=1).

Process structure: a thin orchestrator that starts no JAX backend runs two
phase groups as subprocesses, one after the other, each with the GPU to
itself (JAX_PLATFORMS=cuda: a child without a GPU fails at start-up) —
  --phase main    headline clip (conditioning/sampling/decode) + the
                  5-round ChatWM session
  --phase hires   the 576x1024 DDIM-50 synthesis + chunked decode
A failed phase makes the run exit non-zero.

Timing methodology: each sampling iteration ends with its own host fetch;
per-iteration times are recorded so one slow iteration is visible instead
of silently skewing a chained mean.
"""

import json
import os
import subprocess
import sys
import time

from open_pandora_tpu.core import flags

DDIM_STEPS = 50
H, W = 320, 512
T_FRAMES = 16
FAST = flags.flag("PANDORA_BENCH_FAST")
_HERE = os.path.dirname(os.path.abspath(__file__))


def _device_record() -> dict:
    """The device a phase ran on; a phase without a GPU fails."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: no GPU (JAX's first device is "
                         f"{dev.platform!r})")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
            "xla_flags": os.environ.get("XLA_FLAGS", "")}


# ---------------------------------------------------------------------------
# phase group: main (headline clip + 5-round session)
# ---------------------------------------------------------------------------


def phase_main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from open_pandora_tpu.core.cache import enable_compilation_cache
    enable_compilation_cache()

    from open_pandora_tpu.core.config import PandoraConfig
    from open_pandora_tpu.models.dynamicrafter import random_params
    from open_pandora_tpu.models.world_model import WorldModel, round1_prompt

    device = _device_record()
    cfg = PandoraConfig()
    # bf16 diffusion stack + int8 LLaMA (models/quant.py)
    wm = WorldModel(cfg, dtype=jnp.bfloat16, quantize_llm=True)

    params = random_params(wm, 0, jnp.bfloat16)
    jax.block_until_ready(params)

    # --- product inputs (shapes exactly as ChatWM round 1 builds them)
    tower = cfg.clip_tower.image_size
    images = jnp.ones((1, 1, tower, tower, 3), jnp.bfloat16) * 0.1
    bucket = 16  # ChatWM.TEXT_BUCKETS[0]
    ids = np.zeros((1, bucket), np.int32)
    ids[0, :6] = [1, 4931, 882, 1201, 3204, 17]
    mask = np.zeros((1, bucket), bool)
    mask[0, :6] = True
    prompt = round1_prompt(jnp.asarray(ids), images=images,
                           prefix_len=cfg.connector.image_prefix_length,
                           text_mask=jnp.asarray(mask))
    cond_images = jnp.ones((1, H, W, 3), jnp.bfloat16) * 0.5
    cond_frames = jnp.ones((1, 4, H, W, 3), jnp.bfloat16) * 0.1

    # --- phase 1: LLM conditioning (CLIP tower + DPC-KNN + 7B prefill +
    # QFormer connector; model.py:616-686)
    cond_fn = jax.jit(lambda p, pr: wm.get_diffusion_conditioning(p, pr))
    cond = cond_fn(params, prompt)
    np.asarray(cond[0, 0, 0, 0])
    iters = 4
    t0 = time.perf_counter()
    pr = prompt
    for _ in range(iters):
        cond = cond_fn(params, pr)
        pr = jax.tree_util.tree_map(lambda x: x, pr)
        pr.images = pr.images + (cond.sum() * 0).astype(pr.images.dtype)
    np.asarray(cond[0, 0, 0, 0])
    t_cond = (time.perf_counter() - t0) / iters

    # --- phase 2: DDIM-50 sampling (batched CFG; includes OpenCLIP text +
    # image encoders, Resampler, VAE cond encode; model.py:703-781)
    def synth(p, text_ctx, ci, cf, k):
        return wm.diffusion.image_guided_synthesis(
            p, text_context=text_ctx, cond_images=ci, cond_frames=cf,
            key=k, ddim_steps=DDIM_STEPS,
            guidance_scale=cfg.sampler.guidance_scale, eta=1.0, fs=15)

    synth_fn = jax.jit(synth)
    text_ctx = cond[:, -1]
    z = synth_fn(params, text_ctx, cond_images, cond_frames,
                 jax.random.PRNGKey(1))
    np.asarray(z[0, 0, 0, 0])
    # per-iteration host fetch (forces completion) so ONE slow iteration
    # can't silently skew the mean
    iters = 3
    ci = cond_images
    synth_iters = []
    for i in range(iters):
        t0 = time.perf_counter()
        z = synth_fn(params, text_ctx, ci, cond_frames,
                     jax.random.PRNGKey(2 + i))
        np.asarray(z[0, 0, 0, 0])
        synth_iters.append(time.perf_counter() - t0)
        ci = ci + (z.sum() * 0).astype(ci.dtype)
    t_synth = sum(synth_iters) / iters

    # --- phase 3: chunked VAE decode (perframe_ae equivalent; 8-frame
    # chunks at 320x512, as pipeline/chat_wm.py decodes)
    dec_fn = jax.jit(lambda p, zz: wm.diffusion.decode(p, zz, frame_chunk=8))
    video = dec_fn(params, z)
    np.asarray(video[0, 0, 0, 0, 0])
    iters = 2
    t0 = time.perf_counter()
    zz = z
    for _ in range(iters):
        video = dec_fn(params, zz)
        zz = zz + (video.sum() * 0).astype(zz.dtype)
    np.asarray(video[0, 0, 0, 0, 0])
    t_dec = (time.perf_counter() - t0) / iters

    t_clip = t_cond + t_synth + t_dec
    breakdown = {
        "conditioning_s": round(t_cond, 3),
        "sampling_ddim50_s": round(t_synth, 3),
        "sampling_iters_s": [round(s, 3) for s in synth_iters],
        "sampling_min_s": round(min(synth_iters), 3),
        "vae_decode_s": round(t_dec, 3),
        "frames_per_sec_per_device": round(T_FRAMES / t_clip, 3),
        # every recorded number names its routing (core/flags.py registry)
        "flags": flags.snapshot(),
    }
    out = {
        "metric": "sec_per_full_2s_320x512_16f_ddim50_clip",
        "value": round(t_clip, 3),
        "unit": "s/clip",
        "device": device,
        "breakdown": breakdown,
    }

    # --- config 4 (BASELINE.md): a REAL 5-round autoregressive ChatWM
    # session — rounds 2+ prefill the growing <image>x16 history through
    # the LLM (model.py:1055)
    if FAST:
        breakdown["five_round_session_skipped"] = "PANDORA_BENCH_FAST=1"
    else:
        from open_pandora_tpu.pipeline.chat_wm import ChatWM
        chat = ChatWM(wm, params, height=H, width=W)
        img = (np.linspace(0, 255, H * W * 3) % 255).astype(
            np.uint8).reshape(H, W, 3)
        texts = ["the car drives down the road", "the car turns left",
                 "the car speeds up", "the car slows down",
                 "the car stops at the light"]
        t0 = time.perf_counter()
        chat.generate_video_multiround(img, texts, ddim_steps=DDIM_STEPS,
                                       guidance_scale=4.0, fs=15)
        breakdown["five_round_session_s"] = round(
            time.perf_counter() - t0, 2)
        # (conditioning, sampling, decode) seconds per round
        breakdown["per_round_s"] = [[round(x, 3) for x in r]
                                    for r in chat.round_times]
        # second run: every round's trace is an in-process jit cache hit —
        # the steady-state session cost
        chat.round_times = []
        t0 = time.perf_counter()
        chat.generate_video_multiround(img, texts, ddim_steps=DDIM_STEPS,
                                       guidance_scale=4.0, fs=15)
        breakdown["five_round_session_warm_s"] = round(
            time.perf_counter() - t0, 2)
        breakdown["per_round_warm_s"] = [[round(x, 3) for x in r]
                                         for r in chat.round_times]

    print(json.dumps(out), flush=True)


# ---------------------------------------------------------------------------
# phase group: hires (config 3 — 576x1024x16f DDIM-50, clean HBM)
# ---------------------------------------------------------------------------


def phase_hires():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from open_pandora_tpu.core.cache import enable_compilation_cache
    enable_compilation_cache()

    from open_pandora_tpu.core.config import PandoraConfig
    from open_pandora_tpu.models.dynamicrafter import (DynamiCrafter,
                                                       random_params)

    _device_record()
    cfg = PandoraConfig()
    dc = DynamiCrafter(cfg, dtype=jnp.bfloat16)
    hh, ww = 576, 1024
    params = random_params(dc, 0, jnp.bfloat16)
    jax.block_until_ready(params)

    ci_h = jnp.ones((1, hh, ww, 3), jnp.bfloat16) * 0.5
    cf_h = jnp.ones((1, 1, hh, ww, 3), jnp.bfloat16) * 0.1
    tctx = jnp.zeros((1, cfg.unet.text_context_len,
                      cfg.unet.context_dim), jnp.bfloat16)

    synth_h = jax.jit(lambda p, tc, ci, cf, k: dc.image_guided_synthesis(
        p, text_context=tc, cond_images=ci, cond_frames=cf, key=k,
        ddim_steps=DDIM_STEPS, guidance_scale=7.5, eta=1.0, fs=24))
    zh = synth_h(params, tctx, ci_h, cf_h, jax.random.PRNGKey(7))
    np.asarray(zh[0, 0, 0, 0])
    dec_h = jax.jit(lambda p, zz: dc.decode(p, zz, frame_chunk=2))
    vh = dec_h(params, zh)
    np.asarray(vh[0, 0, 0, 0, 0])
    # timed run (warm)
    t0 = time.perf_counter()
    zh = synth_h(params, tctx, ci_h + (vh.sum() * 0).astype(ci_h.dtype),
                 cf_h, jax.random.PRNGKey(8))
    np.asarray(zh[0, 0, 0, 0])
    t_synth_h = time.perf_counter() - t0
    t0 = time.perf_counter()
    vh = dec_h(params, zh)
    np.asarray(vh[0, 0, 0, 0, 0])
    t_dec_h = time.perf_counter() - t0
    print(json.dumps({
        "hires_576x1024_ddim50_s": round(t_synth_h + t_dec_h, 2),
        "hires_sampling_s": round(t_synth_h, 2),
        "hires_decode_s": round(t_dec_h, 3),
    }), flush=True)


# ---------------------------------------------------------------------------
# orchestrator
# ---------------------------------------------------------------------------


def _run_child(phase: str) -> dict:
    """Run one phase group in a fresh process pinned to the GPU; return its
    last JSON stdout line. Raises if the child fails."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--phase", phase],
        stdout=subprocess.PIPE, cwd=_HERE, env=env)
    lines = [ln for ln in proc.stdout.decode().splitlines()
             if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(
            f"phase {phase} rc={proc.returncode}, "
            f"stdout tail: {proc.stdout.decode()[-300:]!r}")
    return json.loads(lines[-1])


def main():
    out = _run_child("main")
    breakdown = out["breakdown"]
    if FAST:
        breakdown["hires_576x1024_skipped"] = "PANDORA_BENCH_FAST=1"
    else:
        breakdown.update(_run_child("hires"))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--phase":
        {"main": phase_main, "hires": phase_hires}[sys.argv[2]]()
    else:
        main()
