"""Clip-level A/B harness: measure the DDIM hot loop WHERE THE PRODUCT RUNS
IT — inside the real `image_guided_synthesis` lax.scan — instead of (only)
the isolated chained-eval microbench that `tools/profile_unet.py` runs.

An isolated eval and the same UNet inside the sampler's scan can cost
differently per step, so an eval-level A/B is checked against this:

  1. isolated eval (chained, host-fetch-terminated)
  2. real synthesis at two step counts; the SLOPE (tB - tA)/(B - A) is the
     true marginal in-scan cost per DDIM step, free of the one-time
     encoder/VAE/compile overheads
  3. optionally an xplane profile of the scan itself (--profile)

Usage: python -m open_pandora_tpu.tools.clip_ab [--steps-a 5 --steps-b 25]
       [--height 320 --width 512] [--profile] [--label NAME] [--skip-eval]
"""

from __future__ import annotations

import argparse
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps-a", type=int, default=5)
    ap.add_argument("--steps-b", type=int, default=25)
    ap.add_argument("--iters", type=int, default=10, help="isolated-eval iters")
    ap.add_argument("--height", type=int, default=320)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--profile", action="store_true",
                    help="xplane-profile the steps-a scan")
    ap.add_argument("--label", default="clip")
    ap.add_argument("--skip-eval", action="store_true")
    ap.add_argument("--guidance-scale", type=float, default=4.0)
    ap.add_argument("--no-cache", action="store_true")
    args = ap.parse_args()

    if not args.no_cache:
        from open_pandora_tpu.core.cache import enable_compilation_cache
        enable_compilation_cache()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from open_pandora_tpu.core.config import PandoraConfig
    from open_pandora_tpu.models.dynamicrafter import DynamiCrafter

    cfg = PandoraConfig()
    dc = DynamiCrafter(cfg, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(
        lambda: dc.init_params(jax.random.PRNGKey(0),
                               height=args.height, width=args.width))
    params = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, jnp.bfloat16
                            if s.dtype == jnp.float32 else s.dtype), shapes)
    jax.block_until_ready(jax.tree_util.tree_leaves(params)[0])

    T = cfg.unet.temporal_length
    hz, wz = args.height // 8, args.width // 8
    ctx_len = cfg.unet.text_context_len + T * cfg.unet.img_tokens_per_frame

    # ---- 1. isolated chained CFG-pair eval (profile_unet methodology)
    if not args.skip_eval:
        b = 2
        x = jax.random.normal(jax.random.PRNGKey(1), (b, T, hz, wz, 4),
                              jnp.bfloat16)
        ctx = jax.random.normal(jax.random.PRNGKey(2),
                                (b, ctx_len, cfg.unet.context_dim),
                                jnp.bfloat16)
        zc = jax.random.normal(jax.random.PRNGKey(3), (b, T, hz, wz, 4),
                               jnp.bfloat16)
        t_b = jnp.full((b,), 500, jnp.int32)
        fsb = jnp.full((b,), 15, jnp.int32)
        f = jax.jit(lambda p, x: dc.apply_model(p, x, t_b, ctx, zc, fs=fsb))
        t0 = time.perf_counter()
        y = f(params, x)
        np.asarray(y[0, 0, 0, 0, 0])
        print(f"[{args.label}] eval compile+first: "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        yy = x
        t0 = time.perf_counter()
        for _ in range(args.iters):
            yy = f(params, yy)
        np.asarray(yy[0, 0, 0, 0, 0])
        per_eval = (time.perf_counter() - t0) / args.iters
        print(f"[{args.label}] ISOLATED eval: {per_eval * 1e3:.1f} ms/CFG-pair",
              flush=True)

    # ---- 2. real synthesis at two step counts -> in-scan slope
    text_ctx = jax.random.normal(jax.random.PRNGKey(4),
                                 (1, cfg.unet.text_context_len,
                                  cfg.unet.context_dim), jnp.bfloat16)
    ci = jnp.ones((1, args.height, args.width, 3), jnp.bfloat16) * 0.5
    cf = jnp.ones((1, 1, args.height, args.width, 3), jnp.bfloat16) * 0.1

    def make_synth(steps):
        return jax.jit(lambda p, tc, ci, cf, k: dc.image_guided_synthesis(
            p, text_context=tc, cond_images=ci, cond_frames=cf, key=k,
            ddim_steps=steps, guidance_scale=args.guidance_scale,
            eta=1.0, fs=15))

    def run_synth(steps, n_timed=2):
        fn = make_synth(steps)
        t0 = time.perf_counter()
        z = fn(params, text_ctx, ci, cf, jax.random.PRNGKey(7))
        np.asarray(z[0, 0, 0, 0])
        t_first = time.perf_counter() - t0
        cc = ci
        t0 = time.perf_counter()
        for i in range(n_timed):
            z = fn(params, text_ctx, cc, cf, jax.random.PRNGKey(8 + i))
            cc = cc + (z.sum() * 0).astype(cc.dtype)
        np.asarray(z[0, 0, 0, 0])
        t_warm = (time.perf_counter() - t0) / n_timed
        print(f"[{args.label}] synth ddim{steps}: warm {t_warm:.3f}s "
              f"(first {t_first:.1f}s)", flush=True)
        return t_warm, fn, z

    t_a, fn_a, z_a = run_synth(args.steps_a)
    t_b2, _, _ = run_synth(args.steps_b)
    slope = (t_b2 - t_a) / (args.steps_b - args.steps_a)
    const = t_a - slope * args.steps_a
    print(f"[{args.label}] IN-SCAN slope: {slope * 1e3:.1f} ms/step "
          f"(one-time overhead {const:.3f}s; "
          f"ddim50 projection {const + 50 * slope:.2f}s)", flush=True)

    # ---- 3. optional xplane profile of the steps-a scan
    if args.profile:
        import tempfile

        from open_pandora_tpu.utils.xplane import (DEVICE_PLANE,
                                                   find_xplane_files,
                                                   parse_xspace, top_ops)
        logdir = tempfile.mkdtemp(prefix=f"xprof_scan_{args.label}_")
        with jax.profiler.trace(logdir):
            z = fn_a(params, text_ctx,
                     ci + (z_a.sum() * 0).astype(ci.dtype), cf,
                     jax.random.PRNGKey(99))
            np.asarray(z[0, 0, 0, 0])
        sync, awin = {}, {}
        for fp in find_xplane_files(logdir):
            with open(fp, "rb") as fh:
                planes = parse_xspace(fh.read())
            for plane in planes:
                if DEVICE_PLANE not in plane["name"]:
                    continue
                for line in plane["lines"]:
                    tgt = {"XLA Ops": sync,
                           "Async XLA Ops": awin}.get(line["name"])
                    if tgt is None:
                        continue
                    for mid, dur, *_ in line["events"]:
                        nm = plane["meta"].get(mid, f"#{mid}")
                        tgt[nm] = tgt.get(nm, 0) + dur / 1e9
        comp = sum(v for k, v in sync.items()
                   if not k.startswith("%copy-start")
                   and not k.startswith("%copy-done"))
        print(f"[{args.label}] scan sync-op total: {comp:.2f}s over "
              f"{args.steps_a} steps ({comp / args.steps_a * 1e3:.1f} "
              f"ms/step); async windows {sum(awin.values()):.2f}s")
        for name, s in top_ops(sync, 25):
            print(f"  SYNC {s * 1e3:9.2f} ms  {name[:150]}")
        print("trace logdir:", logdir)


if __name__ == "__main__":
    main()
