"""Profile/time the CFG-pair UNet eval (the DDIM hot-loop body) on the GPU.

Times the batched-CFG UNet step at the product 320x512 shape with
zero-init bf16 params (eval_shape -> device zeros skips the heavy host
init), chaining iterations through a data dependency and ending with a
host fetch. With --profile, captures a jax.profiler trace and prints the
per-op attribution of the GPU device planes from the dependency-free
XSpace parser (utils/xplane.py).

Usage: python -m open_pandora_tpu.tools.profile_unet [--iters 10]
       [--profile] [--label NAME] [--height 320 --width 512]
"""

from __future__ import annotations

import argparse
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--label", default="unet")
    ap.add_argument("--height", type=int, default=320)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--no-cache", action="store_true",
                    help="skip the persistent compilation cache")
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
    uparams = {"unet": jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, jnp.bfloat16
                            if s.dtype == jnp.float32 else s.dtype),
        shapes["unet"])}
    jax.block_until_ready(jax.tree_util.tree_leaves(uparams)[0])

    T = cfg.unet.temporal_length
    hz, wz = args.height // 8, args.width // 8
    b = 2  # batched CFG pair
    ctx_len = cfg.unet.text_context_len + T * cfg.unet.img_tokens_per_frame
    x = jax.random.normal(jax.random.PRNGKey(1), (b, T, hz, wz, 4),
                          jnp.bfloat16)
    ctx = jax.random.normal(jax.random.PRNGKey(2),
                            (b, ctx_len, cfg.unet.context_dim), jnp.bfloat16)
    zc = jax.random.normal(jax.random.PRNGKey(3), (b, T, hz, wz, 4),
                           jnp.bfloat16)
    t_b = jnp.full((b,), 500, jnp.int32)
    fs = jnp.full((b,), 15, jnp.int32)

    f = jax.jit(lambda p, x: dc.apply_model(p, x, t_b, ctx, zc, fs=fs))
    t0 = time.perf_counter()
    y = f(uparams, x)
    jax.block_until_ready(y)
    np.asarray(y[0, 0, 0, 0, 0])
    print(f"compile+first: {time.perf_counter() - t0:.1f}s", flush=True)

    yy = x
    t0 = time.perf_counter()
    for _ in range(args.iters):
        yy = f(uparams, yy)
    np.asarray(yy[0, 0, 0, 0, 0])
    per = (time.perf_counter() - t0) / args.iters
    print(f"EVAL {args.label} {per * 1e3:.1f} ms/CFG-pair", flush=True)

    if args.profile:
        import tempfile

        from open_pandora_tpu.utils.xplane import (DEVICE_PLANE,
                                                   find_xplane_files,
                                                   parse_xspace, top_ops)
        logdir = tempfile.mkdtemp(prefix=f"xprof_{args.label}_")
        yy = x
        with jax.profiler.trace(logdir):
            for _ in range(2):
                yy = f(uparams, yy)
            np.asarray(yy[0, 0, 0, 0, 0])
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
        print(f"sync-op ms/iter: {comp / 2:.1f}; "
              f"async windows/iter: {sum(awin.values()) / 2:.1f}")
        for name, ms in top_ops(sync, 15):
            print(f"  SYNC {ms / 2:8.2f} ms  {name[:140]}")
        print("trace logdir:", logdir)


if __name__ == "__main__":
    main()
