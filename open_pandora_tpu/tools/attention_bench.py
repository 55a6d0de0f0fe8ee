"""Time every attention implementation at the product's attention sites.

Usage (on a GPU):
  python -m open_pandora_tpu.tools.attention_bench [--iters 20] [--sites a,b]
  python -m open_pandora_tpu.tools.attention_bench --in-eval

For each site class of the 320x512x16f CFG-pair UNet eval and the LLaMA-7B
prefill, runs each implementation that accepts the shape — cuDNN fused
attention (`jax.nn.dot_product_attention`), the repo's plain `mha_xla`
on XLA, and JAX's shipped Pallas-Triton flash kernel
(`jax.experimental.pallas.ops.gpu.attention.mha`, a library kernel) — and
prints one JSON line per (site, implementation): median milliseconds per
call and max|d|/max|ref| against `mha_xla` in float32 under "highest"
matmul precision.

--in-eval times the full-width CFG-pair UNet eval (`__graft_entry__.entry`)
with the UNet's attention routed four ways: the dispatcher's rule, XLA
everywhere, cuDNN wherever it takes the shape (bf16 without a mask), and
the dispatcher with the t=16 temporal sites on the Pallas-Triton kernel.

`SITES` is the one table of product attention sites; chip_smoke.py checks
the dispatcher's parity on the same table.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import jax
import jax.numpy as jnp
import numpy as np

from open_pandora_tpu.ops.attention_xla import mha_xla

# (name, B, N, M, H, D, causal, padded_keys): shapes of one CFG-pair eval
# at 320x512x16f (latent 40x64 -> N = 2560 at level 0; the image
# cross-attention of each frame reads its own img_tokens_per_frame = 16
# tokens) and of a LLaMA-7B prefill with a padded text bucket.
SITES = (
    ("spatial_l0", 32, 2560, 2560, 5, 64, False, 0),
    ("spatial_l1", 32, 640, 640, 10, 64, False, 0),
    ("spatial_l2", 32, 160, 160, 20, 64, False, 0),
    ("text_cross_l0", 32, 2560, 77, 5, 64, False, 0),
    ("image_cross_l0", 32, 2560, 16, 5, 64, False, 0),
    ("temporal_l0", 2 * 2560, 16, 16, 5, 64, False, 0),
    ("temporal_l2", 2 * 160, 16, 16, 20, 64, False, 0),
    ("llama_prefill_512", 1, 512, 512, 32, 128, True, 11),
    ("llama_prefill_2048", 1, 2048, 2048, 32, 128, True, 11),
)


def site_inputs(b, n, m, h, d, padded, dtype, seed=0):
    kq, kk, kv = jax.random.split(jax.random.PRNGKey(seed), 3)
    q = jax.random.normal(kq, (b, n, h, d), jnp.float32).astype(dtype)
    k = jax.random.normal(kk, (b, m, h, d), jnp.float32).astype(dtype)
    v = jax.random.normal(kv, (b, m, h, d), jnp.float32).astype(dtype)
    mask = None
    if padded:
        keep = np.ones((b, m), bool)
        keep[:, 1:1 + padded] = False   # pads inside the text bucket
        mask = jnp.asarray(keep)[:, None, None, :]
    return q, k, v, mask


def implementations(causal, mask, n, m):
    out = {
        "xla": lambda q, k, v: mha_xla(q, k, v, causal=causal, mask=mask),
        "cudnn": lambda q, k, v: jax.nn.dot_product_attention(
            q, k, v, mask=mask, is_causal=causal, implementation="cudnn"),
    }
    pow2 = lambda x: x & (x - 1) == 0  # noqa: E731
    if mask is None and (pow2(min(m, 128)) and pow2(min(n, 128))
                         and n % min(n, 128) == 0 and m % min(m, 128) == 0):
        from jax.experimental.pallas.ops.gpu.attention import mha

        def pallas(q, k, v):
            return mha(q, k, v, None, sm_scale=q.shape[-1] ** -0.5,
                       causal=causal)
        out["pallas_triton"] = pallas
    return out


def time_ms(fn, args, iters):
    fn(*args).block_until_ready()
    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(iters):
            y = fn(*args)
        y.block_until_ready()
        reps.append((time.perf_counter() - t0) * 1e3 / iters)
    return statistics.median(reps)


def in_eval(iters):
    """Median ms of one CFG-pair UNet eval per attention routing."""
    import __graft_entry__ as g
    from jax.experimental.pallas.ops.gpu.attention import mha

    from open_pandora_tpu.models import unet3d
    from open_pandora_tpu.ops import attention as dispatcher

    def xla_everywhere(q, k, v, *, causal=False, mask=None, sm_scale=None):
        return mha_xla(q, k, v, causal=causal, mask=mask, sm_scale=sm_scale)

    def cudnn_wherever(q, k, v, *, causal=False, mask=None, sm_scale=None):
        if mask is None and q.shape[-1] <= 128 and q.dtype == jnp.bfloat16:
            return jax.nn.dot_product_attention(
                q, k, v, scale=sm_scale, is_causal=causal,
                implementation="cudnn")
        return mha_xla(q, k, v, causal=causal, mask=mask, sm_scale=sm_scale)

    def pallas_temporal(q, k, v, *, causal=False, mask=None, sm_scale=None):
        if mask is None and not causal and q.shape[1] == k.shape[1] == 16:
            return mha(q, k, v, None, sm_scale=q.shape[-1] ** -0.5)
        return dispatcher.attention(q, k, v, causal=causal, mask=mask,
                                    sm_scale=sm_scale)

    fn, args = g.entry()
    for name, route in (("dispatcher", dispatcher.attention),
                        ("xla", xla_everywhere),
                        ("cudnn_wherever", cudnn_wherever),
                        ("pallas_temporal", pallas_temporal)):
        unet3d.attention = route
        jf = jax.jit(lambda *a: fn(*a))
        t0 = time.perf_counter()
        jf(*args).block_until_ready()
        compile_s = time.perf_counter() - t0
        print(json.dumps({"unet_eval": name, "compile_s": compile_s,
                          "ms": time_ms(jf, args, iters)}), flush=True)
    unet3d.attention = dispatcher.attention


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--sites", default="")
    ap.add_argument("--in-eval", action="store_true")
    args = ap.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("attention_bench needs a GPU")
    if args.in_eval:
        return in_eval(args.iters)
    want = set(filter(None, args.sites.split(",")))
    for name, b, n, m, h, d, causal, padded in SITES:
        if want and name not in want:
            continue
        q, k, v, mask = site_inputs(b, n, m, h, d, padded, jnp.bfloat16)
        with jax.default_matmul_precision("highest"):
            ref = jax.jit(lambda q, k, v: mha_xla(
                q, k, v, causal=causal, mask=mask))(
                    *(x.astype(jnp.float32) for x in (q, k, v)))
            ref = np.asarray(ref)
        scale = float(np.abs(ref).max())
        for impl, fn in implementations(causal, mask, n, m).items():
            rec = {"site": name, "impl": impl, "shape": [b, n, m, h, d],
                   "causal": causal, "mask": mask is not None}
            try:
                jf = jax.jit(fn)
                out = np.asarray(jf(q, k, v).astype(jnp.float32))
                rec["rel_err"] = float(np.abs(out - ref).max()) / scale
                rec["ms"] = time_ms(jf, (q, k, v), args.iters)
            except Exception as e:  # noqa: BLE001 - report and go on
                rec["error"] = f"{type(e).__name__}: {str(e)[:200]}"
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
