"""Prove that the world model runs on an NVIDIA GPU.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # the multi-device paths, four cards

One card, in order:
  1. device: fails unless JAX's first device is a GPU; prints the card's
     name and power limit (nvidia-smi) and the JAX version;
  2. attention parity at the product widths: every site class of the
     320x512x16f UNet eval and the LLaMA-7B prefill, through the dispatcher
     (ops/attention.py): bf16 against `mha_xla` in float32 under "highest"
     matmul precision, float32 against numpy float64;
  3. the main path: `WorldModel` from the default `PandoraConfig` (LLaMA-7B,
     CLIP ViT-L, clustering, Q-Former; DynamiCrafter UNet3D, SD VAE,
     OpenCLIP ViT-H) with random weights in bf16, built as the pipeline CLI
     builds it, runs a two-round ChatWM session at 320x512x16, DDIM-50.

`--four-cards` runs only (a) one DP + ZeRO-2 finetune step of the
full-width DynamiCrafter over a 4x1 ('data', 'model') mesh against the same
step taken on one card, and (b) `sharded_synthesis` over 2 cards and
`sharded_decode` over 4 against one card.

Every phase raises on failure. The last line of standard output is one
JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

BF16_TOL = 2e-2      # max|d| / max|ref|, bf16 inputs and outputs
BF16_VS_XLA = 2.0    # a bf16 route may err at most this times XLA's bf16
FP32_TOL = 1e-5      # float32 inputs under "highest", against float64
FP64_ROWS = 256      # queries of one batch entry checked in float64
# one site of each class of tools/attention_bench.SITES: spatial
# self-attention, text and image cross-attention, temporal attention and
# the padded LLaMA-7B prefill
PARITY_SITES = ("spatial_l0", "text_cross_l0", "image_cross_l0",
                "temporal_l0", "llama_prefill_512")

# --four-cards. The DP step runs at the trainer's precision (float32
# params and activations at the platform's default matmul precision,
# which is TF32 on the GPU) and the one-card reference at float32
# "highest". TF32 keeps 10 mantissa bits, so the loss may differ by ~1e-3
# relatively and the gradient norm somewhat more. After Adam's first step
# each element moves by about lr * sign(g), so the updated parameters are
# compared as the mean |difference| in units of lr: a gradient averaged
# wrongly or a replica that drifts moves it to ~1.
DP_GLOBAL_BATCH = 4
DP_LOSS_RTOL = 1e-2
DP_GNORM_RTOL = 5e-2
DP_UPDATE_TOL = 0.2
# Sharded and one-card inference run the same bf16 per-sample programs;
# XLA may pick other conv algorithms for other batch sizes, whose rounding
# grows over the DDIM steps: max|d| / max|ref|.
INFER_DDIM_STEPS = 10
INFER_RTOL = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def require_gpu():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX's first device is "
                         f"{dev.platform!r})")
    return dev


def attention_float64(q, k, v, causal, keep):
    """numpy float64 attention of the first FP64_ROWS queries of batch
    entry 0: q (N, H, D), k/v (M, H, D), keep (M,) or None."""
    n, m = q.shape[0], k.shape[0]
    rows = min(n, FP64_ROWS)
    s = np.einsum("nhd,mhd->hnm", q[:rows], k) * q.shape[-1] ** -0.5
    allowed = np.ones((rows, m), bool)
    if causal:
        allowed &= np.arange(m)[None, :] <= np.arange(rows)[:, None] + m - n
    if keep is not None:
        allowed &= keep[None, :]
    s = np.where(allowed[None], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("hnm,mhd->nhd", p, v)


def attention_parity(sites=None):
    """Phase 2 over `sites` ((name, B, N, M, H, D, causal, padded keys)
    tuples; default: the PARITY_SITES rows of SITES). Returns the
    failures (empty when every site passes).

    bf16 through the dispatcher against `mha_xla` in float32 under
    "highest"; float32 through the dispatcher, under "highest", against
    numpy float64 on the first FP64_ROWS queries of batch entry 0."""
    import jax
    import jax.numpy as jnp

    from open_pandora_tpu.ops.attention import (attention,
                                                choose_implementation)
    from open_pandora_tpu.ops.attention_xla import mha_xla
    from open_pandora_tpu.tools.attention_bench import SITES, site_inputs

    if sites is None:
        sites = [s for s in SITES if s[0] in PARITY_SITES]
    failures = []
    for name, b, n, m, h, d, causal, padded in sites:
        q, k, v, mask = site_inputs(b, n, m, h, d, padded, jnp.float32)

        def run(fn, dtype):
            out = jax.jit(lambda q, k, v: fn(q, k, v, causal=causal,
                                             mask=mask))(
                q.astype(dtype), k.astype(dtype), v.astype(dtype))
            return np.asarray(out.astype(jnp.float32))

        with jax.default_matmul_precision("highest"):
            ref = run(mha_xla, jnp.float32)
            fp32 = run(attention, jnp.float32)
        bf16 = run(attention, jnp.bfloat16)
        xla_bf16 = run(mha_xla, jnp.bfloat16)
        scale = float(np.abs(ref).max())
        err = lambda x: float(np.abs(x - ref).max()) / scale  # noqa: E731
        e_bf16, e_xla = err(bf16), err(xla_bf16)
        keep = None if mask is None else np.asarray(mask)[0, 0, 0]
        ref64 = attention_float64(*(np.asarray(x[0], np.float64)
                                    for x in (q, k, v)), causal, keep)
        e_fp32 = float(np.abs(fp32[0, :ref64.shape[0]] - ref64).max()
                       / np.abs(ref64).max())
        routes = [choose_implementation("gpu", dt, q.shape, k.shape,
                                        causal=causal,
                                        has_mask=mask is not None)
                  for dt in (jnp.bfloat16, jnp.float32)]
        ok = (e_bf16 <= BF16_TOL and e_bf16 <= BF16_VS_XLA * e_xla
              and e_fp32 <= FP32_TOL)
        log(f"[attention] {name:18s} B={b} N={n} M={m} H={h} D={d}: bf16 "
            f"route={routes[0]} {e_bf16:.3e} (tol {BF16_TOL:g}, XLA bf16 "
            f"{e_xla:.3e} x{BF16_VS_XLA:g}); fp32 route={routes[1]} "
            f"{e_fp32:.3e} vs float64 (tol {FP32_TOL:g}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)
    return failures


def smoke_image(height: int, width: int, seed: int = 0) -> np.ndarray:
    """A smooth uint8 test image with some texture, made from a seed."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(xx / 37.0 + c) * np.cos(yy / 23.0)
                    for c in range(3)], axis=-1)
    img += rng.normal(0.0, 8.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def main_path(argv_cli, height, width, frames, ddim_steps, actions):
    """Phase 3: build ChatWM as the CLI does and run one round per action.
    Returns per-round (conditioning_s, sampling_s, decode_s)."""
    from open_pandora_tpu.pipeline.cli import build_chat, build_parser

    args = build_parser().parse_args(argv_cli)
    t0 = time.perf_counter()
    chat = build_chat(args)
    log(f"[main] built WorldModel + random params in "
        f"{time.perf_counter() - t0:.1f}s")
    image = smoke_image(height, width)
    for i, action in enumerate(actions):
        if i == 0:
            out = chat.generate_video(image, action, ddim_steps=ddim_steps,
                                      seed=args.seed)
        else:
            out = chat.generate_video_next_round(
                action, ddim_steps=ddim_steps, seed=args.seed)
        want = (frames, height, width, 3)
        if out.shape != want or out.dtype != np.uint8:
            raise AssertionError(f"round {i}: frames {out.shape} "
                                 f"{out.dtype}, want {want} uint8")
        video = chat.last_video
        if not np.isfinite(video).all():
            raise AssertionError(f"round {i}: non-finite decoded frames")
        if float(video.std()) < 1e-3 or int(out.max()) == int(out.min()):
            raise AssertionError(f"round {i}: constant frames")
        log(f"[main] round {i}: frames {out.shape} uint8, decoded float "
            f"mean {float(video.mean()):.4f} std {float(video.std()):.4f}")
    return chat.round_times


def default_run():
    import jax

    from open_pandora_tpu.core.cache import enable_compilation_cache

    dev = require_gpu()
    log(f"card: {card_line()}")
    log(f"jax {jax.__version__}; device {dev.device_kind}; "
        f"compile cache {enable_compilation_cache()}")

    failures = attention_parity()
    if failures:
        raise SystemExit(f"attention parity failed at {failures}")

    times = main_path(["--image", "-", "--action", "-", "--ddim-steps", "50",
                       "--height", "320", "--width", "512"],
                      320, 512, 16, 50,
                      ["the car drives forward along the road",
                       "the car turns left at the crossing"])
    for i, (c, s, d) in enumerate(times):
        first = " (first round: includes compilation)" if i == 0 else ""
        log(f"[main] round {i} seconds: conditioning {c:.3f}, sampling "
            f"{s:.3f}, decode {d:.3f}{first}")
    stats = dev.memory_stats() or {}
    log(f"[main] peak_bytes_in_use {stats.get('peak_bytes_in_use')}")


def _spread(x):
    """Number of devices holding shards of `x` (1 = all on one device)."""
    return len({s.device for s in x.addressable_shards})


def dp_zero2_step(model, params, height, width, devices):
    """(a) one DP + ZeRO-2 finetune step over a (len(devices) x 1) mesh, the
    global batch of DP_GLOBAL_BATCH samples split over the devices, against
    value_and_grad + the optimizer update over the same global batch on
    devices[0] under "highest" precision. `params`: float32, on
    devices[0]."""
    import functools

    import jax
    import jax.numpy as jnp
    import optax

    from open_pandora_tpu.core.config import MeshConfig
    from open_pandora_tpu.parallel.mesh import build_mesh
    from open_pandora_tpu.train.optim import (make_optimizer,
                                               trainable_partition)
    from open_pandora_tpu.train.step import (TrainState, _finetune_loss,
                                             make_finetune_step)

    n, cfg = len(devices), model.cfg
    tcfg = cfg.train
    nb, t = DP_GLOBAL_BATCH, cfg.unet.temporal_length
    kv, kc, ki = jax.random.split(jax.random.PRNGKey(1), 3)
    batch = {
        "video": jax.random.uniform(kv, (nb, t, height, width, 3)) * 2 - 1,
        "cond_frames": jax.random.uniform(kc, (nb, 1, height, width, 3))
        * 2 - 1,
        "cond_images": jax.random.uniform(ki, (nb, height, width, 3)),
        "text_tokens": jnp.arange(nb * cfg.clip_text.context_length,
                                  dtype=jnp.int32).reshape(nb, -1) % 1000,
        "fps": jnp.full((nb,), 8, jnp.int32),
    }
    key = jax.random.PRNGKey(2)
    tx = make_optimizer(tcfg)

    lfn = functools.partial(_finetune_loss, model, tcfg)
    one = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, devices[0]),
        (*trainable_partition(params, "dynamicrafter"), batch, key))
    with jax.default_matmul_precision("highest"):
        t0 = time.perf_counter()
        (loss1, _), grads = jax.jit(jax.value_and_grad(lfn, has_aux=True))(
            *one)
        upd, _ = jax.jit(tx.update)(grads, tx.init(one[0]), one[0])
        new1 = jax.device_get(optax.apply_updates(one[0], upd))
        loss1, gnorm1 = float(loss1), float(optax.global_norm(grads))
    log(f"[dp] one-device reference (incl. compile) "
        f"{time.perf_counter() - t0:.1f}s: loss {loss1:.6f} "
        f"grad_norm {gnorm1:.6f}")
    del one, grads, upd

    mesh = build_mesh(MeshConfig(data_parallel=n, model_parallel=1),
                      devices=devices)
    step, tx = make_finetune_step(model, tcfg, mesh_spec=mesh)
    state = step.shard_state(TrainState.create(params, "dynamicrafter", tx))
    t0 = time.perf_counter()
    new_state, metrics = step(state, batch, key)
    loss4, gnorm4 = float(metrics["loss"]), float(metrics["grad_norm"])
    log(f"[dp] {n}-device step (incl. compile) "
        f"{time.perf_counter() - t0:.1f}s: loss {loss4:.6f} "
        f"grad_norm {gnorm4:.6f}")
    moments = [x for x in jax.tree_util.tree_leaves(new_state.opt_state)
               if getattr(x, "ndim", 0) >= 2]
    spread = min(_spread(x) for x in moments)
    log(f"[dp] optimizer moments over {spread} devices; params over "
        f"{_spread(jax.tree_util.tree_leaves(new_state.trainable)[0])}")
    if spread < n:
        raise AssertionError("ZeRO-2 moments were not sharded")
    new4 = jax.device_get(new_state.trainable)
    del state, new_state

    lr = tcfg.learning_rate
    total = count = 0
    worst = 0.0
    for a, b in zip(jax.tree_util.tree_leaves(new4),
                    jax.tree_util.tree_leaves(new1)):
        d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
        total += float(d.sum(dtype=np.float64))
        count += d.size
        worst = max(worst, float(d.max()))
    mean_lr, max_lr = total / count / lr, worst / lr
    loss_rel = abs(loss4 - loss1) / abs(loss1)
    gnorm_rel = abs(gnorm4 - gnorm1) / gnorm1
    ok = (loss_rel <= DP_LOSS_RTOL and gnorm_rel <= DP_GNORM_RTOL
          and mean_lr <= DP_UPDATE_TOL)
    log(f"[dp] loss rel {loss_rel:.3e} (tol {DP_LOSS_RTOL:g}), grad_norm rel "
        f"{gnorm_rel:.3e} (tol {DP_GNORM_RTOL:g}), updated params mean|d| "
        f"{mean_lr:.3e} lr (tol {DP_UPDATE_TOL:g}), max|d| {max_lr:.3f} lr "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("DP + ZeRO-2 step disagrees with one device")


def sharded_inference(model, params, height, width, devices):
    """(b) sharded_synthesis with the two CFG streams over 2 devices and
    sharded_decode with the frames over all devices, each against the
    same call on devices[0]. `params`: the bf16 weights, on devices[0]."""
    import jax
    import jax.numpy as jnp

    from open_pandora_tpu.core.config import MeshConfig
    from open_pandora_tpu.parallel.mesh import build_mesh, replicated
    from open_pandora_tpu.parallel.sharded_infer import (sharded_decode,
                                                         sharded_synthesis)

    u, n = model.cfg.unet, len(devices)
    kw = dict(
        text_context=(0.2 * jax.random.normal(jax.random.PRNGKey(3), (
            1, u.text_context_len, u.context_dim))).astype(jnp.bfloat16),
        cond_images=jnp.asarray(smoke_image(height, width), jnp.float32)[None]
        / 255.0,
        cond_frames=jnp.asarray(smoke_image(height, width, 1),
                                jnp.float32)[None, None] / 127.5 - 1.0,
        key=jax.random.PRNGKey(4), ddim_steps=INFER_DDIM_STEPS,
        guidance_scale=4.0, fs=15)

    def compare(name, got, ref, n_dev):
        got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
        rel = float(np.abs(got - ref).max()) / float(np.abs(ref).max())
        ok = np.isfinite(got).all() and rel <= INFER_RTOL
        log(f"[infer] {name}: max|d|/max|ref| {rel:.3e} (tol {INFER_RTOL:g})"
            f" over {n_dev} devices {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with one device")

    mesh2 = build_mesh(MeshConfig(data_parallel=2, model_parallel=1),
                       devices=devices[:2])
    z2 = jax.jit(lambda p: sharded_synthesis(model, mesh2, p, **kw))(
        jax.device_put(params, replicated(mesh2)))
    z1 = jax.jit(lambda p: model.image_guided_synthesis(p, **kw))(params)
    compare(f"sharded_synthesis ({INFER_DDIM_STEPS} DDIM steps)", z2, z1, 2)

    mesh_n = build_mesh(MeshConfig(data_parallel=n, model_parallel=1),
                        devices=devices)
    chunk = u.temporal_length // n
    zn = jax.device_put(z1, mesh_n.named(None, mesh_n.data_axis))
    frames_n = jax.jit(lambda p, z: sharded_decode(
        model, mesh_n, p, z, frame_chunk=chunk))(
            jax.device_put(params, replicated(mesh_n)), zn)
    log(f"[infer] decoded frames over {_spread(frames_n)} devices")
    if _spread(frames_n) < n:
        raise AssertionError("sharded_decode left the frames on one device")
    frames_1 = jax.jit(lambda p, z: model.decode(p, z, frame_chunk=chunk))(
        params, z1)
    compare("sharded_decode", frames_n, frames_1, n)


def four_card_run():
    import os

    # before JAX starts its backend: the one-card reference of the training
    # step holds the global batch on one card, so give JAX 90% of each
    # card; and compile time is most of this check's cost, so it compiles
    # without autotuning (both sides of every comparison alike)
    os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.9")
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_gpu_autotune_level=0").strip()
    import jax
    import jax.numpy as jnp

    from open_pandora_tpu.core.cache import enable_compilation_cache
    from open_pandora_tpu.core.config import PandoraConfig
    from open_pandora_tpu.models.dynamicrafter import (DynamiCrafter,
                                                       random_params)

    require_gpu()
    log(f"card: {card_line()}")
    enable_compilation_cache()
    devices = jax.devices()
    if len(devices) != 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, found {len(devices)}")
    cfg = PandoraConfig()
    t0 = time.perf_counter()
    with jax.default_device(devices[0]):
        params = random_params(DynamiCrafter(cfg), 0, zero_std=1e-2)
        params_bf16 = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x,
            params)
    log(f"[init] random float32 and bf16 weights in "
        f"{time.perf_counter() - t0:.1f}s")
    dp_zero2_step(DynamiCrafter(cfg), params, 320, 512, devices)
    del params
    sharded_inference(DynamiCrafter(cfg, dtype=jnp.bfloat16), params_bf16,
                      320, 512, devices)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device phases, on four cards")
    args = ap.parse_args(argv)
    if args.four_cards:
        four_card_run()
    else:
        default_run()
    import jax
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
