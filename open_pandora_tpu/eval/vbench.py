"""VBench-I2V generation harness.

Behavioral spec: /root/reference/tools/vbench.py:76-113 — iterate
vbench2_i2v_full_info.json, for each (image_name, prompt_en) generate
n_samples clips (DDIM 50, ugs 7.5, fs 8) from the cropped image dir and
write per-sample mp4s named by prompt for the external VBench scorer.

Additions: per-host sharding of the metadata list (jax.process_index —
the reference shards manually via --start_id/--end_id) and deterministic
per-sample seeds.

Usage:
  python -m open_pandora_tpu.eval.vbench --vbench-data DIR --save-dir OUT \
      [--ckpt PATH] [--img-crop 8-5] [--ddim-steps 50] [--ugs 7.5] [--fs 8]
      [--n-samples 5] [--debug]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser():
    p = argparse.ArgumentParser("vbench-i2v")
    p.add_argument("--vbench-data", required=True)
    p.add_argument("--save-dir", required=True)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--img-crop", default="8-5")
    p.add_argument("--ddim-steps", type=int, default=50)
    p.add_argument("--fs", type=int, default=8)
    p.add_argument("--n-samples", type=int, default=5)
    p.add_argument("--ugs", type=float, default=7.5)
    p.add_argument("--eta", type=float, default=1.0)
    p.add_argument("--start-id", type=int, default=0)
    p.add_argument("--end-id", type=int, default=int(1e9))
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--quantize-llm", nargs="?", const="int8",
                   choices=["int8", "nf4"], default=False)
    p.add_argument("--debug", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from open_pandora_tpu.core.cache import enable_compilation_cache
    enable_compilation_cache()
    from open_pandora_tpu.parallel.launch import init_distributed
    init_distributed()

    import jax
    from PIL import Image

    from open_pandora_tpu.parallel.mesh import process_shard_indices

    os.makedirs(args.save_dir, exist_ok=True)
    meta_file = os.path.join(args.vbench_data, "vbench2_i2v_full_info.json")
    with open(meta_file) as f:
        meta = json.load(f)[args.start_id: args.end_id]
    crop_dir = os.path.join(args.vbench_data, "crop", args.img_crop)

    # per-host sharding (replaces manual --start/--end fan-out)
    shard = [meta[i] for i in process_shard_indices(len(meta))]

    chat = _build_chat(args)

    for m in shard:
        img = Image.open(os.path.join(crop_dir, m["image_name"]))
        prompt = m["prompt_en"]
        for s in range(args.n_samples):
            frames = chat.generate_video(
                img, prompt, ddim_steps=args.ddim_steps, fs=args.fs,
                guidance_scale=args.ugs, eta=args.eta, seed=s)
            suffix = f"-{s}" if args.n_samples > 1 else ""
            chat.save_video(
                os.path.join(args.save_dir, f"{prompt}{suffix}.mp4"),
                frames, fps=8)
        print(f"[vbench] {m['image_name']}: {args.n_samples} samples",
              flush=True)
    return 0


def _build_chat(args):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from open_pandora_tpu.core.config import PandoraConfig
    from open_pandora_tpu.models.world_model import WorldModel
    from open_pandora_tpu.pipeline.chat_wm import ChatWM
    from open_pandora_tpu.pipeline.tokenizers import load_tokenizer

    if args.debug:
        from tests.test_llm_stack import TINY_LLAMA, TINY_QF, TINY_CONN
        from tests.test_dynamicrafter import TINY as TINY_DC, H, W
        from open_pandora_tpu.core.config import CLIPTowerConfig, ClusterConfig
        cfg = dataclasses.replace(
            TINY_DC, llama=TINY_LLAMA,
            clip_tower=CLIPTowerConfig(image_size=28, patch_size=14, width=64,
                                       layers=2, heads=2),
            cluster=ClusterConfig(spatial_rates=(2, 1, 1), temporal_rate=0.5),
            qformer=TINY_QF, connector=TINY_CONN)
        height, width = H, W
        args.ddim_steps = min(args.ddim_steps, 2)
        dtype = jnp.float32
    else:
        cfg = PandoraConfig()
        height, width = args.height, args.width
        dtype = jnp.bfloat16

    wm = WorldModel(cfg, dtype=dtype,
                    quantize_llm=getattr(args, "quantize_llm", False))
    if args.ckpt:
        from open_pandora_tpu.core.checkpoint import load_params
        params = load_params(args.ckpt, wm, height=height, width=width)
    else:
        params = jax.jit(lambda: jax.tree_util.tree_map(
            lambda p: p.astype(dtype) if p.dtype == jnp.float32 else p,
            wm.init_params(jax.random.PRNGKey(0), height=height,
                           width=width)))()
    return ChatWM(wm, params, tokenizer=load_tokenizer(args.tokenizer),
                  height=height, width=width)


if __name__ == "__main__":
    sys.exit(main())
