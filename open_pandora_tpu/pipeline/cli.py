"""CLI — the app entrypoint (replaces /root/reference/gradio_app.py).

Usage:
  python -m open_pandora_tpu.pipeline.cli --image car.png \
      --action "the car moves forward" --action "the car turns left" \
      --out out.mp4 [--ddim-steps 50 --ugs 4.0 --eta 1.0 --fs 15 --seed 123]
      [--ckpt /path/to/orbax_or_torch_ckpt] [--tokenizer /path]
      [--height 320 --width 512] [--debug]

--debug runs the full pipeline with RANDOM weights and 2 DDIM steps on a
tiny config (the reference's --debug no-model stub, gradio_app.py:120-126 —
ours still exercises the real code path).
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("open-pandora-tpu")
    p.add_argument("--image", required=True, help="conditioning image")
    p.add_argument("--action", action="append", required=True,
                   help="per-round action text (repeat for multi-round)")
    p.add_argument("--out", default="output.mp4")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint dir (orbax) or torch .bin/.ckpt to convert")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--ddim-steps", type=int, default=50)
    p.add_argument("--ugs", type=float, default=4.0, help="guidance scale")
    p.add_argument("--eta", type=float, default=1.0)
    p.add_argument("--fs", type=int, default=15)
    p.add_argument("--fps", type=int, default=8, help="output fps")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--quantize-llm", nargs="?", const="int8",
                   choices=["int8", "nf4"], default=False,
                   help="weight-only LLaMA quantization (default int8; "
                        "nf4 = blockwise 4-bit)")
    p.add_argument("--debug", action="store_true",
                   help="tiny config + random weights smoke mode")
    return p


def build_chat(args):
    """Build the ChatWM session from parsed CLI args (shared by the CLI
    and the web server, pipeline/server.py)."""
    from open_pandora_tpu.core.cache import enable_compilation_cache
    enable_compilation_cache()

    import jax
    import jax.numpy as jnp

    from open_pandora_tpu.core.config import PandoraConfig
    from open_pandora_tpu.models.world_model import WorldModel
    from open_pandora_tpu.pipeline.chat_wm import ChatWM
    from open_pandora_tpu.pipeline.tokenizers import load_tokenizer

    if args.debug:
        from tests.test_llm_stack import TINY_LLAMA, TINY_QF, TINY_CONN
        from tests.test_dynamicrafter import TINY as TINY_DC, H, W
        import dataclasses
        from open_pandora_tpu.core.config import (CLIPTowerConfig,
                                                  ClusterConfig)
        cfg = dataclasses.replace(
            TINY_DC, llama=TINY_LLAMA,
            clip_tower=CLIPTowerConfig(image_size=28, patch_size=14,
                                       width=64, layers=2, heads=2),
            cluster=ClusterConfig(spatial_rates=(2, 1, 1), temporal_rate=0.5),
            qformer=TINY_QF, connector=TINY_CONN)
        height, width = H, W
        args.ddim_steps = min(args.ddim_steps, 2)
        dtype = jnp.float32
    else:
        cfg = PandoraConfig()
        height, width = args.height, args.width
        dtype = jnp.bfloat16 if args.bf16 else jnp.float32

    print(f"[cli] building WorldModel ({'debug-tiny' if args.debug else 'full'})",
          flush=True)
    wm = WorldModel(cfg, dtype=dtype,
                    quantize_llm=getattr(args, "quantize_llm", False))
    if args.ckpt:
        from open_pandora_tpu.core.checkpoint import load_params
        params = load_params(args.ckpt, wm, height=height, width=width)
    else:
        from open_pandora_tpu.models.dynamicrafter import random_params
        print("[cli] NO CHECKPOINT — random weights (smoke mode)", flush=True)
        params = random_params(wm, 0, dtype)

    return ChatWM(wm, params, tokenizer=load_tokenizer(args.tokenizer),
                  height=height, width=width)


def read_image(path: str):
    """uint8 (H, W, 3) RGB array from an image file (needs Pillow)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading --image needs Pillow (PIL), which is "
                          "not installed") from e
    import numpy as np
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def main(argv=None):
    args = build_parser().parse_args(argv)
    chat = build_chat(args)
    img = read_image(args.image)
    frames = chat.generate_video_multiround(
        img, args.action, ddim_steps=args.ddim_steps,
        guidance_scale=args.ugs, eta=args.eta, fs=args.fs, seed=args.seed)
    path = chat.save_video(args.out, frames, fps=args.fps)
    print(f"[cli] wrote {path}: {frames.shape[0]} frames "
          f"{frames.shape[2]}x{frames.shape[1]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
