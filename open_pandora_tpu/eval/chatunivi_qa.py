"""ChatUniVi benchmark runner — image/video QA over fixed question sets.

Behavioral spec: /root/reference/ChatUniVi/eval/model_video_qa.py (and the
model_vqa*/model_coco_vqa variants): read a json/jsonl question set, chunk
it across workers (get_chunk :23-31), for each question decode frames,
build the conversation prompt with <image>/<video> markers, greedy-generate
an answer, append {id, question, answer, ...} to an output jsonl. The
GPT-3.5 judging scripts (eval/evaluate/*) consume that jsonl — judging
needs an external API and is out of scope here; the generation side is the
runner below.

Usage:
  python -m open_pandora_tpu.eval.chatunivi_qa --questions q.jsonl \
      --media-dir DIR --out answers.jsonl [--ckpt ...] [--tokenizer ...]
      [--num-chunks N --chunk-idx I] [--max-new-tokens 64] [--debug]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys


def get_chunk(items, num_chunks: int, idx: int):
    """eval/model_video_qa.py:23-31: contiguous split."""
    size = math.ceil(len(items) / num_chunks)
    return items[idx * size: (idx + 1) * size]


def load_questions(path: str):
    with open(path) as f:
        if path.endswith(".jsonl"):
            return [json.loads(ln) for ln in f if ln.strip()]
        return json.load(f)


def build_parser():
    p = argparse.ArgumentParser("chatunivi-qa")
    p.add_argument("--questions", required=True)
    p.add_argument("--media-dir", default=".")
    p.add_argument("--out", required=True)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--num-chunks", type=int, default=1)
    p.add_argument("--chunk-idx", type=int, default=0)
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--video-frames", type=int, default=16)
    p.add_argument("--debug", action="store_true")
    return p


def setup_model(ckpt=None, tokenizer=None, debug: bool = False):
    """Build (wm, params, tok, height, width) — shared by every ChatUniVi
    eval runner (this file, scienceqa.py, consistency.py). In --debug mode
    a tiny random-weight config is used so runners smoke-test on CPU."""
    from open_pandora_tpu.core.cache import enable_compilation_cache
    enable_compilation_cache()

    import dataclasses

    import jax

    from open_pandora_tpu.models.world_model import WorldModel
    from open_pandora_tpu.pipeline.tokenizers import load_tokenizer

    if debug:
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
    else:
        from open_pandora_tpu.core.config import PandoraConfig
        cfg = PandoraConfig()
        height, width = 320, 512

    wm = WorldModel(cfg)
    if ckpt:
        from open_pandora_tpu.core.checkpoint import load_params
        params = load_params(ckpt, wm, height=height, width=width)
    else:
        print("[qa] NO CHECKPOINT — random weights (smoke mode)", flush=True)
        params = wm.init_params(jax.random.PRNGKey(0), height=height,
                                width=width)
    tok = load_tokenizer(tokenizer)
    return wm, params, tok, height, width


def decode_ids(tok, out_ids) -> str:
    """Decode a (n,) id row from greedy_generate, skipping specials."""
    import numpy as np
    ids_list = [int(i) for i in np.asarray(out_ids)]
    if hasattr(tok, "tok"):
        return tok.tok.decode(ids_list, skip_special_tokens=True)
    return " ".join(str(i) for i in ids_list)


def segments_from_prompt(tok, prompt: str, n_images: int = 0):
    """Split a rendered conversation prompt on the '<image>' sentinel into
    Token/Image/Video segments (mm_utils.tokenizer_image_token semantics:
    ChatUniVi/mm_utils.py — text chunks tokenized separately, one media
    slot per sentinel). A run of n_images>1 sentinels becomes one
    VideoSegment over images[0..n_images); a single sentinel an
    ImageSegment."""
    import jax.numpy as jnp

    from open_pandora_tpu.models.world_model import (ImageSegment,
                                                     TokenSegment,
                                                     VideoSegment)
    parts = prompt.split("<image>")
    # collapse a run of consecutive sentinels ('' between parts) into one slot
    segs, used = [], 0
    first = tok.encode(parts[0], add_bos=True)
    segs.append(TokenSegment(jnp.asarray([first], jnp.int32)))
    pending = 0
    for piece in parts[1:]:
        pending += 1
        if piece == "" :
            continue
        if pending == 1:
            segs.append(ImageSegment(used))
        else:
            segs.append(VideoSegment(tuple(range(used, used + pending))))
        used += pending
        pending = 0
        ids = tok.encode(piece, add_bos=False)
        if ids:
            segs.append(TokenSegment(jnp.asarray([ids], jnp.int32)))
    if pending:
        if pending == 1:
            segs.append(ImageSegment(used))
        else:
            segs.append(VideoSegment(tuple(range(used, used + pending))))
        used += pending
    assert used == n_images, f"prompt has {used} media slots, got {n_images}"
    return segs


def strip_stop(text: str, stop_str: str) -> str:
    """model_video_qa.py tail handling: cut at the separator, strip."""
    if stop_str and stop_str in text:
        text = text.split(stop_str)[0]
    text = text.strip()
    if stop_str and text.endswith(stop_str):
        text = text[: -len(stop_str)]
    return text.strip()


def main(argv=None):
    args = build_parser().parse_args(argv)

    import jax.numpy as jnp
    import numpy as np
    from PIL import Image

    from open_pandora_tpu.models.llama_generate import greedy_generate
    from open_pandora_tpu.models.world_model import (ImageSegment,
                                                     MultimodalPrompt,
                                                     TokenSegment,
                                                     VideoSegment)
    from open_pandora_tpu.pipeline.preprocess import clip_tower_preprocess
    from open_pandora_tpu.utils.video_io import read_video_frames

    if args.debug:
        args.max_new_tokens = min(args.max_new_tokens, 4)
    wm, params, tok, height, width = setup_model(args.ckpt, args.tokenizer,
                                                 args.debug)
    tower_size = wm.cfg.clip_tower.image_size

    questions = get_chunk(load_questions(args.questions), args.num_chunks,
                          args.chunk_idx)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    with open(args.out, "w") as fout:
        for q in questions:
            text = q.get("text") or q.get("question") or ""
            ids = jnp.asarray([tok.encode(text, add_bos=True)], jnp.int32)
            segments = [TokenSegment(ids[:, :1])]
            images = []
            if q.get("video"):
                frames, _ = read_video_frames(
                    os.path.join(args.media_dir, q["video"]),
                    num_frames=args.video_frames)
                for fr in frames:
                    images.append(clip_tower_preprocess(fr, tower_size))
                segments.append(VideoSegment(tuple(range(len(images)))))
            elif q.get("image"):
                img = Image.open(os.path.join(args.media_dir, q["image"]))
                images.append(clip_tower_preprocess(img, tower_size))
                segments.append(ImageSegment(0))
            segments.append(TokenSegment(ids[:, 1:]))
            img_arr = (jnp.asarray(np.stack(images))[None]
                       if images else None)
            prompt = MultimodalPrompt(segments=segments, images=img_arr)

            embeds, _ = wm.build_inputs_embeds(params, prompt)
            out_ids = greedy_generate(wm.llama, params["llama"], embeds,
                                      max_new_tokens=args.max_new_tokens)
            ids_list = [int(i) for i in np.asarray(out_ids[0])]
            answer = (tok.tok.decode(ids_list, skip_special_tokens=True)
                      if hasattr(tok, "tok") else
                      " ".join(str(i) for i in ids_list))
            rec = {"id": q.get("id") or q.get("question_id"),
                   "question": text, "answer": answer}
            fout.write(json.dumps(rec) + "\n")
            fout.flush()
    print(f"[qa] wrote {len(questions)} answers -> {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
