"""ScienceQA multi-choice runner + scorer.

Behavioral spec:
- /root/reference/ChatUniVi/eval/model_vqa_scienceqa.py — two-stage
  decode per question: (1) generate free-form reasoning from the
  conversation prompt, (2) re-prompt with `reasoning + ' ###\nANSWER:'`,
  read the FIRST generated token's pre-softmax logits
  (output_scores=True, scores[0][0], :101-125) and score every candidate
  letter whose "(X)" literal appears in the question; pred = argmax.
  Output record: {question_id, prompt, text, answer_id, model_id, pred,
  metadata} with text = reasoning + '\n The answer is ' + short answer.
- /root/reference/ChatUniVi/eval/evaluate/evaluate_science_qa.py — scorer:
  regex `The answer is ([A-Z]).` over text (fallback to pred), map letter
  to choice index (random choice when the letter is out of range,
  :28-35), accuracy overall + by subject (NAT/SOC/LAN), context modality
  (TXT/IMG/NO) and grade band (G1-6/G7-12).

Deviations (documented): greedy decode by default instead of
temperature-0.2 sampling (deterministic here; --temperature restores
sampling), and max-new-tokens defaults sized for smoke runs.

Usage:
  python -m open_pandora_tpu.eval.scienceqa run --questions q.json \
      --image-folder DIR --out answers.jsonl [--ckpt ...] [--debug]
  python -m open_pandora_tpu.eval.scienceqa score --base-dir DIR \
      --result-file answers.jsonl --output-file out.json \
      --output-result result.json [--split test]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import sys

ANSWER_LETTERS = [chr(ord("A") + i) for i in range(26)]


# ------------------------------------------------------------------ runner
def run(args) -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from PIL import Image

    from open_pandora_tpu.eval.chatunivi_qa import (decode_ids, get_chunk,
                                                    segments_from_prompt,
                                                    setup_model, strip_stop)
    from open_pandora_tpu.models.llama_generate import (first_token_logits,
                                                        greedy_generate)
    from open_pandora_tpu.models.world_model import (MultimodalPrompt,
                                                     TokenSegment)
    from open_pandora_tpu.pipeline.conversation import (SeparatorStyle,
                                                        conv_templates)
    from open_pandora_tpu.pipeline.preprocess import clip_tower_preprocess

    wm, params, tok, _, _ = setup_model(args.ckpt, args.tokenizer,
                                        args.debug)
    tower_size = wm.cfg.clip_tower.image_size
    max_new = 4 if args.debug else args.max_new_tokens

    with open(os.path.expanduser(args.questions)) as f:
        questions = json.load(f)
    questions = get_chunk(questions, args.num_chunks, args.chunk_idx)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    key = jax.random.PRNGKey(args.seed)

    def generate(segs, images, n_tok, k):
        prompt = MultimodalPrompt(segments=segs, images=images)
        embeds, _ = wm.build_inputs_embeds(params, prompt)
        out = greedy_generate(wm.llama, params["llama"], embeds,
                              max_new_tokens=n_tok,
                              temperature=args.temperature, key=k)
        return embeds, decode_ids(tok, out[0])

    with open(os.path.expanduser(args.out), "w") as fout:
        for i, line in enumerate(questions):
            idx = line["id"]
            qs = line["conversations"][0]["value"].replace(
                "<image>", "").strip()
            cur_prompt = qs
            images = None
            n_img = 0
            if "image" in line:
                path = os.path.join(args.image_folder,
                                    line["image"].replace("\\", "/"))
                arr = clip_tower_preprocess(Image.open(path), tower_size)
                images = jnp.asarray(np.stack([arr]))[None]
                qs = "<image>\n" + qs
                cur_prompt = "<image>\n" + cur_prompt
                n_img = 1

            conv = conv_templates[args.conv_mode].copy()
            conv.append_message(conv.roles[0], qs)
            conv.append_message(conv.roles[1], None)
            prompt = conv.get_prompt()
            stop_str = (conv.sep if conv.sep_style != SeparatorStyle.TWO
                        else conv.sep2)

            # stage 1: free-form reasoning
            segs = segments_from_prompt(tok, prompt, n_img)
            k1 = jax.random.fold_in(key, 2 * i)
            _, reasoning = generate(segs, images, max_new, k1)
            reasoning = strip_stop(reasoning, stop_str)

            # stage 2: answer-letter scoring off the first-token logits
            prompt2 = prompt + reasoning + " ###\nANSWER:"
            segs2 = segments_from_prompt(tok, prompt2, n_img)
            prompt_mm = MultimodalPrompt(segments=segs2, images=images)
            embeds2, _ = wm.build_inputs_embeds(params, prompt_mm)
            scores = np.asarray(
                first_token_logits(wm.llama, params["llama"], embeds2)[0],
                np.float32)

            candidates = [c for c in ANSWER_LETTERS
                          if "(" + c + ")" in cur_prompt]
            if not candidates:
                candidates = ["A"]
            label_score = [float(scores[tok.encode(c)[-1]])
                           for c in candidates]
            pred = candidates[int(np.argmax(label_score))]

            k2 = jax.random.fold_in(key, 2 * i + 1)
            out = greedy_generate(wm.llama, params["llama"], embeds2,
                                  max_new_tokens=min(64, max_new),
                                  temperature=args.temperature, key=k2)
            short = strip_stop(decode_ids(tok, out[0]), stop_str)
            text = reasoning + "\n The answer is " + short

            fout.write(json.dumps({
                "question_id": idx, "prompt": cur_prompt, "text": text,
                "answer_id": f"sqa-{idx}", "model_id": "open-pandora-tpu",
                "pred": pred, "metadata": {}}) + "\n")
            fout.flush()
    print(f"[scienceqa] wrote {len(questions)} answers -> {args.out}",
          flush=True)
    return 0


# ------------------------------------------------------------------ scorer
def get_pred_idx(prediction: str, choices, options):
    """evaluate_science_qa.py:28-35 — letter -> choice index; random
    in-range index when the parsed letter is invalid."""
    if prediction in options[: len(choices)]:
        return options.index(prediction)
    return random.choice(range(len(choices)))


def score_predictions(problems, split_indices, predictions,
                      options=("A", "B", "C", "D", "E")):
    """evaluate_science_qa.py main loop. Returns (results, sqa_results)."""
    options = list(options)
    results = {"correct": [], "incorrect": []}
    sqa = {"acc": None, "correct": None, "count": None, "results": {},
           "outputs": {}, "NAT": [], "SOC": [], "LAN": [], "TXT": [],
           "IMG": [], "NO": [], "G1-6": [], "G7-12": []}
    pattern = re.compile(r"The answer is ([A-Z]).")

    for prob_id in split_indices:
        prob = problems[prob_id]
        if prob_id not in predictions:
            continue
        pred = predictions[prob_id]
        res = pattern.findall(pred["text"])
        answer = res[0] if len(res) == 1 else pred["pred"]
        pred_idx = get_pred_idx(answer, prob["choices"], options)

        analysis = {"question_id": prob_id, "parsed_ans": answer,
                    "ground_truth": options[prob["answer"]],
                    "question": pred["prompt"], "pred": pred["text"],
                    "is_multimodal": "<image>" in pred["prompt"]}
        sqa["results"][prob_id] = get_pred_idx(answer, prob["choices"],
                                               options)
        sqa["outputs"][prob_id] = pred["text"]

        cur = 1 if pred_idx == prob["answer"] else 0
        results["correct" if cur else "incorrect"].append(analysis)
        subject = {"natural science": "NAT", "social science": "SOC",
                   "language science": "LAN"}.get(prob.get("subject"))
        if subject:
            sqa[subject].append(cur)
        if prob.get("hint"):
            sqa["TXT"].append(cur)
        if prob.get("image"):
            sqa["IMG"].append(cur)
        if not prob.get("hint") and not prob.get("image"):
            sqa["NO"].append(cur)
        grade = prob.get("grade", "")
        if grade in [f"grade{g}" for g in range(1, 7)]:
            sqa["G1-6"].append(cur)
        elif grade in [f"grade{g}" for g in range(7, 13)]:
            sqa["G7-12"].append(cur)

    correct = len(results["correct"])
    total = correct + len(results["incorrect"])
    sqa["acc"] = correct / total * 100 if total else 0.0
    sqa["correct"] = correct
    sqa["count"] = total
    return results, sqa


def score(args) -> int:
    base = args.base_dir
    with open(os.path.join(base, "pid_splits.json")) as f:
        split_indices = json.load(f)[args.split]
    with open(os.path.join(base, "problems.json")) as f:
        problems = json.load(f)
    predictions = {}
    with open(args.result_file) as f:
        for line in f:
            if line.strip():
                rec = json.loads(line)
                predictions[rec["question_id"]] = rec

    results, sqa = score_predictions(problems, split_indices, predictions,
                                     args.options)
    print(f"Total: {sqa['count']}, Correct: {sqa['correct']}, "
          f"Accuracy: {sqa['acc']:.2f}%")
    for k in ("NAT", "SOC", "LAN", "TXT", "IMG", "NO", "G1-6", "G7-12"):
        n = len(sqa[k])
        acc = (sum(sqa[k]) / n * 100) if n else 0.0
        print(f"{k}: {n}, Correct: {sum(sqa[k])}, Accuracy: {acc:.2f}%")
    if args.output_file:
        with open(args.output_file, "w") as f:
            json.dump(results, f, indent=2)
    if args.output_result:
        with open(args.output_result, "w") as f:
            json.dump(sqa, f, indent=2)
    return 0


def build_parser():
    p = argparse.ArgumentParser("scienceqa")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run")
    r.add_argument("--questions", required=True)
    r.add_argument("--image-folder", default="")
    r.add_argument("--out", required=True)
    r.add_argument("--ckpt", default=None)
    r.add_argument("--tokenizer", default=None)
    r.add_argument("--conv-mode", default="simple")
    r.add_argument("--num-chunks", type=int, default=1)
    r.add_argument("--chunk-idx", type=int, default=0)
    r.add_argument("--max-new-tokens", type=int, default=64)
    r.add_argument("--temperature", type=float, default=0.0)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--debug", action="store_true")
    r.set_defaults(fn=run)

    s = sub.add_parser("score")
    s.add_argument("--base-dir", required=True)
    s.add_argument("--result-file", required=True)
    s.add_argument("--output-file", default=None)
    s.add_argument("--output-result", default=None)
    s.add_argument("--split", default="test")
    s.add_argument("--options", nargs="+",
                   default=["A", "B", "C", "D", "E"])
    s.set_defaults(fn=score)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
