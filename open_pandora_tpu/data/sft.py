"""ChatUniVi supervised-finetuning data path.

Behavioral spec: /root/reference/ChatUniVi/train/train.py:298-848 —
`preprocess_multimodal` (:298, <image>/<video> normalization, the 64-frame
cap), `preprocess_v1` (:427, vicuna-TWO-template tokenization with human
turns masked to IGNORE_INDEX), `LazySupervisedDataset` (:644, lazy JSON
conversation records with image/video sidecars) and
`DataCollatorForSupervisedDataset` (:799) — plus `tokenizer_image_token`
(mm_utils.py:18, split-on-<image> sentinel insertion).

Reformulation: instead of ragged (input_ids, labels) consumed by
a dynamic splice, preprocessing lowers each conversation to the repo's
static `MultimodalPrompt` segment layout (TokenSegment / ImageSegment /
VideoSegment) plus per-token labels, padded to a fixed bucket so XLA sees
one shape per (layout signature, bucket) pair. Every padded chunk carries
a real-token mask: batches can mix chunk lengths (multi-turn, or an image
after turn 1), so mid-sequence pads exist and must be masked out of
attention and made position-transparent (train/llm_step.py sft_loss).
"""

from __future__ import annotations

import copy
import json
import logging
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from open_pandora_tpu.pipeline.conversation import (Conversation,
                                                    SeparatorStyle,
                                                    conv_templates)

log = logging.getLogger("open_pandora_tpu.data.sft")

IGNORE_INDEX = -100
IMAGE_SENTINEL = -200          # ChatUniVi/constants.py IMAGE_TOKEN_INDEX
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_VIDEO_TOKEN = "<video>"
MAX_IMAGE_LENGTH = 64          # ChatUniVi/constants.py:7


def tokenize_with_images(prompt: str, tokenizer,
                         add_bos: bool = True) -> List[int]:
    """mm_utils.py:18 tokenizer_image_token: tokenize around `<image>`
    splits and insert IMAGE_SENTINEL at each boundary. BOS is kept only
    from the first chunk."""
    chunks = [tokenizer.encode(c, add_bos=(add_bos and i == 0))
              for i, c in enumerate(prompt.split(DEFAULT_IMAGE_TOKEN))]
    ids: List[int] = []
    for i, c in enumerate(chunks):
        if i > 0:
            ids.append(IMAGE_SENTINEL)
        ids.extend(c)
    return ids


def preprocess_multimodal(sources: Sequence[List[Dict]],
                          max_image_length: int = MAX_IMAGE_LENGTH,
                          ) -> List[List[Dict]]:
    """train.py:298-336: move trailing image/video runs to the front,
    cap <image> runs at max_image_length, expand <video> to a
    max_image_length-frame image run."""
    out = []
    for source in sources:
        source = copy.deepcopy(list(source))
        for sentence in source:
            v = sentence["value"]
            for tok in (DEFAULT_IMAGE_TOKEN, DEFAULT_VIDEO_TOKEN):
                if v.endswith(tok):
                    n = v.count(tok)
                    v = v.replace("\n" + tok * n, "").strip()
                    v = (tok * n + "\n" + v).strip()
            n_img = v.count(DEFAULT_IMAGE_TOKEN)
            if n_img > max_image_length:
                v = v.replace(DEFAULT_IMAGE_TOKEN * n_img,
                              DEFAULT_IMAGE_TOKEN * max_image_length).strip()
            v = v.replace(DEFAULT_VIDEO_TOKEN,
                          DEFAULT_IMAGE_TOKEN * max_image_length)
            sentence["value"] = v
        out.append(source)
    return out


def preprocess_v1(source: List[Dict], tokenizer,
                  conv: Optional[Conversation] = None,
                  ) -> Tuple[List[int], List[int]]:
    """train.py:427-505 for ONE conversation: vicuna TWO template with
    everything except assistant replies masked to IGNORE_INDEX (a reply's
    closing </s> is supervised).

    Redesign note: the reference re-tokenizes substrings of the rendered
    prompt and *counts* tokens to locate mask spans, which misaligns
    whenever tokenization isn't concatenative (it ships a "tokenization
    mismatch" warning for exactly that, train.py:494-500). Here ids and
    labels are built from the structured pieces directly — the
    concatenation of the pieces IS the rendered template string, and
    alignment holds by construction for any tokenizer."""
    conv = (conv or conv_templates["v1"]).copy()
    assert conv.sep_style == SeparatorStyle.TWO
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    if roles.get(source[0]["from"]) != conv.roles[0]:
        source = source[1:]

    pieces: List[Tuple[str, bool]] = [(conv.system + conv.sep, False)]
    for j, sentence in enumerate(source):
        role = roles[sentence["from"]]
        assert role == conv.roles[j % 2], "conversation roles out of order"
        if j % 2 == 0:
            pieces.append((conv.roles[0] + ": " + sentence["value"]
                           + conv.sep, False))
            pieces.append((conv.roles[1] + ": ", False))
        else:
            pieces.append((sentence["value"] + conv.sep2, True))

    ids: List[int] = [tokenizer.bos_token_id]
    labels: List[int] = [IGNORE_INDEX]
    for text, supervised in pieces:
        part = tokenize_with_images(text, tokenizer, add_bos=False)
        ids.extend(part)
        labels.extend(t if supervised else IGNORE_INDEX for t in part)
    return ids, labels


def preprocess_plain(source: List[Dict], tokenizer,
                     ) -> Tuple[List[int], List[int]]:
    """train.py:575-592: caption pretraining pairs — '<image>' + caption,
    only the caption supervised."""
    assert len(source) == 2
    assert DEFAULT_IMAGE_TOKEN in source[0]["value"]
    conv = conv_templates["plain"]
    text = DEFAULT_IMAGE_TOKEN + source[1]["value"] + conv.sep
    ids = tokenize_with_images(text, tokenizer)
    labels = list(ids)
    n_masked = len(tokenize_with_images(DEFAULT_IMAGE_TOKEN, tokenizer))
    labels[:n_masked] = [IGNORE_INDEX] * n_masked
    return ids, labels


def preprocess(source: List[Dict], tokenizer, template: str = "v1",
               ) -> Tuple[List[int], List[int]]:
    """train.py:595-641 dispatch (live branches only: plain / v1)."""
    if template == "plain":
        return preprocess_plain(source, tokenizer)
    if template.startswith("v1"):
        return preprocess_v1(source, tokenizer, conv_templates["v1"])
    raise ValueError(f"unsupported conversation template {template!r}")


# --------------------------------------------------------------- lowering
@dataclass
class SFTExample:
    """One conversation lowered to static segments.

    chunk_ids/chunk_labels: per-TokenSegment id/label lists; between
    consecutive chunks sits one image (or one video when `video_frames`
    covers the run). signature identifies the static layout for batching.
    """

    chunk_ids: List[List[int]]
    chunk_labels: List[List[int]]
    n_images: int
    images: Optional[np.ndarray]       # (n_images, S, S, 3) or None
    is_video: bool = False

    @property
    def signature(self) -> Tuple:
        return (len(self.chunk_ids), self.n_images, self.is_video)

    @property
    def n_text(self) -> int:
        return sum(len(c) for c in self.chunk_ids)


def lower_to_chunks(ids: List[int], labels: List[int],
                    ) -> Tuple[List[List[int]], List[List[int]], List[int]]:
    """Split sentinel-bearing id/label streams into text chunks; a RUN of
    consecutive sentinels collapses to one boundary (the reference groups
    consecutive image tokens into one video splice, arch.py:261-307)."""
    chunk_ids: List[List[int]] = [[]]
    chunk_labels: List[List[int]] = [[]]
    prev_sentinel = False
    n_boundaries = []
    run = 0
    for t, l in zip(ids, labels):
        if t == IMAGE_SENTINEL:
            if not prev_sentinel:
                chunk_ids.append([])
                chunk_labels.append([])
                run = 0
            run += 1
            prev_sentinel = True
            continue
        if prev_sentinel:
            n_boundaries.append(run)
            prev_sentinel = False
        chunk_ids[-1].append(t)
        chunk_labels[-1].append(l)
    if prev_sentinel:
        n_boundaries.append(run)
    return chunk_ids, chunk_labels, n_boundaries


def example_from_conversation(source: List[Dict], tokenizer,
                              images: Optional[np.ndarray] = None,
                              template: str = "v1") -> SFTExample:
    src = preprocess_multimodal([source])[0]
    ids, labels = preprocess(src, tokenizer, template)
    chunk_ids, chunk_labels, runs = lower_to_chunks(ids, labels)
    is_video = any(r > 1 for r in runs)
    n_images = images.shape[0] if images is not None else sum(
        1 if r == 1 else r for r in runs)
    return SFTExample(chunk_ids, chunk_labels, n_images=n_images,
                      images=images, is_video=is_video)


def collate_examples(examples: Sequence[SFTExample], cfg,
                     bucket: Optional[int] = None,
                     pad_id: int = 0):
    """Build one fixed-shape batch from same-signature examples: a
    MultimodalPrompt plus full-length labels (image/video feature spans
    and padding IGNORE_INDEXed). Replaces the reference's ragged
    DataCollatorForSupervisedDataset (train.py:799-848)."""
    import jax.numpy as jnp

    from open_pandora_tpu.models.world_model import (ImageSegment,
                                                     MultimodalPrompt,
                                                     TokenSegment,
                                                     VideoSegment)

    sig = examples[0].signature
    assert all(e.signature == sig for e in examples), \
        "collate requires one layout signature per batch"
    n_chunks, n_images, is_video = sig

    # pad each chunk column to its batch max (bucket pads the LAST chunk)
    chunk_lens = [max(len(e.chunk_ids[c]) for e in examples)
                  for c in range(n_chunks)]
    if bucket is not None:
        total = sum(chunk_lens)
        if total < bucket:
            chunk_lens[-1] += bucket - total

    ids_cols, label_cols, mask_cols = [], [], []
    for c in range(n_chunks):
        ids_c = np.full((len(examples), chunk_lens[c]), pad_id, np.int32)
        lab_c = np.full((len(examples), chunk_lens[c]), IGNORE_INDEX,
                        np.int32)
        msk_c = np.zeros((len(examples), chunk_lens[c]), bool)
        for b, e in enumerate(examples):
            n = len(e.chunk_ids[c])
            ids_c[b, :n] = e.chunk_ids[c]
            lab_c[b, :n] = e.chunk_labels[c]
            msk_c[b, :n] = True
        ids_cols.append(ids_c)
        label_cols.append(lab_c)
        mask_cols.append(msk_c)

    segments = []
    feature_spans = []  # (kind, len) interleave for label assembly
    img_idx = 0
    for c in range(n_chunks):
        # masks are attached unconditionally (not only when pads exist) so
        # one jit trace covers every batch of a given shape signature
        segments.append(TokenSegment(jnp.asarray(ids_cols[c]),
                                     jnp.asarray(mask_cols[c])))
        feature_spans.append(("text", c))
        if c < n_chunks - 1:
            if is_video:
                seg = VideoSegment(tuple(range(img_idx, img_idx + n_images)))
                img_idx += n_images
            else:
                seg = ImageSegment(img_idx)
                img_idx += 1
            segments.append(seg)
            feature_spans.append(("feat", seg))

    if examples[0].images is not None:
        images = jnp.asarray(np.stack([e.images for e in examples]))
    else:
        s = cfg.clip_tower.image_size
        images = jnp.zeros((len(examples), max(n_images, 1), s, s, 3),
                           jnp.float32)
    prompt = MultimodalPrompt(segments=segments, images=images)

    # full-length labels aligned with build_inputs_embeds
    from open_pandora_tpu.train.llm_step import _feature_len
    cols = []
    for kind, ref in feature_spans:
        if kind == "text":
            cols.append(label_cols[ref])
        else:
            n = _feature_len(cfg, ref)
            cols.append(np.full((len(examples), n), IGNORE_INDEX, np.int32))
    labels = jnp.asarray(np.concatenate(cols, axis=1))
    return {"prompt": prompt, "labels": labels}


def synthetic_conversations(n: int = 32, seed: int = 0) -> List[Dict]:
    """Deterministic synthetic chat records (text-only + single-image) for
    SFT smoke runs without external data."""
    rng = random.Random(seed)
    subjects = ["a red car", "two dogs", "the mountain road", "a sailboat",
                "the city at night", "a field of flowers"]
    verbs = ["drives", "runs", "turns", "sails", "glows", "sways"]
    recs = []
    for i in range(n):
        s, v = rng.choice(subjects), rng.choice(verbs)
        q = f"describe what happens with {s}"
        a = f"{s} {v} slowly across the scene"
        conv = [{"from": "human",
                 "value": (f"<image>\n{q}" if i % 2 == 0 else q)},
                {"from": "gpt", "value": a}]
        recs.append({"conversations": conv})
    return recs


# ----------------------------------------------------------------- dataset
class ConversationDataset:
    """Lazy JSON conversation dataset (train.py:644-797).

    Records: {"conversations": [{"from": "human"|"gpt", "value": ...}],
    optional "image": path (or list), optional "video": path}. Image roots
    are given as a {key: folder} dict; videos decode max_frames uniform
    frames (dataloader.py:9)."""

    def __init__(self, chat_paths: Sequence[str], tokenizer,
                 image_root: Optional[str] = None,
                 video_root: Optional[str] = None,
                 clip_size: int = 224, template: str = "v1",
                 max_frames: int = MAX_IMAGE_LENGTH, seed: int = 0,
                 records: Optional[List[Dict]] = None):
        self.records: List[Dict] = list(records or [])
        for p in chat_paths:
            with open(p) as f:
                self.records.extend(json.load(f))
        random.Random(seed).shuffle(self.records)
        self.tokenizer = tokenizer
        self.image_root = image_root
        self.video_root = video_root
        self.clip_size = clip_size
        self.template = template
        self.max_frames = max_frames

    def __len__(self) -> int:
        return len(self.records)

    def _load_image(self, path: str) -> np.ndarray:
        import os

        from PIL import Image

        from open_pandora_tpu.pipeline.preprocess import clip_tower_preprocess
        full = os.path.join(self.image_root or "", path.replace("\\", "/"))
        return clip_tower_preprocess(Image.open(full), self.clip_size)

    def __getitem__(self, i: int) -> SFTExample:
        rec = self.records[i % len(self.records)]
        source = rec["conversations"]
        images = None
        if "image" in rec:
            files = rec["image"] if isinstance(rec["image"], list) \
                else [rec["image"]]
            images = np.stack([self._load_image(f) for f in files])
        elif "video" in rec:
            import os

            from open_pandora_tpu.pipeline.preprocess import clip_tower_preprocess
            from open_pandora_tpu.utils.video_io import read_video_frames
            frames, _ = read_video_frames(
                os.path.join(self.video_root or "", rec["video"]),
                num_frames=self.max_frames)
            images = np.stack([clip_tower_preprocess(f, self.clip_size)
                               for f in frames])
        return example_from_conversation(source, self.tokenizer,
                                         images=images,
                                         template=self.template)

    def batches(self, batch_size: int, cfg, bucket: Optional[int] = None,
                drop_remainder: bool = False):
        """Group-by-signature batcher: yields fixed-shape collated batches;
        leftover groups flush at epoch end unless drop_remainder (set it
        when the batch axis is sharded over a mesh and must stay
        divisible)."""
        groups: Dict[Tuple, List[SFTExample]] = {}
        for i in range(len(self)):
            try:
                ex = self[i]
            except Exception as e:  # noqa: BLE001 — webvid.py:104 semantics
                log.warning("skipping sample %d: %s", i, e)
                continue
            groups.setdefault(ex.signature, []).append(ex)
            g = groups[ex.signature]
            if len(g) == batch_size:
                yield collate_examples(g, cfg, bucket=bucket)
                groups[ex.signature] = []
        if not drop_remainder:
            for g in groups.values():
                if g:
                    yield collate_examples(g, cfg, bucket=bucket)
