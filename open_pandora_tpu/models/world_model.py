"""WorldModel — the full Open-Pandora composite: frozen ChatUniVi LLM stack
(CLIP ViT-L tower + DPC-KNN clustering + LLaMA-7B trunk) + trainable
connector + DynamiCrafter diffusion stack.

Behavioral spec: /root/reference/model.py:557-981 (the LIVE second copy):
  - get_diffusion_conditioning :616-686: splice CLIP features into token
    embeds (arch.py:219-396), overwrite [IMG_P] rows with the learned
    prefix (:642-654), run the bare LLaMA trunk (:659), gather hidden
    states at the [IMG_P] mask -> (rounds, 64, 4096) (:673-677), project
    through the Q-Former connector -> (rounds, 77, 1024) (:678-686)
  - generate :783-826: conditioning[-1:] + image_guided_synthesis
  - alignment_forward :886-923: KL(log_softmax(llm_cond) || softmax(OpenCLIP
    text embedding)), batchmean

Design: the reference's ragged splice becomes a STATIC segment layout
(SURVEY.md §7.0): prompts are built host-side as typed segments (tokens /
image / video / img-prefix); every shape is known at trace time, so the
whole conditioning path jits. The dynamic ragged path is unnecessary — the
product grammar is fixed (model.py:1020,1055).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp

from open_pandora_tpu.core import nn
from open_pandora_tpu.core.config import PandoraConfig
from open_pandora_tpu.models.clip_tower import CLIPVisionTower
from open_pandora_tpu.models.cluster import (project_image_tokens,
                                             project_video_tokens)
from open_pandora_tpu.models.connector import Connector
from open_pandora_tpu.models.dynamicrafter import DynamiCrafter
from open_pandora_tpu.models.llama import LlamaForCausalLM


# -- prompt layout ----------------------------------------------------------


@dataclass(frozen=True)
class TokenSegment:
    """Plain text tokens, shape (b, n). `mask` (b, n) bool marks real
    tokens when the segment is padded to a length bucket (SURVEY §7.0:
    "bucketed lengths for the text span") — None means all-real."""
    ids: Any  # jnp.ndarray (b, n) int32
    mask: Any = None  # optional jnp.ndarray (b, n) bool


@dataclass(frozen=True)
class ImageSegment:
    """One image -> 112 clustered feature tokens. `index` into the prompt's
    image stack."""
    index: int


@dataclass(frozen=True)
class VideoSegment:
    """A run of consecutive frames -> 112 * ceil(T/16) clustered tokens
    (the reference's consecutive-<image> grouping, arch.py:261-307)."""
    indices: Tuple[int, ...]


@dataclass(frozen=True)
class PrefixSegment:
    """64 learned [IMG_P] rows; hidden states here feed the connector."""
    length: int = 64


Segment = Union[TokenSegment, ImageSegment, VideoSegment, PrefixSegment]


@dataclass
class MultimodalPrompt:
    """Host-built prompt: ordered segments + the CLIP image stack
    (b, n_images, 224, 224, 3), preprocessed for the ViT-L tower."""
    segments: List[Segment]
    images: Any  # (b, n_images, 224, 224, 3)


# pytree registrations: array leaves (ids/images) traced, layout static —
# prompts can cross jit boundaries (e.g. inside train steps)
jax.tree_util.register_pytree_node(
    TokenSegment, lambda s: ((s.ids, s.mask), None),
    lambda _, c: TokenSegment(c[0], c[1]))
jax.tree_util.register_pytree_node(
    ImageSegment, lambda s: ((), s.index),
    lambda aux, _: ImageSegment(aux))
jax.tree_util.register_pytree_node(
    VideoSegment, lambda s: ((), s.indices),
    lambda aux, _: VideoSegment(aux))
jax.tree_util.register_pytree_node(
    PrefixSegment, lambda s: ((), s.length),
    lambda aux, _: PrefixSegment(aux))
jax.tree_util.register_pytree_node(
    MultimodalPrompt, lambda p: ((p.segments, p.images), None),
    lambda _, c: MultimodalPrompt(c[0], c[1]))


class MMProjector(nn.Module):
    """mm_projector Linear(1024 -> 4096) (arch.py:16)."""

    out_dim: int
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x):
        return nn.Dense(self.out_dim, dtype=self.dtype, name="proj")(x)


class WorldModel:
    """Functional composite over a params dict:
    {**DynamiCrafter params, 'llama', 'clip_tower', 'mm_projector',
     'connector'}."""

    def __init__(self, cfg: PandoraConfig, dtype=jnp.float32,
                 quantize_llm=False):
        """quantize_llm: weight-only LLaMA quantization (models/quant.py) —
        True/'int8' (per-channel int8, ~12.3 GB composite) or 'nf4'
        (blockwise 4-bit, the bitsandbytes load_in_4bit analog,
        ChatUniVi/model/builder.py:36-47). bf16 needs ~19 GB."""
        self.cfg = cfg
        self.dtype = dtype
        self.quantize_llm = quantize_llm
        self.diffusion = DynamiCrafter(cfg, dtype=dtype)
        self.llama = LlamaForCausalLM(cfg.llama, dtype=dtype,
                                      quantized=quantize_llm)
        # tower dispatch (ChatUniVi multimodal_encoder/builder.py:5-13:
        # names starting "eva_vit_g" select the EVA tower)
        if cfg.clip_tower.tower_type.startswith("eva_vit_g"):
            from open_pandora_tpu.models.eva_tower import EVAVisionTower
            self.clip_tower = EVAVisionTower(cfg.clip_tower, dtype=dtype)
        else:
            self.clip_tower = CLIPVisionTower(cfg.clip_tower, dtype=dtype)
        self.mm_projector = MMProjector(cfg.llama.hidden_size, dtype=dtype)
        self.connector = Connector(cfg.connector, cfg.qformer, dtype=dtype)
        # optional CLIP text transformer over the connector output
        # (model.py:97-98 diffusion_text_encoder; False in the shipped
        # config — config_json.json use_diffusion_text_encoder)
        self.text_embedding_encoder = None
        if cfg.connector.use_diffusion_text_encoder:
            from open_pandora_tpu.models.encoders import (
                CLIPTextEmbeddingEncoder)
            self.text_embedding_encoder = CLIPTextEmbeddingEncoder(
                cfg.clip_text, dtype=dtype)

    # -- init ---------------------------------------------------------------

    def init_params(self, key: jax.Array, *, height: int = 320,
                    width: int = 512) -> Dict[str, Any]:
        kd, kl, kt, km, kc = jax.random.split(key, 5)
        params = self.diffusion.init_params(kd, height=height, width=width)
        tower_in = jnp.zeros(
            (1, self.cfg.clip_tower.image_size, self.cfg.clip_tower.image_size,
             3), self.dtype)
        imgp = jnp.zeros(
            (1, self.cfg.connector.image_prefix_length,
             self.cfg.connector.llm_hidden), self.dtype)
        params.update({
            "llama": self.llama.init(kl, jnp.zeros((1, 8), jnp.int32)),
            "clip_tower": self.clip_tower.init(kt, tower_in),
            "mm_projector": self.mm_projector.init(
                km, jnp.zeros((1, 1, self.cfg.clip_tower.width), self.dtype)),
            "connector": self.connector.init(kc, imgp),
        })
        if self.text_embedding_encoder is not None:
            params["text_embedding_encoder"] = self.text_embedding_encoder.init(
                jax.random.fold_in(kc, 1),
                jnp.zeros((1, self.cfg.qformer.num_query_tokens,
                           self.cfg.clip_text.width), self.dtype))
        return params

    # -- conditioning path --------------------------------------------------

    def encode_tower(self, params, images: jnp.ndarray) -> jnp.ndarray:
        """(n, 224, 224, 3) -> (n, 256, 1024) patch features."""
        return self.clip_tower.apply(params["clip_tower"], images)

    def build_inputs_embeds(
        self, params, prompt: MultimodalPrompt
    ) -> Tuple[jnp.ndarray, List[Tuple[int, int]]]:
        """Splice segments into (b, L, 4096) embeds. Returns (embeds,
        [(start, len) of each prefix segment])."""
        cfg = self.cfg
        b = prompt.images.shape[0] if prompt.images is not None else 1
        n_img = prompt.images.shape[1] if prompt.images is not None else 0
        if n_img:
            flat = prompt.images.reshape((-1,) + prompt.images.shape[2:])
            feats = self.encode_tower(params, flat)
            feats = feats.reshape(b, n_img, *feats.shape[1:])

        def proj(x):
            return self.mm_projector.apply(params["mm_projector"], x)

        embeds = []
        prefix_spans = []
        pos = 0
        for seg in prompt.segments:
            if isinstance(seg, TokenSegment):
                e = self.llama.apply(params["llama"], seg.ids,
                                     method=LlamaForCausalLM.embed)
                embeds.append(e)
                pos += e.shape[1]
            elif isinstance(seg, ImageSegment):
                f = jax.vmap(lambda fb: project_image_tokens(
                    fb[None], cfg.cluster.spatial_rates)[0])(
                    feats[:, seg.index])
                e = proj(f)
                embeds.append(e)
                pos += e.shape[1]
            elif isinstance(seg, VideoSegment):
                idx = jnp.asarray(seg.indices)
                f = jax.vmap(lambda fb: project_video_tokens(
                    fb, cfg.cluster.spatial_rates,
                    cfg.cluster.temporal_rate)[0])(feats[:, idx])
                e = proj(f)
                embeds.append(e)
                pos += e.shape[1]
            elif isinstance(seg, PrefixSegment):
                rows = self.connector.apply(
                    params["connector"],
                    method=Connector.prefix_embeddings).astype(self.dtype)
                embeds.append(jnp.broadcast_to(
                    rows[None], (b, seg.length, rows.shape[-1])))
                prefix_spans.append((pos, seg.length))
                pos += seg.length
            else:
                raise TypeError(f"unknown segment {seg!r}")
        return jnp.concatenate(embeds, axis=1), prefix_spans

    def segment_length(self, seg) -> Optional[int]:
        """Static spliced length of a segment (None for TokenSegment whose
        length is carried by its ids array)."""
        import math
        cfg = self.cfg
        per_image = sum(cfg.cluster.spatial_rates)
        if isinstance(seg, ImageSegment):
            return per_image
        if isinstance(seg, VideoSegment):
            events = max(math.ceil(len(seg.indices) * cfg.cluster.temporal_rate), 1)
            return per_image * events
        if isinstance(seg, PrefixSegment):
            return seg.length
        return None

    def attention_mask_for(self, prompt: MultimodalPrompt,
                           ) -> Optional[jnp.ndarray]:
        """(b, L) bool key mask over the spliced sequence, or None when no
        TokenSegment is bucketed. Feature/prefix spans are always real."""
        if not any(isinstance(s, TokenSegment) and s.mask is not None
                   for s in prompt.segments):
            return None
        b = prompt.images.shape[0] if prompt.images is not None else 1
        cols = []
        for seg in prompt.segments:
            if isinstance(seg, TokenSegment):
                if seg.mask is not None:
                    cols.append(seg.mask.astype(bool))
                else:
                    cols.append(jnp.ones(seg.ids.shape, bool))
            else:
                cols.append(jnp.ones((b, self.segment_length(seg)), bool))
        return jnp.concatenate(cols, axis=1)

    def get_diffusion_conditioning(
        self, params, prompt: MultimodalPrompt,
        attention_mask: Optional[jnp.ndarray] = None,
    ) -> jnp.ndarray:
        """-> (b, rounds, 77, 1024) diffusion conditioning, one entry per
        [IMG_P] block (model.py:616-686)."""
        if attention_mask is None:
            attention_mask = self.attention_mask_for(prompt)
        embeds, spans = self.build_inputs_embeds(params, prompt)
        positions = None
        if attention_mask is not None:
            # pads are position-transparent: real tokens keep the positions
            # they'd have unpadded, so bucketed == unbucketed conditioning
            positions = jnp.cumsum(attention_mask.astype(jnp.int32),
                                   axis=1) - 1
        hidden = self.llama.apply(params["llama"], embeds,
                                  positions=positions,
                                  attention_mask=attention_mask,
                                  method=LlamaForCausalLM.trunk)
        b = hidden.shape[0]
        per_round = []
        for (start, length) in spans:
            per_round.append(hidden[:, start:start + length])  # (b, 64, 4096)
        stacked = jnp.stack(per_round, axis=1)  # (b, R, 64, 4096)
        R = stacked.shape[1]
        flat = stacked.reshape(b * R, *stacked.shape[2:])
        cond = self.connector.apply(params["connector"], flat)
        if self.text_embedding_encoder is not None:
            cond = self.text_embedding_encoder.apply(
                params["text_embedding_encoder"], cond)
        return cond.reshape(b, R, *cond.shape[1:])

    # -- generation ---------------------------------------------------------

    def generate(
        self, params, prompt: MultimodalPrompt, *,
        cond_images: jnp.ndarray, cond_frames: jnp.ndarray, key: jax.Array,
        ddim_steps: int = 50, guidance_scale: float = 4.0, eta: float = 1.0,
        fs: int = 15, **kw,
    ) -> jnp.ndarray:
        """model.py:783-826: last round's conditioning drives synthesis."""
        cond = self.get_diffusion_conditioning(params, prompt)[:, -1]
        return self.diffusion.image_guided_synthesis(
            params, text_context=cond, cond_images=cond_images,
            cond_frames=cond_frames, key=key, ddim_steps=ddim_steps,
            guidance_scale=guidance_scale, eta=eta, fs=fs, **kw)

    # -- alignment ----------------------------------------------------------

    def alignment_loss(self, params, prompt: MultimodalPrompt,
                       caption_tokens: jnp.ndarray) -> jnp.ndarray:
        """KL(log_softmax(llm_cond) || softmax(clip_text(caption))),
        batchmean (model.py:886-923)."""
        llm_cond = self.get_diffusion_conditioning(params, prompt)[:, -1]
        clip_cond = self.diffusion.encode_text(params, caption_tokens)
        log_p = jax.nn.log_softmax(llm_cond.astype(jnp.float32), axis=-1)
        q = jax.nn.softmax(clip_cond.astype(jnp.float32), axis=-1)
        kl = jnp.sum(q * (jnp.log(jnp.maximum(q, 1e-12)) - log_p), axis=-1)
        return jnp.sum(kl) / llm_cond.shape[0]


# -- prompt builders (the product grammar, model.py:1020,1055) --------------


def round1_prompt(bos_and_text_ids: jnp.ndarray, *, images: jnp.ndarray,
                  prefix_len: int = 64,
                  text_mask: Optional[jnp.ndarray] = None) -> MultimodalPrompt:
    """`bos + "<image> " + text + "[IMG_P]"*64` (model.py:1020-1024).
    bos_and_text_ids: (b, n) — bos then the text (the "<image>" marker is
    structural, not a token here). text_mask (b, n): real-token mask when
    the ids are padded to a length bucket."""
    bos = TokenSegment(bos_and_text_ids[:, :1])
    text = TokenSegment(bos_and_text_ids[:, 1:],
                        None if text_mask is None else text_mask[:, 1:])
    return MultimodalPrompt(
        segments=[bos, ImageSegment(0), text, PrefixSegment(prefix_len)],
        images=images)


def next_round_prompt(
    history: MultimodalPrompt,
    new_frame_indices: Sequence[int],
    text_ids: jnp.ndarray,
    *, prefix_len: int = 64,
    text_mask: Optional[jnp.ndarray] = None,
) -> MultimodalPrompt:
    """Append `"<image>"*16 + text + "[IMG_P]"*64` (model.py:1055): the 16
    decoded frames re-enter as a video segment."""
    segs = list(history.segments)
    segs.append(VideoSegment(tuple(new_frame_indices)))
    segs.append(TokenSegment(text_ids, text_mask))
    segs.append(PrefixSegment(prefix_len))
    return MultimodalPrompt(segments=segs, images=history.images)
