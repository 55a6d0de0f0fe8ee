"""ChatWM — the multi-round interactive session (the reference's L6 layer).

Behavioral spec: /root/reference/model.py:983-1211 (class ChatWM):
  - round 1 (generate_video :1007): prompt `bos + "<image> " + text +
    "[IMG_P]"*64` (:1020-1024); image preprocessed for BOTH towers
    (process_img :1172-1177)
  - rounds 2..5 (generate_video_next_round :1070-1092): prompt history +
    `"<image>"*16 + text + "[IMG_P]"*64` (:1055); frame chaining via
    process_img_from_output :1179-1187 — decoded frames cross the PIXEL
    domain (decode -> uint8 -> re-encode), the last 4 frames become the
    next round's VAE conditioning; the CLIP cross-attn image stays round 1's
    (:1059)
  - multi-round concat trims the 4-frame overlap per round
    (process_generated_video_multi :1199-1211)

Images are uint8 (H, W, 3) arrays (a PIL image is accepted for round 1);
each round's frames are kept as uint8 (16, H, W, 3).
"""

from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from open_pandora_tpu.models.world_model import (MultimodalPrompt, WorldModel,
                                                 next_round_prompt,
                                                 round1_prompt)
from open_pandora_tpu.pipeline.preprocess import (clip_resampler_preprocess,
                                                  clip_tower_preprocess,
                                                  diffusion_preprocess)
from open_pandora_tpu.pipeline.tokenizers import load_tokenizer
from open_pandora_tpu.utils.video_io import (concat_rounds, frames_to_uint8,
                                             write_video)


class ChatWM:
    def __init__(self, wm: WorldModel, params, tokenizer=None,
                 height: int = 320, width: int = 512):
        self.wm = wm
        self.params = params
        self.tokenizer = tokenizer or load_tokenizer()
        self.hw = (height, width)
        self.reset()

    def reset(self):
        self.prompt: Optional[MultimodalPrompt] = None
        self.images: List[np.ndarray] = []      # CLIP-tower stack
        self.round_videos: List[np.ndarray] = []  # uint8 (16,h,w,3) per round
        self.cond_image = None                  # round-1 resampler image
        self.round = 0
        # (conditioning_s, sampling_s, decode_s) per round
        self.round_times: List[tuple] = []

    # -- rounds -------------------------------------------------------------

    TEXT_BUCKETS = (16, 32, 64, 128, 256)
    COND_FRAMES = 4  # frames of the previous round that condition the next

    def _ids(self, text: str, add_bos: bool):
        """Tokenize and pad to a length bucket so rounds with different
        action texts reuse one conditioning trace (the reference recompiles
        per prompt length; SURVEY §7.0 bucketed-text-span row). Returns
        (ids (1, bucket), mask (1, bucket)) — pads are masked + position-
        transparent in the trunk, so bucketing is numerically exact."""
        raw = self.tokenizer.encode(text, add_bos=add_bos)
        n = len(raw)
        bucket = next((b for b in self.TEXT_BUCKETS if b >= n), None)
        if bucket is None:
            bucket = n  # beyond the largest bucket: exact-length trace
        ids = np.zeros((1, bucket), np.int32)
        ids[0, :n] = raw
        mask = np.zeros((1, bucket), bool)
        mask[0, :n] = True
        return jnp.asarray(ids), jnp.asarray(mask)

    def generate_video(self, image, text: str, *,
                       ddim_steps: int = 50, fs: int = 15,
                       guidance_scale: float = 4.0, eta: float = 1.0,
                       seed: int = 0, **kw) -> np.ndarray:
        """Round 1. Returns uint8 frames (T, H, W, 3)."""
        self.reset()
        tower_size = self.wm.cfg.clip_tower.image_size
        self.images = [clip_tower_preprocess(image, tower_size)]
        self.cond_image = clip_resampler_preprocess(image)[None]  # (1,h,w,3)
        diff_img = diffusion_preprocess(image, self.hw)
        # the image as the COND_FRAMES frames rounds 2+ pass, so every round
        # runs one sampler program: the VAE encodes frames one at a time,
        # so this gives the latents of encoding it once and tiling
        cond_frames = jnp.broadcast_to(
            jnp.asarray(diff_img), (1, self.COND_FRAMES) + diff_img.shape)

        ids, mask = self._ids(text, add_bos=True)
        images = jnp.asarray(np.stack(self.images))[None]
        self.prompt = round1_prompt(
            ids, images=images,
            prefix_len=self.wm.cfg.connector.image_prefix_length,
            text_mask=mask)
        return self._run_round(cond_frames, ddim_steps, fs, guidance_scale,
                               eta, seed, **kw)

    def generate_video_next_round(self, text: str, *, ddim_steps: int = 50,
                                  fs: int = 15, guidance_scale: float = 4.0,
                                  eta: float = 1.0, seed: int = 0,
                                  **kw) -> np.ndarray:
        """Rounds 2+: chain the last decoded clip (model.py:1070-1092)."""
        assert self.round >= 1, "call generate_video first"
        last = self.round_videos[-1]  # uint8 (16, h, w, 3)
        tower_size = self.wm.cfg.clip_tower.image_size
        start = len(self.images)
        for fr in last:
            self.images.append(clip_tower_preprocess(fr, tower_size))
        new_indices = tuple(range(start, len(self.images)))
        # last 4 frames -> VAE conditioning, pixel domain (model.py:1185-1186)
        tail = last[-self.COND_FRAMES:].astype(np.float32) / 127.5 - 1.0
        cond_frames = jnp.asarray(tail)[None]  # (1, 4, H, W, 3)

        images = jnp.asarray(np.stack(self.images))[None]
        ids, mask = self._ids(text, add_bos=False)
        prompt = next_round_prompt(
            self.prompt, new_indices, ids,
            prefix_len=self.wm.cfg.connector.image_prefix_length,
            text_mask=mask)
        self.prompt = MultimodalPrompt(segments=prompt.segments, images=images)
        return self._run_round(cond_frames, ddim_steps, fs, guidance_scale,
                               eta, seed, **kw)

    def _synth_jit(self, ddim_steps, fs, guidance_scale, eta, **kw):
        """One jitted synthesis program per sampler-setting tuple (the
        conditioning jit retraces per prompt structure on its own)."""
        key_t = (ddim_steps, fs, guidance_scale, eta, tuple(sorted(kw)))
        if not hasattr(self, "_synth_cache"):
            self._synth_cache = {}
        if key_t not in self._synth_cache:
            def synth(p, text_ctx, ci, cf, k):
                return self.wm.diffusion.image_guided_synthesis(
                    p, text_context=text_ctx, cond_images=ci,
                    cond_frames=cf, key=k, ddim_steps=ddim_steps, fs=fs,
                    guidance_scale=guidance_scale, eta=eta, **kw)
            self._synth_cache[key_t] = jax.jit(synth)
        return self._synth_cache[key_t]

    def _run_round(self, cond_frames, ddim_steps, fs, guidance_scale, eta,
                   seed, **kw) -> np.ndarray:
        import time

        t0 = time.perf_counter()
        # LLM conditioning retraces per prompt structure (bounded by the
        # text buckets), synthesis/decode per settings
        if not hasattr(self, "_cond_jit"):
            self._cond_jit = jax.jit(
                lambda p, pr: self.wm.get_diffusion_conditioning(p, pr))
        text_ctx = self._cond_jit(self.params, self.prompt)[:, -1]
        text_ctx.block_until_ready()
        t1 = time.perf_counter()
        z = self._synth_jit(ddim_steps, fs, guidance_scale, eta, **kw)(
            self.params, text_ctx, jnp.asarray(self.cond_image), cond_frames,
            jax.random.PRNGKey(seed + self.round))
        z.block_until_ready()
        t2 = time.perf_counter()
        # decode frames in chunks (bounded activation memory at high res)
        t = z.shape[1]
        chunk = 8 if (self.hw[0] * self.hw[1] <= 320 * 512 and t % 8 == 0) \
            else (2 if t % 2 == 0 else 1)
        if not hasattr(self, "_dec_jit"):
            self._dec_jit = jax.jit(lambda p, zz: self.wm.diffusion.decode(
                p, zz, frame_chunk=chunk))
        video = np.asarray(self._dec_jit(self.params, z)[0])
        self.last_video = video
        frames = frames_to_uint8(video)
        t3 = time.perf_counter()
        print(f"[chatwm] round {self.round}: conditioning {t1 - t0:.3f}s, "
              f"sampling {t2 - t1:.3f}s, decode {t3 - t2:.3f}s"
              + (" (first round: includes compilation)" if self.round == 0
                 else ""), flush=True)
        self.round_times.append((t1 - t0, t2 - t1, t3 - t2))
        self.round_videos.append(frames)
        self.round += 1
        return frames

    def generate_video_multiround(self, image,
                                  texts: List[str], **kw) -> np.ndarray:
        """model.py:1094-1129: one clip per action text, chained."""
        self.generate_video(image, texts[0], **kw)
        for t in texts[1:]:
            self.generate_video_next_round(t, **kw)
        return concat_rounds(self.round_videos)

    # -- output -------------------------------------------------------------

    def save_video(self, path: str, frames: Optional[np.ndarray] = None,
                   fps: int = 8) -> str:
        """model.py:1191-1211: h264 mp4 at save-fps 8."""
        if frames is None:
            frames = (concat_rounds(self.round_videos)
                      if len(self.round_videos) > 1 else self.round_videos[-1])
        return write_video(path, frames, fps=fps)
