"""WebVid training dataset + input pipeline.

Behavioral spec: /root/reference/data/webvid.py:14-185:
  - CSV metadata (page_dir, videoid, name->caption), videos under
    data_dir/videos/$page_dir/$videoid.mp4
  - random frame stride in [frame_stride_min, frame_stride] (random_fs),
    fixed-fps stride correction :126-131
  - retry-forever loop skipping unreadable/short videos with logging
    :104-157 (the reference's only fault tolerance)
  - resize shortest side + center crop to (H, W); frames scaled to [-1, 1]
  - random conditioning frame (rand_cond_frame :161-163) resized 224 for
    the CLIP branch
  - sample dict: image/video/caption/fps/frame_stride :180

Pipeline: a thread-pool PrefetchLoader feeds fixed-shape numpy
batches (per-host sharded via jax.process_index, replacing the
rank-sharding at inference.py:276-282 / DataModuleFromConfig workers),
with captions tokenized host-side to the fixed 77-token CLIP layout.
"""

from __future__ import annotations

import logging
import queue
import random
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from open_pandora_tpu.utils.video_io import (probe_video,
                                             read_video_frames)

log = logging.getLogger("open_pandora_tpu.data")


def resize_center_crop(frames: np.ndarray, height: int, width: int) -> np.ndarray:
    """(t, h, w, 3) uint8 -> (t, H, W, 3) uint8: shortest-side resize +
    center crop (webvid.py:66-70 resize_center_crop)."""
    import cv2

    t, h, w, _ = frames.shape
    scale = max(height / h, width / w)
    nh, nw = round(h * scale), round(w * scale)
    out = np.stack([cv2.resize(f, (nw, nh), interpolation=cv2.INTER_AREA
                               if scale < 1 else cv2.INTER_LINEAR)
                    for f in frames])
    top = (nh - height) // 2
    left = (nw - width) // 2
    return out[:, top: top + height, left: left + width]


class WebVidDataset:
    def __init__(
        self,
        meta_path: str,
        data_dir: str,
        video_length: int = 16,
        resolution: Sequence[int] = (320, 512),
        frame_stride: int = 6,
        frame_stride_min: int = 1,
        random_fs: bool = False,
        fixed_fps: Optional[int] = None,
        fps_max: Optional[int] = None,
        rand_cond_frame: bool = True,
        subsample: Optional[int] = None,
        seed: int = 0,
    ):
        import pandas as pd

        self.data_dir = data_dir
        self.video_length = video_length
        self.resolution = tuple(resolution)
        self.frame_stride = frame_stride
        self.frame_stride_min = frame_stride_min
        self.random_fs = random_fs
        self.fixed_fps = fixed_fps
        self.fps_max = fps_max
        self.rand_cond_frame = rand_cond_frame
        self.rng = random.Random(seed)

        meta = pd.read_csv(meta_path, dtype=str)
        if subsample:
            meta = meta.sample(subsample, random_state=0)
        meta["caption"] = meta["name"]
        meta = meta.dropna(subset=["caption", "page_dir", "videoid"])
        self.metadata = meta.reset_index(drop=True)
        log.info(">>> %d data samples loaded.", len(self.metadata))

    def __len__(self) -> int:
        return len(self.metadata)

    def _video_path(self, row) -> str:
        import os

        return os.path.join(self.data_dir, "videos", row["page_dir"],
                            f"{row['videoid']}.mp4")

    def __getitem__(self, index: int) -> Dict:
        fs = (self.rng.randint(self.frame_stride_min, self.frame_stride)
              if self.random_fs else self.frame_stride)
        while True:  # retry-forever (webvid.py:104-157)
            index = index % len(self.metadata)
            row = self.metadata.iloc[index]
            path = self._video_path(row)
            try:
                frame_num, fps_ori = probe_video(path)
            except Exception as e:  # noqa: BLE001
                log.warning("Load video failed! path = %s (%s)", path, e)
                index += 1
                continue
            if frame_num < self.video_length:
                log.warning("video length (%d) < target (%d): %s",
                            frame_num, self.video_length, path)
                index += 1
                continue

            stride = fs
            if self.fixed_fps is not None:
                stride = int(stride * (fps_ori / self.fixed_fps))
            stride = max(stride, 1)
            required = stride * (self.video_length - 1) + 1
            if frame_num < required:
                if self.fixed_fps is not None and frame_num < required * 0.5:
                    index += 1
                    continue
                stride = frame_num // self.video_length
                required = stride * (self.video_length - 1) + 1
            rand_range = frame_num - required
            start = self.rng.randint(0, rand_range) if rand_range > 0 else 0
            indices = [start + stride * i for i in range(self.video_length)]
            try:
                frames, _ = read_video_frames(path, indices=indices)
                break
            except Exception as e:  # noqa: BLE001
                log.warning("Get frames failed! path = %s (%s)", path, e)
                index += 1
                continue

        h, w = self.resolution
        frames = resize_center_crop(frames, h, w)
        cond_idx = (self.rng.randint(0, self.video_length - 1)
                    if self.rand_cond_frame else 0)
        import cv2

        cond224 = cv2.resize(frames[cond_idx], (224, 224))
        video = frames.astype(np.float32) / 127.5 - 1.0
        fps_clip = int(fps_ori // stride)
        if self.fps_max is not None:
            fps_clip = min(fps_clip, self.fps_max)
        return {
            "video": video,                                   # (T,H,W,3) [-1,1]
            "cond_frames": video[cond_idx: cond_idx + 1],     # (1,H,W,3)
            "cond_image": cond224.astype(np.float32) / 255.0,  # (224,224,3) [0,1]
            "caption": str(row["caption"]),
            "fps": fps_clip,
            "frame_stride": stride,
        }


class SyntheticVideoDataset:
    """Same sample contract with random data — smoke/e2e tests and
    machines without the corpus."""

    def __init__(self, video_length: int = 16,
                 resolution: Sequence[int] = (320, 512),
                 clip_size: int = 224, length: int = 64, seed: int = 0):
        self.video_length = video_length
        self.resolution = tuple(resolution)
        self.clip_size = clip_size
        self.length = length
        self.seed = seed

    def __len__(self):
        return self.length

    def __getitem__(self, index: int) -> Dict:
        rng = np.random.RandomState(self.seed + index % self.length)
        h, w = self.resolution
        video = rng.uniform(-1, 1, (self.video_length, h, w, 3)).astype(np.float32)
        c = self.clip_size
        return {
            "video": video,
            "cond_frames": video[:1],
            "cond_image": rng.uniform(0, 1, (c, c, 3)).astype(np.float32),
            "caption": f"synthetic clip {index}",
            "fps": 8,
            "frame_stride": 1,
        }


class PrefetchLoader:
    """Threaded prefetching batcher with per-host sharding.

    Replaces DataModuleFromConfig + torch DataLoader workers
    (utils/utils_data.py:43-130). Yields numpy batches matching the
    train-step contract (train/step.py)."""

    def __init__(self, dataset, batch_size: int, tokenizer=None,
                 text_len: int = 77, num_workers: int = 4,
                 shard: bool = True, seed: int = 0, drop_remainder: bool = True,
                 llm_tokenizer=None, llm_text_len: int = 16):
        self.ds = dataset
        self.bs = batch_size
        self.text_len = text_len
        self.num_workers = num_workers
        self.seed = seed
        if tokenizer is None:
            # real OpenCLIP BPE when the merges asset is present, else the
            # hash stand-in (pipeline/tokenizers.load_clip_tokenizer)
            from open_pandora_tpu.pipeline.tokenizers import load_clip_tokenizer
            tokenizer = load_clip_tokenizer(context_length=text_len)
        self.tokenize = tokenizer
        self.llm_tokenizer = llm_tokenizer
        self.llm_text_len = llm_text_len
        import jax

        self.shard_id = jax.process_index() if shard else 0
        self.num_shards = jax.process_count() if shard else 1

    def _epoch_indices(self, epoch: int) -> List[int]:
        rng = np.random.RandomState(self.seed + epoch)
        idx = rng.permutation(len(self.ds))
        return list(idx[self.shard_id::self.num_shards])

    def _collate(self, samples: List[Dict]) -> Dict[str, np.ndarray]:
        toks = np.stack([
            np.asarray(self.tokenize(s["caption"], self.text_len), np.int32)
            for s in samples])
        batch = {
            "video": np.stack([s["video"] for s in samples]),
            "cond_frames": np.stack([s["cond_frames"] for s in samples]),
            "cond_images": np.stack([s["cond_image"] for s in samples]),
            "text_tokens": toks,
            "fps": np.asarray([s["fps"] for s in samples], np.int32),
        }
        if self.llm_tokenizer is not None:
            L = self.llm_text_len
            ids = np.zeros((len(samples), L), np.int32)
            for i, s in enumerate(samples):
                enc = self.llm_tokenizer.encode(s["caption"], add_bos=True)[:L]
                ids[i, :len(enc)] = enc
            batch["llm_text_tokens"] = ids
        return batch

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._epoch_indices(epoch)
        n_batches = len(indices) // self.bs
        q: "queue.Queue" = queue.Queue(maxsize=max(2, self.num_workers))
        batches = [indices[i * self.bs:(i + 1) * self.bs]
                   for i in range(n_batches)]
        it = iter(enumerate(batches))
        lock = threading.Lock()
        results: Dict[int, Dict] = {}
        done = threading.Event()

        def worker():
            while not done.is_set():
                with lock:
                    try:
                        bi, batch_idx = next(it)
                    except StopIteration:
                        return
                samples = [self.ds[i] for i in batch_idx]
                q.put((bi, self._collate(samples)))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(max(1, self.num_workers))]
        for t in threads:
            t.start()
        try:
            next_bi = 0
            received = 0
            while received < n_batches:
                bi, batch = q.get()
                results[bi] = batch
                received += 1
                while next_bi in results:
                    yield results.pop(next_bi)
                    next_bi += 1
        finally:
            done.set()
