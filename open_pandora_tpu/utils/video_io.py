"""Host-side video IO (OpenCV backend).

Replaces the reference's native decode/encode dependencies (SURVEY.md §2.6):
decord (data/webvid.py:5,112) for decode and torchvision.io/PyAV h264
(model.py:1197,1211) for encode. This image has no ffmpeg binary, pyav or
decord; OpenCV ships both a demuxer/decoder and an mp4 muxer.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _cv2():
    """OpenCV, imported on first use: only video files need it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("reading or writing video files needs OpenCV "
                          "(cv2), which is not installed") from e
    return cv2


def write_video(path: str, frames: np.ndarray, fps: int = 8) -> str:
    """frames (t, h, w, 3) uint8 RGB -> mp4. Tries h264 (avc1) first,
    falls back to mp4v (model.py:1197: torchvision h264 equivalent)."""
    cv2 = _cv2()
    t, h, w, _ = frames.shape
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    for codec in ("avc1", "mp4v"):
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*codec),
                                 fps, (w, h))
        if writer.isOpened():
            for fr in frames:
                writer.write(cv2.cvtColor(fr, cv2.COLOR_RGB2BGR))
            writer.release()
            return path
        writer.release()
    raise RuntimeError(f"no usable mp4 codec for {path}")


def read_video_frames(
    path: str,
    indices: Optional[Sequence[int]] = None,
    num_frames: Optional[int] = None,
) -> Tuple[np.ndarray, float]:
    """Decode RGB frames. Either explicit `indices` or `num_frames`
    uniformly-sampled (the decord usage at ChatUniVi/model/dataloader.py:9
    and data/webvid.py:112-131). Returns (frames (t,h,w,3) uint8, fps)."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    if indices is None:
        if num_frames is None:
            indices = range(total)
        else:
            indices = np.linspace(0, max(total - 1, 0), num_frames).astype(int)
    want = set(int(i) for i in indices)
    frames = {}
    pos = 0
    max_want = max(want) if want else -1
    while pos <= max_want:
        ok, frame = cap.read()
        if not ok:
            break
        if pos in want:
            frames[pos] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        pos += 1
    cap.release()
    if not frames:
        raise IOError(f"no decodable frames in {path}")
    # missing indices (short video): clamp to last decoded
    last = frames[max(frames)]
    out = np.stack([frames.get(int(i), last) for i in indices])
    return out, fps


def probe_video(path: str) -> Tuple[int, float]:
    """Single-open probe: verify the first frame decodes and return
    (frame_count, fps). Replaces the reference's decode-then-reopen probe
    (data/webvid.py:104-131) with one demuxer open."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            raise IOError(f"cannot open video {path}")
        ok, _ = cap.read()
        if not ok:
            raise IOError(f"no decodable frames in {path}")
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    finally:
        cap.release()
    return total, fps


def frames_to_uint8(video: np.ndarray) -> np.ndarray:
    """[-1, 1] float (t, h, w, 3) -> uint8 (model.py:1191-1197 semantics:
    clamp, (x+1)/2, *255)."""
    x = np.clip(np.asarray(video, dtype=np.float32), -1.0, 1.0)
    return ((x + 1.0) * 127.5).astype(np.uint8)


def concat_rounds(round_frames: List[np.ndarray]) -> np.ndarray:
    """Multi-round mp4 overlap trimming (model.py:1199-1211): round 0
    contributes frames [0, 12); round i>0 contributes [0, 12) of its own 16
    (the last 4 seed the next round); the final round contributes all 16."""
    out = []
    for i, fr in enumerate(round_frames):
        if i == len(round_frames) - 1:
            out.append(fr)
        else:
            out.append(fr[: fr.shape[0] - 4])
    return np.concatenate(out, axis=0)
