"""Host-side image preprocessing for both towers, in numpy.

Behavioral spec:
  - CLIP ViT-L tower: HF CLIPImageProcessor defaults — resize shortest edge
    224 (bicubic), center-crop 224, scale 1/255, normalize with the OpenAI
    CLIP mean/std (reference: model.py:1172-1177 via
    vision_tower.image_processor).
  - diffusion branch: dynamic_resize (model.py:507-513) — resize shortest
    side to target height (bilinear), center-crop (H, W), ToTensor +
    Normalize(0.5,0.5) -> [-1, 1].

Images are uint8 (H, W, 3) arrays; a PIL image is accepted too and
converted to RGB. `resize` reproduces PIL's antialiased BICUBIC and
BILINEAR resampling (separable convolution, horizontal pass then
vertical, each pass rounded to uint8 in 22-bit fixed point), so the
towers see the pixels the reference's PIL pipeline gives them.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

OPENAI_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
OPENAI_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

_PRECISION_BITS = 32 - 8 - 2


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


_FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0)}


@functools.lru_cache(maxsize=64)
def _coefficients(in_size: int, out_size: int, method: str) -> np.ndarray:
    """(out_size, in_size) int64 fixed-point weights of one resize axis."""
    filt, support = _FILTERS[method]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support *= filterscale
    inv = 1.0 / filterscale
    out = np.zeros((out_size, in_size), np.int64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        w = filt((np.arange(lo, hi) - center + 0.5) * inv)
        total = w.sum()
        if total != 0.0:
            w = w / total
        out[i, lo:hi] = np.trunc(w * (1 << _PRECISION_BITS)
                                 + np.where(w < 0, -0.5, 0.5))
    return out


def _resample_axis(img: np.ndarray, out_size: int, axis: int,
                   method: str) -> np.ndarray:
    if img.shape[axis] == out_size:
        return img
    coeffs = _coefficients(img.shape[axis], out_size, method)
    acc = np.tensordot(coeffs, img.astype(np.int64), axes=([1], [axis]))
    acc = np.moveaxis(acc, 0, axis) + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize(img: np.ndarray, size: Tuple[int, int],
           method: str = "bicubic") -> np.ndarray:
    """uint8 (H, W, C) -> uint8 (h, w, C), size = (h, w); PIL-equivalent
    antialiased resampling ("bicubic" or "bilinear")."""
    h, w = size
    if method not in _FILTERS:
        raise ValueError(f"unknown resize method {method!r}")
    return _resample_axis(_resample_axis(img, w, 1, method), h, 0, method)


def as_rgb_uint8(img) -> np.ndarray:
    """uint8 (H, W, 3) from an array (gray or RGBA accepted) or a PIL
    image."""
    if not isinstance(img, np.ndarray):
        img = np.asarray(img.convert("RGB"))
    if img.dtype != np.uint8:
        raise ValueError(f"expected a uint8 image, got {img.dtype}")
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.ndim != 3 or img.shape[-1] not in (3, 4):
        raise ValueError(f"expected an (H, W, 3) image, got {img.shape}")
    return img[..., :3]


def _resize_shortest(img: np.ndarray, target: int,
                     method: str = "bicubic") -> np.ndarray:
    h, w = img.shape[:2]
    if w < h:
        nw, nh = target, round(h * target / w)
    else:
        nw, nh = round(w * target / h), target
    return resize(img, (nh, nw), method)


def _center_crop(arr: np.ndarray, ch: int, cw: int) -> np.ndarray:
    h, w = arr.shape[:2]
    top = max((h - ch) // 2, 0)
    left = max((w - cw) // 2, 0)
    return arr[top: top + ch, left: left + cw]


def clip_tower_preprocess(img, size: int = 224) -> np.ndarray:
    """-> (size, size, 3) float32, CLIP-normalized (HF CLIPImageProcessor)."""
    img = _resize_shortest(as_rgb_uint8(img), size)
    arr = _center_crop(img.astype(np.float32) / 255.0, size, size)
    return (arr - OPENAI_CLIP_MEAN) / OPENAI_CLIP_STD


def diffusion_preprocess(img, hw: Tuple[int, int] = (320, 512)) -> np.ndarray:
    """dynamic_resize + Normalize(0.5, 0.5): -> (H, W, 3) float32 in [-1,1]."""
    h, w = hw
    img = as_rgb_uint8(img)
    small = _resize_shortest(img, min(h, w), method="bilinear")
    if small.shape[0] < h or small.shape[1] < w:
        # shortest-side resize can undershoot the crop box for mismatched
        # aspect ratios — upscale to cover
        scale = max(h / small.shape[0], w / small.shape[1])
        small = resize(small, (round(small.shape[0] * scale),
                               round(small.shape[1] * scale)), "bilinear")
    arr = _center_crop(small.astype(np.float32) / 255.0, h, w)
    return arr * 2.0 - 1.0


def clip_resampler_preprocess(img) -> np.ndarray:
    """Image for the OpenCLIP ViT-H embedder (DynamiCrafter cross-attn):
    [0, 1] float at native aspect; the model-side clip_preprocess resizes
    to 224 and normalizes (condition.py:326-339)."""
    return as_rgb_uint8(img).astype(np.float32) / 255.0

