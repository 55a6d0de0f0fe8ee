"""pipeline/preprocess.py: the numpy resampler and the two tower
preprocessors against PIL, which the reference's pipeline uses."""

import numpy as np
import pytest

from open_pandora_tpu.pipeline.preprocess import (OPENAI_CLIP_MEAN,
                                                  OPENAI_CLIP_STD,
                                                  as_rgb_uint8,
                                                  clip_tower_preprocess,
                                                  diffusion_preprocess,
                                                  resize)

Image = pytest.importorskip("PIL.Image")


def _img(h, w, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8)


def _pil(arr):
    return Image.fromarray(arr)


# (input h, w) -> (output h, w): downscale to the CLIP tower, to the
# 320x512 diffusion frame, upscale, odd sizes, one axis only
SIZES = [((320, 512), (224, 358)), ((576, 1024), (320, 569)),
         ((37, 53), (64, 64)), ((100, 400), (100, 133)),
         ((500, 333), (224, 224))]


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
@pytest.mark.parametrize("src,dst", SIZES)
def test_resize_matches_pil(src, dst, method):
    img = _img(*src)
    ref = np.asarray(_pil(img).resize(
        (dst[1], dst[0]),
        Image.BICUBIC if method == "bicubic" else Image.BILINEAR))
    out = resize(img, dst, method)
    assert out.shape == ref.shape and out.dtype == np.uint8
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


def _pil_clip_tower(img, size):
    """The PIL pipeline: shortest side -> size (bicubic), center crop."""
    w, h = img.size
    nw, nh = ((size, round(h * size / w)) if w < h
              else (round(w * size / h), size))
    arr = np.asarray(img.resize((nw, nh), Image.BICUBIC), np.float32) / 255
    top, left = (nh - size) // 2, (nw - size) // 2
    arr = arr[top:top + size, left:left + size]
    return (arr - OPENAI_CLIP_MEAN) / OPENAI_CLIP_STD


@pytest.mark.parametrize("shape", [(320, 512), (512, 320), (60, 100)])
def test_clip_tower_preprocess_matches_pil(shape):
    img = _img(*shape)
    out = clip_tower_preprocess(img, 224)
    ref = _pil_clip_tower(_pil(img), 224)
    assert out.shape == (224, 224, 3) and out.dtype == np.float32
    # one uint8 level, normalized by the smallest std
    np.testing.assert_allclose(out, ref, atol=1.01 / 255 / 0.2613)


@pytest.mark.parametrize("shape,hw", [((320, 512), (320, 512)),
                                      ((100, 400), (32, 64)),
                                      ((400, 100), (32, 64))])
def test_diffusion_preprocess_matches_pil(shape, hw):
    img = _img(*shape, seed=1)
    h, w = hw
    pil = _pil(img)
    short = min(h, w)
    iw, ih = pil.size
    size = ((short, round(ih * short / iw)) if iw < ih
            else (round(iw * short / ih), short))
    small = pil.resize(size, Image.BILINEAR)
    if small.size[1] < h or small.size[0] < w:
        scale = max(h / small.size[1], w / small.size[0])
        small = small.resize((round(small.size[0] * scale),
                              round(small.size[1] * scale)), Image.BILINEAR)
    arr = np.asarray(small, np.float32) / 255.0
    top, left = (arr.shape[0] - h) // 2, (arr.shape[1] - w) // 2
    ref = arr[top:top + h, left:left + w] * 2 - 1
    out = diffusion_preprocess(img, hw)
    assert out.shape == (h, w, 3)
    np.testing.assert_allclose(out, ref, atol=2.01 / 255)


def test_as_rgb_uint8_forms():
    rgb = _img(4, 5)
    assert (as_rgb_uint8(rgb) == rgb).all()
    gray = rgb[..., 0]
    assert (as_rgb_uint8(gray) == gray[..., None]).all()
    rgba = np.concatenate([rgb, np.full((4, 5, 1), 7, np.uint8)], -1)
    assert (as_rgb_uint8(rgba) == rgb).all()
    assert (as_rgb_uint8(_pil(rgb)) == rgb).all()
    with pytest.raises(ValueError, match="uint8"):
        as_rgb_uint8(rgb.astype(np.float32))
    with pytest.raises(ValueError, match="method"):
        resize(rgb, (2, 2), "lanczos")
