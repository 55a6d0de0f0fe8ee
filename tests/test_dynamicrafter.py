"""End-to-end DynamiCrafter i2v slice on a tiny config (Milestone A shape:
image + text-context -> DDIM -> latents -> decoded video)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from open_pandora_tpu.core.config import (CLIPTextConfig, CLIPVisionConfig,
                                          PandoraConfig, ResamplerConfig,
                                          UNet3DConfig, VAEConfig)
from open_pandora_tpu.models.dynamicrafter import DynamiCrafter
from open_pandora_tpu.models.encoders import (CLIPTextEncoder, clip_preprocess,
                                              empty_prompt_tokens)

pytestmark = pytest.mark.slow  # compile-heavy on the 1-core host

T = 4
TINY = PandoraConfig(
    vae=VAEConfig(base_channels=32, channel_mult=(1, 2), num_res_blocks=1),
    unet=UNet3DConfig(
        in_channels=8, out_channels=4, model_channels=64,
        channel_mult=(1, 2), num_res_blocks=1, attention_resolutions=(1,),
        num_head_channels=32, context_dim=64, temporal_length=T,
        text_context_len=7, img_tokens_per_frame=2, dropout=0.0),
    clip_text=CLIPTextConfig(width=64, layers=2, heads=2, context_length=7),
    clip_vision=CLIPVisionConfig(image_size=28, patch_size=14, width=64,
                                 layers=2, heads=2),
    resampler=ResamplerConfig(dim=64, depth=1, dim_head=16, heads=2,
                              num_queries=2, embedding_dim=64, output_dim=64,
                              video_length=T),
)
H, W = 32, 32  # latent 16x16 via the 2-level tiny VAE... (factor 2)


@pytest.fixture(scope="module")
def model_and_params():
    model = DynamiCrafter(TINY)
    params = model.init_params(jax.random.PRNGKey(0), height=H, width=W)
    return model, params


def test_text_encoder_shapes(model_and_params):
    model, params = model_and_params
    z = model.encode_text(params, empty_prompt_tokens(2, 7))
    assert z.shape == (2, 7, 64)
    assert bool(jnp.isfinite(z).all())


def test_penultimate_layer_depth():
    cfg = CLIPTextConfig(width=32, layers=3, heads=2, context_length=7)
    enc = CLIPTextEncoder(cfg)
    p = enc.init(jax.random.PRNGKey(0), empty_prompt_tokens(1, 7))
    blocks = [k for k in p["params"] if k.startswith("resblocks_")]
    assert len(blocks) == 2  # penultimate: layers - 1


def test_image_context_shapes(model_and_params):
    model, params = model_and_params
    imgs = jax.random.uniform(jax.random.PRNGKey(1), (2, 28, 28, 3))
    ctx = model.encode_image_context(params, imgs)
    # num_queries * video_length tokens, output_dim wide
    assert ctx.shape == (2, 2 * T, 64)


def test_clip_preprocess_normalization():
    x = jnp.ones((1, 28, 28, 3)) * 0.5
    y = clip_preprocess(x, size=28)
    expect = (0.5 - np.array([0.48145466, 0.4578275, 0.40821073])) / np.array(
        [0.26862954, 0.26130258, 0.27577711])
    np.testing.assert_allclose(np.asarray(y[0, 0, 0]), expect, rtol=1e-5)


def test_latent_z_tiling(model_and_params):
    model, params = model_and_params
    one = jax.random.normal(jax.random.PRNGKey(2), (1, 1, H, W, 3))
    z = model.get_latent_z(params, one)
    assert z.shape[1] == T
    # t=1 -> all frames identical
    np.testing.assert_allclose(np.asarray(z[:, 0]), np.asarray(z[:, -1]))
    # t=2 -> tiled [a, b, a, b] (einops '(repeat t)' semantics)
    two = jax.random.normal(jax.random.PRNGKey(3), (1, 2, H, W, 3))
    z2 = model.get_latent_z(params, two)
    np.testing.assert_allclose(np.asarray(z2[:, 0]), np.asarray(z2[:, 2]))
    assert not np.allclose(np.asarray(z2[:, 0]), np.asarray(z2[:, 1]))


def test_end_to_end_synthesis(model_and_params):
    model, params = model_and_params
    text_ctx = model.encode_text(params, empty_prompt_tokens(1, 7))
    cond_img = jax.random.uniform(jax.random.PRNGKey(4), (1, 28, 28, 3))
    cond_frames = jax.random.uniform(jax.random.PRNGKey(5), (1, 1, H, W, 3)) * 2 - 1
    z = model.image_guided_synthesis(
        params, text_context=text_ctx, cond_images=cond_img,
        cond_frames=cond_frames, key=jax.random.PRNGKey(6),
        ddim_steps=2, guidance_scale=4.0)
    assert z.shape == (1, T, H // 2, W // 2, 4)
    assert bool(jnp.isfinite(z).all())
    video = model.decode(params, z)
    assert video.shape == (1, T, H, W, 3)
    assert bool(jnp.isfinite(video).all())


def test_synthesis_deterministic(model_and_params):
    model, params = model_and_params
    text_ctx = model.encode_text(params, empty_prompt_tokens(1, 7))
    cond_img = jnp.zeros((1, 28, 28, 3))
    cond_frames = jnp.zeros((1, 1, H, W, 3))
    kw = dict(text_context=text_ctx, cond_images=cond_img,
              cond_frames=cond_frames, ddim_steps=2, guidance_scale=4.0)
    z1 = model.image_guided_synthesis(params, key=jax.random.PRNGKey(9), **kw)
    z2 = model.image_guided_synthesis(params, key=jax.random.PRNGKey(9), **kw)
    np.testing.assert_array_equal(np.asarray(z1), np.asarray(z2))


def test_segmented_synthesis_matches_full(model_and_params):
    """image_guided_synthesis_segmented (host-driven bounded device
    programs) must reproduce the single-program sampler EXACTLY for any
    segment_steps — per-step noise is keyed by the global step index, so
    segmentation is pure re-dispatching. Uses ddim_steps=5 with
    segment_steps=2 to exercise both the reused full segment (traced
    start) and the remainder segment."""
    model, params = model_and_params
    text_ctx = model.encode_text(params, empty_prompt_tokens(1, 7))
    kw = dict(text_context=text_ctx,
              cond_images=jax.random.uniform(jax.random.PRNGKey(4),
                                             (1, 28, 28, 3)),
              cond_frames=jax.random.uniform(jax.random.PRNGKey(5),
                                             (1, 1, H, W, 3)) * 2 - 1,
              key=jax.random.PRNGKey(6), ddim_steps=5, guidance_scale=4.0)
    z_full = model.image_guided_synthesis(params, **kw)
    z_seg = model.image_guided_synthesis_segmented(
        params, segment_steps=2, **kw)
    np.testing.assert_allclose(np.asarray(z_seg, np.float32),
                               np.asarray(z_full, np.float32),
                               atol=0, rtol=0)
    # segment jits are cached: a second call must reuse them
    assert len(model._segmented_jit_cache) == 1
    z_seg2 = model.image_guided_synthesis_segmented(
        params, segment_steps=2, **kw)
    np.testing.assert_array_equal(np.asarray(z_seg2), np.asarray(z_seg))


def test_three_way_cfg(model_and_params):
    """cfg_img path: 3 guidance streams (ddim_multiplecond.py:210-234).
    Zero-init kernels are perturbed so the streams produce distinct
    predictions (at init every stream outputs exactly 0)."""
    from open_pandora_tpu.core import nn
    model, params = model_and_params
    flat = nn.flatten_dict(params["unet"]["params"])
    for k in list(flat):
        if k[-1] == "kernel" and float(jnp.abs(flat[k]).sum()) == 0.0:
            flat[k] = jax.random.normal(
                jax.random.PRNGKey(sum(map(len, k))), flat[k].shape) * 0.02
    p2 = dict(params)
    p2["unet"] = {"params": nn.unflatten_dict(flat)}
    text_ctx = model.encode_text(p2, empty_prompt_tokens(1, 7))
    # NON-zero cond image: the uncond stream uses the zero image, so a zero
    # cond image would make all three streams identical
    kw = dict(text_context=text_ctx,
              cond_images=jax.random.uniform(jax.random.PRNGKey(5),
                                             (1, 28, 28, 3)),
              cond_frames=jnp.zeros((1, 1, H, W, 3)),
              key=jax.random.PRNGKey(11), ddim_steps=2, guidance_scale=7.5)
    z = model.image_guided_synthesis(p2, cfg_img=1.5, **kw)
    assert z.shape == (1, T, H // 2, W // 2, 4)
    assert bool(jnp.isfinite(z).all())
    z2 = model.image_guided_synthesis(p2, **kw)  # 2-way
    assert not np.allclose(np.asarray(z), np.asarray(z2))
