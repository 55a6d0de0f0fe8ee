"""Every model family on core/nn.py against the same source on flax.linen.

While flax is installed, the model modules are imported a second time with
`open_pandora_tpu.core.nn` replaced by `flax.linen`. Both builds must give
the same parameter tree (names, shapes, dtypes) at a tiny config, and the
core/nn build applied to the flax build's parameters must give the flax
build's outputs.
"""

import dataclasses
import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import open_pandora_tpu.core as core_pkg

MODULES = ("dynamicrafter", "world_model", "eva_tower", "encoders_extra")


def _load(nn_module):
    """Import the model modules fresh with `core.nn` bound to nn_module."""
    prefix = "open_pandora_tpu.models"
    saved = {k: v for k, v in sys.modules.items() if k.startswith(prefix)}
    saved_nn = sys.modules["open_pandora_tpu.core.nn"]
    for k in saved:
        del sys.modules[k]
    sys.modules["open_pandora_tpu.core.nn"] = nn_module
    core_pkg.nn = nn_module
    try:
        return {m: importlib.import_module(f"{prefix}.{m}") for m in MODULES}
    finally:
        for k in [k for k in sys.modules if k.startswith(prefix)]:
            del sys.modules[k]
        sys.modules.update(saved)
        sys.modules["open_pandora_tpu.core.nn"] = saved_nn
        core_pkg.nn = saved_nn


@pytest.fixture(scope="module")
def builds():
    flax_nn = pytest.importorskip("flax.linen")
    from open_pandora_tpu.core import nn
    return _load(nn), _load(flax_nn)


def _dynamicrafter(m):
    from tests.test_dynamicrafter import TINY, H, W
    model = m["dynamicrafter"].DynamiCrafter(TINY)
    t = TINY.unet.temporal_length
    k = jax.random.split(jax.random.PRNGKey(3), 4)
    x = jax.random.normal(k[0], (1, t, H // 2, W // 2, 4))
    cond = jax.random.normal(k[1], (1, t, H // 2, W // 2, 4))
    ctx = jax.random.normal(k[2], (1, TINY.unet.text_context_len
                                   + t * TINY.unet.img_tokens_per_frame, 64))
    img = jax.random.uniform(k[3], (1, 28, 28, 3))
    ids = jnp.arange(TINY.clip_text.context_length)[None] % 50

    def outputs(params):
        return [model.apply_model(params, x, jnp.array([500]), ctx, cond),
                model.decode(params, x),
                model.encode_text(params, ids),
                model.encode_image_context(params, img)]

    return lambda: model.init_params(jax.random.PRNGKey(0), height=H,
                                     width=W), outputs


def _world_model(m):
    from tests.test_llm_stack import TINY_CONN, TINY_LLAMA, TINY_QF
    from tests.test_dynamicrafter import TINY, H, W
    from open_pandora_tpu.core.config import CLIPTowerConfig, ClusterConfig
    cfg = dataclasses.replace(
        TINY, llama=TINY_LLAMA,
        clip_tower=CLIPTowerConfig(image_size=28, patch_size=14, width=64,
                                   layers=2, heads=2),
        cluster=ClusterConfig(spatial_rates=(2, 1, 1), temporal_rate=0.5),
        qformer=TINY_QF, connector=TINY_CONN)
    wmod = m["world_model"]
    wm = wmod.WorldModel(cfg)
    images = jax.random.normal(jax.random.PRNGKey(4), (1, 1, 28, 28, 3))
    prompt = wmod.round1_prompt(jnp.array([[1, 5, 9, 13]]), images=images,
                                prefix_len=TINY_CONN.image_prefix_length)

    def outputs(params):
        return [wm.get_diffusion_conditioning(params, prompt)]

    return lambda: wm.init_params(jax.random.PRNGKey(0), height=H,
                                  width=W), outputs


def _eva(m):
    from open_pandora_tpu.core.config import CLIPTowerConfig
    cfg = CLIPTowerConfig(image_size=28, patch_size=14, width=64, layers=2,
                          heads=2, select_layer=-2, tower_type="eva_vit_g",
                          mlp_ratio=4.0)
    tower = m["eva_tower"].EVAVisionTower(cfg)
    x = jax.random.uniform(jax.random.PRNGKey(1), (2, 28, 28, 3))
    return (lambda: tower.init(jax.random.PRNGKey(0), x),
            lambda p: [tower.apply(p, x)])


def _t5_and_hfclip(m):
    from open_pandora_tpu.core.config import CLIPTextConfig
    ee = m["encoders_extra"]
    t5 = ee.T5Encoder(ee.T5Config(vocab_size=97, d_model=32, d_kv=8, d_ff=48,
                                  num_layers=2, num_heads=4,
                                  relative_buckets=8,
                                  relative_max_distance=16))
    clip = ee.HFCLIPTextEncoder(CLIPTextConfig(width=32, layers=2, heads=2,
                                               context_length=8,
                                               vocab_size=97))
    ids = jnp.array([[3, 14, 15, 92, 65, 35, 0, 0]], jnp.int32)

    def init():
        return {"t5": t5.init(jax.random.PRNGKey(0), ids),
                "clip": clip.init(jax.random.PRNGKey(1), ids)}

    return init, lambda p: [t5.apply(p["t5"], ids),
                            clip.apply(p["clip"], ids)]


FAMILIES = {"dynamicrafter": _dynamicrafter, "world_model": _world_model,
            "eva_tower": _eva, "t5_hfclip": _t5_and_hfclip}


def _shapes(tree):
    return jax.tree_util.tree_map(lambda x: (x.shape, str(x.dtype)), tree)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_param_tree_matches_flax(builds, family):
    ours, theirs = (FAMILIES[family](m) for m in builds)
    assert _shapes(ours[0]()) == _shapes(theirs[0]())


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_outputs_match_flax(builds, family):
    ours, theirs = (FAMILIES[family](m) for m in builds)
    params = theirs[0]()
    for got, want in zip(ours[1](params), theirs[1](params)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)


def _full_depth_config():
    """The shipped UNet/VAE depth and level layout at small widths."""
    from open_pandora_tpu.core.config import (CLIPTextConfig,
                                              CLIPVisionConfig,
                                              PandoraConfig, ResamplerConfig)
    base = PandoraConfig()
    return dataclasses.replace(
        base,
        unet=dataclasses.replace(base.unet, model_channels=32,
                                 num_head_channels=16, context_dim=32),
        vae=dataclasses.replace(base.vae, base_channels=32),
        clip_text=CLIPTextConfig(width=32, layers=1, heads=2),
        clip_vision=CLIPVisionConfig(image_size=28, patch_size=14, width=32,
                                     layers=1, heads=2),
        resampler=ResamplerConfig(dim=32, depth=1, dim_head=16, heads=2,
                                  num_queries=16, embedding_dim=32,
                                  output_dim=32, video_length=16))


def test_param_shapes_do_not_depend_on_spatial_size():
    """random_params initialises at 64x64; the product runs at 320x512 and
    576x1024."""
    from open_pandora_tpu.models.dynamicrafter import DynamiCrafter
    model = DynamiCrafter(_full_depth_config())
    trees = [jax.eval_shape(lambda hw=hw: model.init_params(
        jax.random.PRNGKey(0), height=hw[0], width=hw[1]))
        for hw in ((64, 64), (320, 512), (576, 1024))]
    assert _shapes(trees[0]) == _shapes(trees[1]) == _shapes(trees[2])


def test_random_params_casts_float_leaves():
    from tests.test_dynamicrafter import TINY
    from open_pandora_tpu.models.dynamicrafter import (DynamiCrafter,
                                                       random_params)
    model = DynamiCrafter(TINY)
    ref = model.init_params(jax.random.PRNGKey(0), height=64, width=64)
    got = random_params(model, 0, jnp.bfloat16)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(ref)
    for g, r in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        assert g.shape == r.shape
        assert g.dtype == (jnp.bfloat16 if r.dtype == jnp.float32
                           else r.dtype)
        np.testing.assert_array_equal(np.asarray(g, np.float32),
                                      np.asarray(r.astype(g.dtype),
                                                 np.float32))


def test_random_params_zero_std_replaces_zero_leaves():
    """zero_std turns the zero-initialised leaves (out convs, proj_outs)
    into noise and keeps every other leaf."""
    from tests.test_dynamicrafter import TINY
    from open_pandora_tpu.models.dynamicrafter import (DynamiCrafter,
                                                       random_params)
    model = DynamiCrafter(TINY)
    ref = random_params(model, 0)
    got = random_params(model, 0, zero_std=1e-2)
    n_zero = 0
    for g, r in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        r, g = np.asarray(r), np.asarray(g)
        if np.issubdtype(r.dtype, np.floating) and not r.any():
            n_zero += 1
            assert g.any() and np.abs(g).max() < 0.1
            if g.size >= 100:
                assert 0.005 < g.std() < 0.02
        else:
            np.testing.assert_array_equal(g, r)
    assert n_zero > 0
