"""The UNet's convolution sites against numpy: the 3x3 same-pad spatial
conv, the k=(3,1,1) temporal conv in both formulations, the ResBlock's
residual path and the nearest-2x Upsample."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from open_pandora_tpu.core import flags, nn
from open_pandora_tpu.models.unet3d import (ResBlock, TemporalConvBlock,
                                            Upsample, _conv3x3, _TConv3)


def _np_conv(x, w, b, pad):
    """Channel-last cross-correlation, stride 1; pad per spatial dim."""
    x = np.pad(x, [(0, 0)] + [(p, p) for p in pad] + [(0, 0)])
    ks = w.shape[:-2]
    out_sp = [x.shape[1 + i] - ks[i] + 1 for i in range(len(ks))]
    out = np.zeros((x.shape[0], *out_sp, w.shape[-1]))
    for idx in np.ndindex(*ks):
        sl = tuple(slice(i, i + o) for i, o in zip(idx, out_sp))
        out += np.einsum("b...c,cd->b...d", x[(slice(None),) + sl], w[idx])
    return out + b


def _rand(key, *shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(key), shape))


class _Conv3x3(nn.Module):
    features: int

    @nn.compact
    def __call__(self, x):
        return _conv3x3(self.features, "conv", jnp.float32)(x)


@pytest.mark.parametrize("shape", [(2, 8, 16, 32, 32), (1, 8, 16, 32, 64),
                                   (2, 5, 7, 8, 16)])
def test_spatial_conv3x3_matches_numpy(shape):
    b, h, w, c, co = shape
    x = _rand(0, b, h, w, c)
    m = _Conv3x3(co)
    params = m.init(jax.random.PRNGKey(1), x)
    p = params["params"]["conv"]
    assert p["kernel"].shape == (3, 3, c, co) and p["bias"].shape == (co,)
    p["bias"] = jnp.asarray(_rand(2, co))
    out = m.apply(params, x)
    ref = _np_conv(x, np.asarray(p["kernel"]), np.asarray(p["bias"]), (1, 1))
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 4, 3, 5, 16), (1, 16, 2, 2, 8)])
def test_temporal_conv_matches_numpy(shape):
    b, t, h, w, c = shape
    x = _rand(0, b, t, h, w, c)
    m = _TConv3(features=c)
    params = m.init(jax.random.PRNGKey(1), x)
    k = np.asarray(params["params"]["kernel"])
    assert k.shape == (3, 1, 1, c, c)
    out = m.apply(params, x)
    ref = _np_conv(x, k, 0.0, (1, 0, 0))
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-4, atol=1e-4)


def test_temporal_conv_block_formulations_agree():
    """PANDORA_DISABLE_TCONV_DOT swaps the shifted-dot form for lax.conv
    over the same parameter tree."""
    x = jnp.asarray(_rand(0, 2, 4, 3, 3, 32))
    block = TemporalConvBlock(dropout=0.0)
    params = block.init(jax.random.PRNGKey(1), x)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * jax.random.normal(jax.random.PRNGKey(2),
                                               p.shape), params)
    dot = block.apply(params, x)
    with flags.overridden(DISABLE_TCONV_DOT=True):
        assert jax.tree_util.tree_structure(
            block.init(jax.random.PRNGKey(1), x)) == \
            jax.tree_util.tree_structure(params)
        conv = block.apply(params, x)
    np.testing.assert_allclose(np.asarray(dot), np.asarray(conv),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c_in,c_out", [(32, 32), (32, 64)])
def test_resblock_residual_path(c_in, c_out):
    """Zero-init out_conv: the block is exactly its skip path (identity, or
    the 1x1 skip conv when the width changes)."""
    x = jnp.asarray(_rand(0, 2, 6, 6, c_in))
    emb = jnp.asarray(_rand(1, 2, 16))
    block = ResBlock(out_ch=c_out)
    params = block.init(jax.random.PRNGKey(3), x, emb, 2)
    out = np.asarray(block.apply(params, x, emb, 2))
    if c_in == c_out:
        np.testing.assert_array_equal(out, np.asarray(x))
    else:
        sk = params["params"]["skip_connection"]
        ref = _np_conv(np.asarray(x), np.asarray(sk["kernel"]),
                       np.asarray(sk["bias"]), (0, 0))
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_upsample_is_nearest_then_conv():
    x = _rand(0, 2, 3, 4, 8)
    m = Upsample()
    params = m.init(jax.random.PRNGKey(1), x)
    p = params["params"]["conv"]
    up = x.repeat(2, axis=1).repeat(2, axis=2)
    ref = _np_conv(up, np.asarray(p["kernel"]), np.asarray(p["bias"]), (1, 1))
    np.testing.assert_allclose(np.asarray(m.apply(params, x)), ref,
                               rtol=1e-4, atol=1e-4)
