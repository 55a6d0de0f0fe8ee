"""The attention dispatcher and the norm primitives.

Attention: every product site class (scaled down in length, at the real
head widths) through `ops.attention.attention`, forward and gradient, in
bf16 and float32, against a float64 numpy reference; the route rule
(`choose_implementation`) as a pure function of platform, dtype, mask and
shape at the product's real shapes. The cuDNN route itself runs only on a
GPU (marker `gpu`; chip_smoke.py checks the same at full width).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from open_pandora_tpu.ops.attention import (CUDNN_MIN_SCORES, attention,
                                            choose_implementation)
from open_pandora_tpu.ops.attention_xla import mha_xla
from open_pandora_tpu.ops.norms import group_norm, layer_norm, rms_norm


def _rand(key, *shape):
    return jax.random.normal(jax.random.PRNGKey(key), shape, dtype=jnp.float32)


# ---------------------------------------------------------------------------
# numpy float64 reference (forward and backward)
# ---------------------------------------------------------------------------


def _np_mask(n, m, causal, key_keep):
    mask = np.ones((n, m), bool)
    if causal:
        mask &= np.arange(m)[None, :] <= np.arange(n)[:, None] + (m - n)
    full = mask[None, None]
    if key_keep is not None:
        full = full & key_keep[:, None, None, :]
    return full


def _np_attention(q, k, v, causal, key_keep):
    """-> (out, probs); q (B, N, H, D), k/v (B, M, H, D), float64."""
    scale = q.shape[-1] ** -0.5
    s = np.einsum("bnhd,bmhd->bhnm", q, k) * scale
    s = np.where(_np_mask(q.shape[1], k.shape[1], causal, key_keep), s,
                 -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhnm,bmhd->bnhd", p, v), p


def _np_grads(q, k, v, w, causal, key_keep):
    """Gradients of sum(attention(q, k, v) * w) w.r.t. q, k, v."""
    scale = q.shape[-1] ** -0.5
    _, p = _np_attention(q, k, v, causal, key_keep)
    dv = np.einsum("bhnm,bnhd->bmhd", p, w)
    dp = np.einsum("bnhd,bmhd->bhnm", w, v)
    ds = p * (dp - (dp * p).sum(-1, keepdims=True))
    dq = np.einsum("bhnm,bmhd->bnhd", ds, k) * scale
    dk = np.einsum("bhnm,bnhd->bmhd", ds, q) * scale
    return dq, dk, dv


# (name, B, N, M, H, D, causal, padded keys): the product's site classes
# with the real head counts and widths, shorter sequences.
SITES = [
    ("spatial_self", 2, 96, 96, 5, 64, False, 0),
    ("text_cross", 2, 96, 77, 5, 64, False, 0),
    ("image_cross", 2, 96, 16, 5, 64, False, 0),
    ("temporal", 24, 16, 16, 5, 64, False, 0),
    ("llama_prefill_padded", 1, 40, 40, 4, 128, True, 5),
    ("decode_suffix_causal", 1, 4, 24, 4, 128, True, 0),
]
# max|d| / max|ref| against float64
TOL = {jnp.float32: 2e-5, jnp.bfloat16: 2e-2}


def _site_inputs(b, n, m, h, d, padded):
    q, k, v, w = (np.asarray(_rand(i, b, x, h, d), np.float64)
                  for i, x in enumerate((n, m, m, n)))
    keep = None
    if padded:
        keep = np.ones((b, m), bool)
        keep[:, 1:1 + padded] = False
    return q, k, v, w, keep


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("site", SITES, ids=[s[0] for s in SITES])
def test_attention_forward_matches_numpy(site, dtype):
    _, b, n, m, h, d, causal, padded = site
    q, k, v, _, keep = _site_inputs(b, n, m, h, d, padded)
    mask = None if keep is None else jnp.asarray(keep)[:, None, None, :]
    out = attention(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                    causal=causal, mask=mask)
    assert out.shape == q.shape and out.dtype == dtype
    ref, _ = _np_attention(q, k, v, causal, keep)
    err = np.abs(np.asarray(out, np.float64) - ref).max() / np.abs(ref).max()
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("site", SITES, ids=[s[0] for s in SITES])
def test_attention_gradient_matches_numpy(site, dtype):
    _, b, n, m, h, d, causal, padded = site
    q, k, v, w, keep = _site_inputs(b, n, m, h, d, padded)
    mask = None if keep is None else jnp.asarray(keep)[:, None, None, :]

    def loss(q, k, v):
        out = attention(q, k, v, causal=causal, mask=mask)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(w, jnp.float32))

    got = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x, dtype) for x in (q, k, v)))
    for g, r, name in zip(got, _np_grads(q, k, v, w, causal, keep), "qkv"):
        err = np.abs(np.asarray(g, np.float64) - r).max() / np.abs(r).max()
        assert err <= 2 * TOL[dtype], f"d{name}: {err}"


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------

BF16, FP32, FP16 = jnp.bfloat16, jnp.float32, jnp.float16

# (platform, dtype, q shape, k shape, causal, masked) -> route, at the real
# shapes of the 320x512x16f CFG-pair eval, 576x1024, the VAE mid-block,
# the vision towers and the LLaMA-7B prefill.
ROUTES = [
    ("gpu", BF16, (32, 2560, 5, 64), (32, 2560, 5, 64), False, False,
     "cudnn"),                                       # spatial L0
    ("gpu", BF16, (32, 9216, 5, 64), (32, 9216, 5, 64), False, False,
     "cudnn"),                                       # spatial L0, 576x1024
    ("gpu", BF16, (32, 640, 10, 64), (32, 640, 10, 64), False, False,
     "cudnn"),                                       # spatial L1
    ("gpu", BF16, (32, 160, 20, 64), (32, 160, 20, 64), False, False,
     "xla"),                                         # spatial L2: short
    ("gpu", BF16, (32, 2560, 5, 64), (32, 77, 5, 64), False, False,
     "cudnn"),                                       # text cross
    ("gpu", BF16, (32, 2560, 5, 64), (32, 16, 5, 64), False, False,
     "xla"),                                         # image cross, M=16
    ("gpu", BF16, (5120, 16, 5, 64), (5120, 16, 5, 64), False, False,
     "xla"),                                         # temporal t=16
    ("gpu", BF16, (16, 2560, 1, 512), (16, 2560, 1, 512), False, False,
     "xla"),                                         # VAE mid: D=512
    ("gpu", FP16, (2, 257, 16, 64), (2, 257, 16, 64), False, False,
     "cudnn"),                                       # vision tower, fp16
    ("gpu", BF16, (1, 512, 32, 128), (1, 512, 32, 128), True, True,
     "xla"),                                         # LLaMA, padded bucket
    ("gpu", BF16, (1, 512, 32, 128), (1, 512, 32, 128), True, False,
     "cudnn"),                                       # LLaMA, no pads
    ("gpu", BF16, (1, 1, 32, 128), (1, 512, 32, 128), True, False,
     "xla"),                                         # causal, M != N
    ("gpu", FP32, (32, 2560, 5, 64), (32, 2560, 5, 64), False, False,
     "xla"),                                         # golden fp32
    ("cpu", BF16, (32, 2560, 5, 64), (32, 2560, 5, 64), False, False,
     "xla"),                                         # no GPU
]


@pytest.mark.parametrize("platform,dtype,qs,ks,causal,masked,want", ROUTES)
def test_route_rule(platform, dtype, qs, ks, causal, masked, want):
    assert choose_implementation(platform, dtype, qs, ks, causal=causal,
                                 has_mask=masked) == want


def test_route_threshold_is_score_count():
    n = int(np.sqrt(CUDNN_MIN_SCORES))
    at = choose_implementation("gpu", BF16, (1, n, 4, 64), (1, n, 4, 64),
                               causal=False, has_mask=False)
    below = choose_implementation("gpu", BF16, (1, n - 1, 4, 64),
                                  (1, n, 4, 64), causal=False,
                                  has_mask=False)
    assert (at, below) == ("cudnn", "xla")


def test_dispatcher_cpu_uses_xla():
    """Off the GPU every shape takes the XLA route, bit-identical."""
    q = _rand(0, 2, 256, 5, 64).astype(jnp.bfloat16)
    np.testing.assert_array_equal(np.asarray(attention(q, q, q), np.float32),
                                  np.asarray(mha_xla(q, q, q), np.float32))


def test_dispatcher_suffix_causal():
    """Causal with m > n aligns q to the END of kv (decode semantics)."""
    q = _rand(0, 1, 4, 2, 64)
    k = _rand(1, 1, 16, 2, 64)
    v = _rand(2, 1, 16, 2, 64)
    out = attention(q, k, v, causal=True)
    # last q row attends to all 16; first q row to 13
    mask = np.zeros((1, 1, 4, 16), bool)
    for i in range(4):
        mask[..., i, : 13 + i] = True
    ref = mha_xla(q, k, v, mask=jnp.asarray(mask))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-6)


@pytest.mark.gpu
def test_cudnn_route_matches_reference():
    if jax.default_backend() != "gpu":
        pytest.skip("the cuDNN route needs a GPU")
    q, k, v = (_rand(i, 4, 1024, 5, 64) for i in range(3))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(mha_xla(q, k, v))
    out = np.asarray(attention(*(x.astype(BF16) for x in (q, k, v))),
                     np.float32)
    assert np.abs(out - ref).max() / np.abs(ref).max() <= 2e-2


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def _np_group_norm(x, scale, bias, groups, eps, silu):
    x = np.asarray(x, np.float64)
    n, c = x.shape[0], x.shape[-1]
    xg = x.reshape(n, -1, groups, c // groups)
    mean = xg.mean(axis=(1, 3), keepdims=True)
    var = xg.var(axis=(1, 3), keepdims=True)
    y = ((xg - mean) / np.sqrt(var + eps)).reshape(x.shape) * scale + bias
    return y / (1 + np.exp(-y)) if silu else y


# shapes of the UNet's and VAE's GroupNorm sites, scaled down
GN_CASES = [
    ((3, 8, 16, 64), 32, 1e-5, True),     # ResBlock-like NHWC
    ((2, 40, 64), 8, 1e-6, True),         # pre-flattened (N, L, C)
    ((2, 4, 6, 8, 64), 16, 1e-5, False),  # TemporalConvBlock (b,t,h,w,c)
    ((2, 5, 8, 320), 32, 1e-6, False),    # transformer pre-norm, C=320
]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,groups,eps,silu", GN_CASES)
def test_group_norm_matches_numpy(shape, groups, eps, silu, dtype):
    x = np.asarray(_rand(0, *shape)) * 3.0 + 1.0
    c = shape[-1]
    s = 1.0 + 0.1 * np.asarray(_rand(1, c))
    b = 0.05 * np.asarray(_rand(2, c))
    out = group_norm(jnp.asarray(x, dtype), jnp.asarray(s), jnp.asarray(b),
                     num_groups=groups, eps=eps, silu=silu)
    assert out.dtype == dtype and out.shape == shape
    ref = _np_group_norm(np.asarray(jnp.asarray(x, dtype), np.float64), s, b,
                         groups, eps, silu)
    tol = 1e-5 if dtype == jnp.float32 else 2e-2
    np.testing.assert_allclose(np.asarray(out, np.float64), ref,
                               atol=tol * 4, rtol=tol)


def test_group_norm_grad_finite_and_nonzero():
    x = _rand(0, 2, 6, 8, 64)
    s, b = 1.0 + 0.1 * _rand(1, 64), jnp.zeros((64,))
    g = jax.grad(lambda x, s: jnp.sum(
        group_norm(x, s, b, num_groups=16, silu=True) ** 2),
        argnums=(0, 1))(x, s)
    assert all(bool(jnp.isfinite(a).all()) and float(jnp.abs(a).max()) > 0
               for a in g)


def test_group_norm_matches_torch():
    torch = pytest.importorskip("torch")
    x = np.random.RandomState(0).randn(2, 8, 8, 64).astype(np.float32)
    w = np.random.RandomState(1).randn(64).astype(np.float32)
    b = np.random.RandomState(2).randn(64).astype(np.float32)
    gn = torch.nn.GroupNorm(32, 64, eps=1e-5)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(w))
        gn.bias.copy_(torch.from_numpy(b))
        # torch is NCHW
        ref = gn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    out = group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), num_groups=32)
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-5, rtol=1e-5)


def test_layer_norm_matches_torch():
    torch = pytest.importorskip("torch")
    x = np.random.RandomState(0).randn(4, 16, 128).astype(np.float32)
    w = np.random.RandomState(1).randn(128).astype(np.float32)
    b = np.random.RandomState(2).randn(128).astype(np.float32)
    ln = torch.nn.LayerNorm(128)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(w))
        ln.bias.copy_(torch.from_numpy(b))
        ref = ln(torch.from_numpy(x)).numpy()
    out = layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-5, rtol=1e-5)


def test_layer_norm_matches_numpy():
    x = np.asarray(_rand(0, 4, 16, 128), np.float64)
    w = np.asarray(_rand(1, 128), np.float64)
    b = np.asarray(_rand(2, 128), np.float64)
    out = layer_norm(jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32),
                     jnp.asarray(b, jnp.float32))
    ref = (x - x.mean(-1, keepdims=True)) / np.sqrt(
        x.var(-1, keepdims=True) + 1e-5) * w + b
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-5, rtol=1e-5)


def test_rms_norm_bf16_semantics():
    # HF LlamaRMSNorm: fp32 variance, cast back BEFORE scale
    x = (np.random.RandomState(0).randn(4, 128) * 3).astype(np.float32)
    w = np.random.RandomState(1).randn(128).astype(np.float32)
    xb = jnp.asarray(x, dtype=jnp.bfloat16)
    out = rms_norm(xb, jnp.asarray(w))
    xf = x.astype(np.float32)
    ref = xf / np.sqrt((xf ** 2).mean(-1, keepdims=True) + 1e-6)
    ref = ref.astype(jnp.bfloat16).astype(np.float32) * w
    np.testing.assert_allclose(
        np.asarray(out, dtype=np.float32), ref, atol=3e-2, rtol=3e-2)


def test_group_norm_silu_fused():
    x = np.random.RandomState(0).randn(2, 4, 4, 32).astype(np.float32)
    w = np.ones(32, np.float32)
    b = np.zeros(32, np.float32)
    fused = group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), silu=True)
    plain = group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ref = np.asarray(plain) / (1 + np.exp(-np.asarray(plain)))
    np.testing.assert_allclose(np.asarray(fused), ref, atol=1e-6)
