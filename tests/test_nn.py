"""core/nn.py: the module layer the models are written in.

Each primitive is checked against flax.linen (while flax is installed):
the same parameter tree (names and shapes) from `init`, and the same
output from `apply` with flax's parameters. The module mechanics (naming,
setup, fields, remat, rngs, method=, mutable=) are checked on their own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from open_pandora_tpu.core import nn

X3 = (2, 5, 6)


def _shapes(tree):
    return jax.tree_util.tree_map(lambda x: (x.shape, str(x.dtype)), tree)


# (name, factory(nn_module) -> layer, input shape, integer input)
PRIMITIVES = [
    ("dense", lambda m: m.Dense(7), X3, False),
    ("dense_bf16_nobias", lambda m: m.Dense(7, use_bias=False,
                                            dtype=jnp.bfloat16), X3, False),
    ("conv2d_same", lambda m: m.Conv(6, (3, 3)), (2, 8, 8, 4), False),
    ("conv2d_pad1_stride2", lambda m: m.Conv(6, (3, 3), strides=2,
                                             padding=1), (2, 9, 9, 4), False),
    ("conv2d_valid_1x1", lambda m: m.Conv(5, (1, 1), padding="VALID"),
     (2, 4, 4, 3), False),
    ("conv3d_temporal", lambda m: m.Conv(
        4, (3, 1, 1), padding=((1, 1), (0, 0), (0, 0))), (1, 4, 3, 3, 4),
     False),
    ("conv_two_batch_dims", lambda m: m.Conv(4, (3, 3), padding=1),
     (2, 3, 6, 6, 4), False),
    ("embed", lambda m: m.Embed(11, 6), (2, 5), True),
    ("embed_bf16", lambda m: m.Embed(11, 6, dtype=jnp.bfloat16), (2, 5),
     True),
]


@pytest.mark.parametrize("name,make,shape,integer", PRIMITIVES,
                         ids=[p[0] for p in PRIMITIVES])
def test_primitive_matches_flax(name, make, shape, integer):
    flax_nn = pytest.importorskip("flax.linen")
    key = jax.random.PRNGKey(0)
    if integer:
        x = jax.random.randint(key, shape, 0, 11)
    else:
        x = jax.random.normal(key, shape)
    ours, theirs = make(nn), make(flax_nn)
    p_ours = ours.init(jax.random.PRNGKey(1), x)
    p_flax = theirs.init(jax.random.PRNGKey(1), x)
    assert _shapes(p_ours) == _shapes(jax.tree_util.tree_map(
        jnp.asarray, dict(p_flax)))
    got = ours.apply(p_flax, x)
    want = theirs.apply(p_flax, x)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=1e-6, atol=1e-6)


def _naming_module(m):
    """One module using every way of naming a submodule."""

    class Inner(m.Module):
        feat: int

        @m.compact
        def __call__(self, x):
            return m.Dense(self.feat)(x) + self.param(
                "offset", m.initializers.zeros, (self.feat,))

    class WithSetup(m.Module):
        def setup(self):
            self.proj = m.Dense(3)
            self.blocks = [Inner(3), Inner(3)]
            self.scale = self.param("scale", m.initializers.ones, (3,))

        def __call__(self, x):
            x = self.proj(x)
            for b in self.blocks:
                x = b(x)
            return x * self.scale

        def project(self, x):
            return self.proj(x)

    class Outer(m.Module):
        child: m.Module

        @m.compact
        def __call__(self, x):
            x = m.Dense(4)(x)            # Dense_0
            x = m.Dense(4)(x)            # Dense_1
            x = Inner(4, name="named")(x)
            x = WithSetup()(x)           # WithSetup_0
            return self.child(x)         # field: child

    return Outer(child=m.Dense(2))


def test_submodule_naming_matches_flax():
    flax_nn = pytest.importorskip("flax.linen")
    x = jnp.ones((2, 5))
    ours = _naming_module(nn).init(jax.random.PRNGKey(0), x)
    theirs = _naming_module(flax_nn).init(jax.random.PRNGKey(0), x)
    assert _shapes(ours) == _shapes(dict(theirs))
    np.testing.assert_allclose(
        _naming_module(nn).apply(theirs, x),
        _naming_module(flax_nn).apply(theirs, x), rtol=1e-6)


def test_apply_method_forms():
    class M(nn.Module):
        def setup(self):
            self.proj = nn.Dense(3)

        def __call__(self, x):
            return self.proj(x) * 2

        def half(self, x):
            return self.proj(x) / 2

    m, x = M(), jnp.ones((1, 4))
    params = m.init(jax.random.PRNGKey(0), x)
    full = m.apply(params, x)
    np.testing.assert_allclose(m.apply(params, x, method=M.half), full / 4)
    np.testing.assert_allclose(m.apply(params, x, method="half"), full / 4)
    np.testing.assert_allclose(
        m.apply(params, x, method=lambda mod, y: mod.proj(y)), full / 2)


def test_capture_intermediates():
    class Two(nn.Module):
        @nn.compact
        def __call__(self, x):
            x = nn.Dense(3)(x)
            return nn.Dense(2)(x)

    m, x = Two(), jnp.ones((1, 4))
    params = m.init(jax.random.PRNGKey(0), x)
    out, state = m.apply(params, x, capture_intermediates=True,
                         mutable=["intermediates"])
    inter = state["intermediates"]
    assert inter["Dense_1"]["__call__"][0].shape == (1, 2)
    np.testing.assert_allclose(inter["__call__"][0], out)


def test_remat_matches_plain_gradient():
    class Block(nn.Module):
        @nn.compact
        def __call__(self, x, train: bool):
            y = jnp.tanh(nn.Dense(8)(x))
            return nn.Dropout(0.5, deterministic=not train)(y)

    class Net(nn.Module):
        remat: bool

        @nn.compact
        def __call__(self, x):
            cls = nn.remat(Block, static_argnums=(2,)) if self.remat else Block
            return cls(name="b0")(cls(name="b1")(x, False), False).sum()

    x = jax.random.normal(jax.random.PRNGKey(1), (3, 8))
    params = Net(False).init(jax.random.PRNGKey(0), x)
    assert _shapes(Net(True).init(jax.random.PRNGKey(0), x)) == \
        _shapes(params)
    g_plain = jax.grad(lambda p: Net(False).apply(p, x))(params)
    g_remat = jax.grad(lambda p: Net(True).apply(p, x))(params)
    for a, b in zip(jax.tree_util.tree_leaves(g_plain),
                    jax.tree_util.tree_leaves(g_remat)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_dropout_rng_and_scaling():
    d = nn.Dropout(0.25)
    x = jnp.ones((4096,))
    assert (d.apply({}, x, deterministic=True) == x).all()
    y = d.apply({}, x, deterministic=False,
                rngs={"dropout": jax.random.PRNGKey(0)})
    kept = np.asarray(y) != 0
    assert 0.7 < kept.mean() < 0.8
    np.testing.assert_allclose(np.asarray(y)[kept], 1 / 0.75, rtol=1e-6)
    y2 = d.apply({}, x, deterministic=False,
                 rngs={"dropout": jax.random.PRNGKey(1)})
    assert (np.asarray(y2) != np.asarray(y)).any()
    with pytest.raises(ValueError, match="dropout"):
        d.apply({}, x, deterministic=False)


def test_missing_param_and_unbound_call_raise():
    m, x = nn.Dense(3), jnp.ones((1, 4))
    with pytest.raises(KeyError, match="kernel"):
        m.apply({"params": {}}, x)
    with pytest.raises(ValueError, match="not bound"):
        m.param("w", nn.initializers.zeros, (1,))


def test_flatten_unflatten_roundtrip():
    tree = {"a": {"b": 1, "c": {"d": 2}}, "e": 3}
    flat = nn.flatten_dict(tree)
    assert flat[("a", "c", "d")] == 2
    assert nn.unflatten_dict(flat) == tree
