"""A small module layer with flax.linen's interface, on JAX alone.

The models are written against the subset of `flax.linen` below, and the
parameter trees keep flax's names and shapes, so checkpoints and the
torch->JAX converter (`core/convert.py`) are unchanged. What it provides:

  - `Module`: subclasses are dataclasses. Submodules are named explicitly
    (`name=`), after the attribute they are assigned to in `setup`, after
    the dataclass field that holds them, or automatically as
    `<ClassName>_<n>` inside a `@compact` method. `self.param`,
    `self.make_rng`, `init`/`apply` with `method=`, `rngs=`, `mutable=` and
    `capture_intermediates=`.
  - layers: `Dense`, `Conv`, `Dropout`, `Embed`;
  - `remat(cls, static_argnums=...)` (static_argnums count `self` as 0);
  - `initializers` (which is `jax.nn.initializers`).

Variables live in one nested dict per collection ("params", and
"intermediates" when captured). A bound module knows its path in that
tree; `param` reads the leaf at its path, or creates it while
initializing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import types
import zlib
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
from jax import lax

initializers = jax.nn.initializers

_EXCLUDED = frozenset({"setup", "__post_init__", "__init__", "__eq__",
                       "__hash__", "__repr__", "__getattr__", "__setattr__",
                       "init", "apply", "param", "make_rng"})


def compact(fn):
    """Marks a method that defines submodules inline (kept for flax
    compatibility: every method of a bound module may do so)."""
    fn.compact = True
    return fn


class _Context:
    """State of one `init` or `apply` call."""

    def __init__(self, variables, rngs, initializing, capture):
        self.variables = variables
        self.rngs = rngs
        self.initializing = initializing
        self.capture = capture
        self.rng_count = 0
        self.overrides = {}

    def node(self, path, create):
        for i in range(len(path), -1, -1):
            if path[:i] in self.overrides:
                node, rest = self.overrides[path[:i]], path[i:]
                break
        else:
            node, rest = self.variables.setdefault("params", {}), path
        for p in rest:
            if p not in node:
                if not create:
                    return None
                node[p] = {}
            node = node[p]
        return node

    @contextlib.contextmanager
    def override(self, path, params):
        saved = self.overrides.get(path)
        self.overrides[path] = params
        try:
            yield
        finally:
            if saved is None:
                self.overrides.pop(path)
            else:
                self.overrides[path] = saved

    def make_rng(self, path, name):
        if name not in self.rngs:
            raise ValueError(f"no PRNG key for stream {name!r}: pass "
                             f"rngs={{{name!r}: key}}")
        self.rng_count += 1
        key = jax.random.fold_in(self.rngs[name],
                                 zlib.crc32("/".join(path).encode()))
        return jax.random.fold_in(key, self.rng_count)


_STACK = threading.local()


def _current():
    stack = getattr(_STACK, "modules", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def _isolated():
    """Construct modules here as top-level (unbound) modules."""
    saved = getattr(_STACK, "modules", [])
    _STACK.modules = []
    try:
        yield
    finally:
        _STACK.modules = saved


def _unbound_copy(module):
    with _isolated():
        return dataclasses.replace(module)


@contextlib.contextmanager
def _entered(module):
    stack = _STACK.__dict__.setdefault("modules", [])
    stack.append(module)
    module._depth += 1
    try:
        yield
    finally:
        stack.pop()
        module._depth -= 1
        if module._depth == 0:
            module._autoname.clear()


def _wrap_method(fn):
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        if self._scope is None and self._pending_parent is not None:
            self._pending_parent._bind_child(self, self._reserved_name)
        if self._scope is None:
            return fn(self, *args, **kwargs)
        self._try_setup()
        with _entered(self):
            out = fn(self, *args, **kwargs)
        ctx, path = self._scope
        if ctx.capture and fn.__name__ == "__call__":
            node = ctx.variables.setdefault("intermediates", {})
            for p in path:
                node = node.setdefault(p, {})
            node["__call__"] = node.get("__call__", ()) + (out,)
        return out
    return wrapped


class Module:
    """Base class: subclasses become dataclasses with a kw-only `name`."""

    _scope: Optional[Tuple[_Context, Tuple[str, ...]]] = None
    _pending_parent: Optional["Module"] = None
    _reserved_name: Optional[str] = None
    _setup_done = False
    _in_setup = False
    _depth = 0

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        annotations = cls.__dict__.get("__annotations__", {})
        if "name" not in getattr(cls, "__dataclass_fields__", {}):
            cls.__annotations__ = {**annotations, "name": Optional[str]}
            cls.name = dataclasses.field(default=None, kw_only=True)
        for attr, val in list(cls.__dict__.items()):
            if (isinstance(val, types.FunctionType)
                    and attr not in _EXCLUDED and attr not in annotations
                    and (attr == "__call__" or not attr.startswith("_"))):
                setattr(cls, attr, _wrap_method(val))
        dataclasses.dataclass(cls, eq=True, unsafe_hash=True, repr=True)

    def __post_init__(self):
        object.__setattr__(self, "_autoname", {})
        parent = _current()
        if parent is None:
            return
        if self.name is not None:
            parent._bind_child(self, self.name)
        elif not parent._in_setup:
            prefix = type(self).__name__
            n = parent._autoname.get(prefix, 0)
            parent._autoname[prefix] = n + 1
            object.__setattr__(self, "_pending_parent", parent)
            object.__setattr__(self, "_reserved_name", f"{prefix}_{n}")
        else:
            object.__setattr__(self, "_pending_parent", parent)

    # -- binding ------------------------------------------------------------

    def _bind_child(self, child, name):
        ctx, path = self._require_scope()
        object.__setattr__(child, "_scope", (ctx, path + (name,)))
        object.__setattr__(child, "name", name)
        object.__setattr__(child, "_pending_parent", None)
        child._adopt_fields()

    def _adopt_fields(self):
        for f in dataclasses.fields(self):
            if f.name == "name":
                continue
            val = getattr(self, f.name)
            if isinstance(val, Module):
                val = _unbound_copy(val)
                self._bind_child(val, f.name)
            elif isinstance(val, (list, tuple)) and any(
                    isinstance(v, Module) for v in val):
                val = type(val)(_unbound_copy(v) if isinstance(v, Module)
                                else v for v in val)
                for i, v in enumerate(val):
                    if isinstance(v, Module):
                        self._bind_child(v, f"{f.name}_{i}")
            else:
                continue
            object.__setattr__(self, f.name, val)

    def _require_scope(self):
        if self._scope is None:
            raise ValueError(f"{type(self).__name__} is not bound: call it "
                             "through init/apply or from a bound module")
        return self._scope

    def _try_setup(self):
        if self._setup_done or self._scope is None:
            return
        object.__setattr__(self, "_setup_done", True)
        setup = getattr(type(self), "setup", None)
        if setup is None:
            return
        object.__setattr__(self, "_in_setup", True)
        try:
            with _entered(self):
                setup(self)
        finally:
            object.__setattr__(self, "_in_setup", False)

    def __setattr__(self, key, value):
        if self._in_setup:
            if isinstance(value, Module) and value._scope is None:
                self._bind_child(value, key)
            elif isinstance(value, (list, tuple)):
                for i, v in enumerate(value):
                    if isinstance(v, Module) and v._scope is None:
                        self._bind_child(v, f"{key}_{i}")
        object.__setattr__(self, key, value)

    def __getattr__(self, key):
        # attributes assigned in `setup` exist once setup has run
        if (not key.startswith("_") and self._scope is not None
                and not self._setup_done):
            self._try_setup()
            return getattr(self, key)
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {key!r}")

    # -- variables ------------------------------------------------------------

    def param(self, name: str, init_fn: Callable, *init_args):
        ctx, path = self._require_scope()
        node = ctx.node(path, create=ctx.initializing)
        if node is not None and name in node:
            return node[name]
        if not ctx.initializing:
            raise KeyError(f"parameter {'/'.join(path + (name,))} is "
                           "missing from the variables passed to apply")
        value = init_fn(ctx.make_rng(path, "params"), *init_args)
        node[name] = value
        return value

    def make_rng(self, name: str = "params") -> jax.Array:
        ctx, path = self._require_scope()
        return ctx.make_rng(path, name)

    # -- entry points ---------------------------------------------------------

    def _run(self, ctx, method, args, kwargs):
        bound = _unbound_copy(self)
        object.__setattr__(bound, "_scope", (ctx, ()))
        bound._adopt_fields()
        bound._try_setup()
        if method is None:
            method = type(bound).__call__
        elif isinstance(method, str):
            method = getattr(type(bound), method)
        with _entered(bound):
            return method(bound, *args, **kwargs)

    def init(self, rngs, *args, method=None, capture_intermediates=False,
             **kwargs):
        if not isinstance(rngs, dict):
            rngs = {"params": rngs}
        ctx = _Context({}, rngs, True, capture_intermediates)
        self._run(ctx, method, args, kwargs)
        if not ctx.variables.get("params"):
            ctx.variables.pop("params", None)
        return ctx.variables

    def apply(self, variables, *args, rngs=None, method=None,
              mutable: Union[bool, str, Sequence[str]] = False,
              capture_intermediates: bool = False, **kwargs):
        if rngs is not None and not isinstance(rngs, dict):
            rngs = {"params": rngs}
        ctx = _Context(dict(variables), dict(rngs or {}), False,
                       capture_intermediates)
        out = self._run(ctx, method, args, kwargs)
        if mutable is False:
            return out
        if mutable is True:
            names = [k for k in ctx.variables if k != "params"]
        else:
            names = [mutable] if isinstance(mutable, str) else list(mutable)
        return out, {k: ctx.variables.get(k, {}) for k in names}


def remat(target, static_argnums: Sequence[int] = ()):
    """Rematerialise `target.__call__` in the backward pass (jax.checkpoint).
    As in flax, `static_argnums` index the call with `self` as 0."""
    call = target.__call__
    static = {i - 1 for i in static_argnums}

    def __call__(self, *args, **kwargs):
        ctx, path = self._require_scope()
        if ctx.initializing or ctx.capture:
            return call(self, *args, **kwargs)
        dyn = [i for i in range(len(args)) if i not in static]

        def run(params, dyn_args, kw):
            full = list(args)
            for i, a in zip(dyn, dyn_args):
                full[i] = a
            with ctx.override(path, params):
                return call(self, *full, **kw)

        params = ctx.node(path, create=False) or {}
        return jax.checkpoint(run)(params, [args[i] for i in dyn], kwargs)

    return type("Checkpoint" + target.__name__, (target,),
                {"__call__": __call__, "__module__": target.__module__})


def _promote(*args, dtype=None):
    """flax.linen.dtypes.promote_dtype: cast all to `dtype`, or to the
    inferred result type (at least float32 for integers)."""
    if dtype is None:
        dtype = jnp.result_type(*[a for a in args if a is not None])
        if not jnp.issubdtype(dtype, jnp.inexact):
            dtype = jnp.promote_types(jnp.float32, dtype)
    return [None if a is None else jnp.asarray(a, dtype) for a in args]


class Dense(Module):
    features: int
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    def __call__(self, inputs):
        kernel = self.param("kernel", self.kernel_init,
                            (jnp.shape(inputs)[-1], self.features),
                            self.param_dtype)
        bias = (self.param("bias", self.bias_init, (self.features,),
                           self.param_dtype) if self.use_bias else None)
        inputs, kernel, bias = _promote(inputs, kernel, bias,
                                        dtype=self.dtype)
        y = lax.dot_general(inputs, kernel,
                            (((inputs.ndim - 1,), (0,)), ((), ())))
        if bias is not None:
            y = y + jnp.reshape(bias, (1,) * (y.ndim - 1) + (-1,))
        return y


def _conv_padding(padding, n):
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    out = []
    for p in padding:
        out.append((p, p) if isinstance(p, int) else tuple(p))
    return out


class Conv(Module):
    """Channel-last convolution; kernel (*kernel_size, in, out)."""

    features: int
    kernel_size: Union[int, Sequence[int]]
    strides: Union[int, Sequence[int]] = 1
    padding: Any = "SAME"
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    def __call__(self, inputs):
        ks = ((self.kernel_size,) if isinstance(self.kernel_size, int)
              else tuple(self.kernel_size))

        strides = ((self.strides,) * len(ks) if isinstance(self.strides, int)
                   else tuple(self.strides))

        n_batch = inputs.ndim - (len(ks) + 1)
        batch_shape = inputs.shape[:n_batch]
        if n_batch != 1:
            inputs = jnp.reshape(inputs, (-1,) + inputs.shape[n_batch:])
        in_features = inputs.shape[-1]
        kernel = self.param(
            "kernel", self.kernel_init,
            ks + (in_features, self.features),
            self.param_dtype)
        bias = (self.param("bias", self.bias_init, (self.features,),
                           self.param_dtype) if self.use_bias else None)
        inputs, kernel, bias = _promote(inputs, kernel, bias,
                                        dtype=self.dtype)
        spatial = "".join("DHW"[3 - len(ks):]) if len(ks) <= 3 else None
        if spatial is None:
            raise NotImplementedError("Conv supports 1-3 spatial dims")
        dn = ("N" + spatial + "C", spatial + "IO", "N" + spatial + "C")
        y = lax.conv_general_dilated(
            inputs, kernel, strides, _conv_padding(self.padding, len(ks)),
            dimension_numbers=dn)
        if bias is not None:
            y = y + jnp.reshape(bias, (1,) * (y.ndim - 1) + (-1,))
        if n_batch != 1:
            y = jnp.reshape(y, batch_shape + y.shape[1:])
        return y


class Dropout(Module):
    rate: float
    deterministic: Optional[bool] = None

    def __call__(self, inputs, deterministic: Optional[bool] = None,
                 rng: Optional[jax.Array] = None):
        det = self.deterministic if deterministic is None else deterministic
        if det is None:
            raise ValueError("Dropout needs `deterministic`")
        if self.rate == 0.0 or det:
            return inputs
        if self.rate == 1.0:
            return jnp.zeros_like(inputs)
        keep = 1.0 - self.rate
        if rng is None:
            rng = self.make_rng("dropout")
        mask = jax.random.bernoulli(rng, p=keep, shape=inputs.shape)
        return lax.select(mask, inputs / keep, jnp.zeros_like(inputs))


class Embed(Module):
    num_embeddings: int
    features: int
    dtype: Any = None
    param_dtype: Any = jnp.float32
    embedding_init: Callable = initializers.variance_scaling(
        1.0, "fan_in", "normal", out_axis=0)

    def setup(self):
        self.embedding = self.param("embedding", self.embedding_init,
                                    (self.num_embeddings, self.features),
                                    self.param_dtype)

    def __call__(self, inputs):
        if not jnp.issubdtype(inputs.dtype, jnp.integer):
            raise ValueError("Embed input must be integer")
        emb = self.embedding if self.dtype is None else jnp.asarray(
            self.embedding, self.dtype)
        return jnp.take(emb, inputs, axis=0)


def flatten_dict(tree, prefix=()):
    """Nested dict -> {path tuple: leaf}."""
    out = {}
    for k, v in tree.items():
        path = prefix + (k,)
        if isinstance(v, dict) and v:
            out.update(flatten_dict(v, path))
        else:
            out[path] = v
    return out


def unflatten_dict(flat):
    """Inverse of `flatten_dict`."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return out


__all__ = ["Module", "compact", "remat", "initializers", "Dense", "Conv",
           "Dropout", "Embed", "flatten_dict", "unflatten_dict"]
