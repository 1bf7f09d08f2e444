"""A small pure-JAX layer set with flax-style parameter trees.

The model zoo (nn/models.py) and the Keras `nn_define` interpreter
(nn/keras_define.py) need Dense, Conv, pooling, dropout, GroupNorm, Embed
and LSTM/GRU cells.  This module provides them on jax alone, behind the
interface the trainer and the aggregation path already use:

    variables = model.init(key, x)              # {"params": tree}
    y = model.apply({"params": p}, x, train=..., rngs={"dropout": k})

Parameters live in nested dicts named as flax names them: a layer without
an explicit name becomes "<Kind>_<n>", numbered per kind within its
parent ("Dense_0", "Conv_1", "_ResBlock_2"), and each leaf keeps flax's
name ("kernel", "bias", "scale", "embedding", LSTM gates "ii".."ho").
Initializers are flax's defaults, taken from jax.nn.initializers.
"""

from __future__ import annotations

import zlib
from typing import Any, Callable, Dict, Optional, Sequence

import jax
import jax.numpy as jnp
from jax.nn import initializers as init

__all__ = ["Module", "Scope", "dense", "conv", "max_pool", "avg_pool",
           "dropout", "group_norm", "embed", "lstm", "gru", "activation"]

_kernel_init = init.lecun_normal()
_embed_init = init.variance_scaling(1.0, "fan_in", "normal", out_axis=0)
_recurrent_init = init.orthogonal()


class Scope:
    """Where a layer finds (apply) or creates (init) its parameters."""

    def __init__(self, params: Dict[str, Any], key=None, rngs=None,
                 _counter=None):
        self.params = params
        self._key = key  # set while initializing
        self._rngs = rngs or {}
        self._counts: Dict[str, int] = {}
        self._rng_counter = _counter if _counter is not None else [0]

    @property
    def initializing(self) -> bool:
        return self._key is not None

    def child(self, kind: str, name: Optional[str] = None) -> "Scope":
        if name is None:
            n = self._counts.get(kind, 0)
            self._counts[kind] = n + 1
            name = f"{kind}_{n}"
        if self.initializing:
            sub = self.params.setdefault(name, {})
            key = jax.random.fold_in(self._key, zlib.crc32(name.encode()))
        else:
            sub, key = self.params[name], None
        return Scope(sub, key, self._rngs, self._rng_counter)

    def param(self, name: str, init_fn: Callable, shape: Sequence[int]):
        if self.initializing and name not in self.params:
            key = jax.random.fold_in(self._key, zlib.crc32(name.encode()))
            self.params[name] = init_fn(key, tuple(shape), jnp.float32)
        return self.params[name]

    def make_rng(self, kind: str):
        if kind not in self._rngs:
            raise ValueError(f"apply() needs rngs={{{kind!r}: key}}")
        self._rng_counter[0] += 1
        return jax.random.fold_in(self._rngs[kind], self._rng_counter[0])


class Module:
    """Base class: subclasses define __call__(self, scope, x, train=False)."""

    def init(self, key, *args, **kwargs) -> Dict[str, Any]:
        params: Dict[str, Any] = {}
        self(Scope(params, key=key), *args, **kwargs)
        return {"params": params}

    def apply(self, variables, *args, rngs=None, **kwargs):
        return self(Scope(variables["params"], rngs=rngs), *args, **kwargs)


def activation(name: Optional[str]) -> Callable:
    """Keras/flax activation name -> function."""
    fn = getattr(jax.nn, name, None) or getattr(jnp, name, None)
    if fn is None:
        raise ValueError(f"unsupported activation {name!r}")
    return fn


def dense(s: Scope, x, features: int, use_bias: bool = True,
          name: Optional[str] = None):
    s = s.child("Dense", name)
    y = x @ s.param("kernel", _kernel_init, (x.shape[-1], features))
    if use_bias:
        y = y + s.param("bias", init.zeros, (features,))
    return y


def conv(s: Scope, x, features: int, kernel_size: Sequence[int],
         strides: Sequence[int] = (1, 1), padding: str = "SAME",
         use_bias: bool = True, name: Optional[str] = None):
    """2-D convolution over NHWC input, HWIO kernel (flax nn.Conv)."""
    s = s.child("Conv", name)
    k = s.param("kernel", _kernel_init,
                (*kernel_size, x.shape[-1], features))
    y = jax.lax.conv_general_dilated(
        x, k, tuple(strides), padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    if use_bias:
        y = y + s.param("bias", init.zeros, (features,))
    return y


def _pool(x, init_val, op, window, strides, padding):
    dims = (1, *window, 1)
    return jax.lax.reduce_window(x, init_val, op, dims,
                                 (1, *(strides or window), 1), padding)


def max_pool(x, window, strides=None, padding: str = "VALID"):
    return _pool(x, -jnp.inf, jax.lax.max, window, strides, padding)


def avg_pool(x, window, strides=None, padding: str = "VALID"):
    total = _pool(x, 0.0, jax.lax.add, window, strides, padding)
    return total / (window[0] * window[1])


def dropout(s: Scope, x, rate: float, train: bool):
    if not train or rate == 0.0:
        return x
    keep = jax.random.bernoulli(s.make_rng("dropout"), 1.0 - rate, x.shape)
    return jnp.where(keep, x / (1.0 - rate), 0.0)


def group_norm(s: Scope, x, num_groups: int, epsilon: float = 1e-6,
               name: Optional[str] = None):
    """GroupNorm over all non-batch axes of each channel group."""
    s = s.child("GroupNorm", name)
    c = x.shape[-1]
    g = x.reshape(*x.shape[:-1], num_groups, c // num_groups)
    axes = tuple(range(1, g.ndim - 2)) + (g.ndim - 1,)
    mean = g.mean(axis=axes, keepdims=True)
    var = ((g - mean) ** 2).mean(axis=axes, keepdims=True)
    y = ((g - mean) * jax.lax.rsqrt(var + epsilon)).reshape(x.shape)
    return (y * s.param("scale", init.ones, (c,))
            + s.param("bias", init.zeros, (c,)))


def embed(s: Scope, x, num: int, features: int, name: Optional[str] = None):
    s = s.child("Embed", name)
    table = s.param("embedding", _embed_init, (num, features))
    return jnp.take(table, x, axis=0)


def _gate(s: Scope, name: str, in_dim: int, hidden: int, use_bias: bool,
          kernel_init):
    g = s.child("Dense", name)
    k = g.param("kernel", kernel_init, (in_dim, hidden))
    b = g.param("bias", init.zeros, (hidden,)) if use_bias else None
    return k, b


def _affine(x, kb):
    k, b = kb
    return x @ k if b is None else x @ k + b


def lstm(s: Scope, x, hidden: int, name: Optional[str] = None):
    """LSTM over (B, T, D) -> (B, T, hidden); flax OptimizedLSTMCell
    gates (input kernels "ii".."io" without bias, recurrent "hi".."ho"
    with bias), zero initial carry, run under lax.scan."""
    s = s.child("OptimizedLSTMCell", name)
    d = x.shape[-1]
    wi = {g: _gate(s, "i" + g, d, hidden, False, _kernel_init)
          for g in "ifgo"}
    wh = {g: _gate(s, "h" + g, hidden, hidden, True, _recurrent_init)
          for g in "ifgo"}

    def step(carry, xt):
        c, h = carry
        z = {g: _affine(xt, wi[g]) + _affine(h, wh[g]) for g in "ifgo"}
        c = (jax.nn.sigmoid(z["f"]) * c
             + jax.nn.sigmoid(z["i"]) * jnp.tanh(z["g"]))
        h = jax.nn.sigmoid(z["o"]) * jnp.tanh(c)
        return (c, h), h

    zeros = jnp.zeros((x.shape[0], hidden), x.dtype)
    _, ys = jax.lax.scan(step, (zeros, zeros), jnp.swapaxes(x, 0, 1))
    return jnp.swapaxes(ys, 0, 1)


def gru(s: Scope, x, hidden: int, name: Optional[str] = None):
    """GRU over (B, T, D) -> (B, T, hidden); flax GRUCell gates."""
    s = s.child("GRUCell", name)
    d = x.shape[-1]
    wi = {g: _gate(s, "i" + g, d, hidden, True, _kernel_init)
          for g in "rzn"}
    wh = {g: _gate(s, "h" + g, hidden, hidden, g == "n", _recurrent_init)
          for g in "rzn"}

    def step(h, xt):
        r = jax.nn.sigmoid(_affine(xt, wi["r"]) + _affine(h, wh["r"]))
        z = jax.nn.sigmoid(_affine(xt, wi["z"]) + _affine(h, wh["z"]))
        n = jnp.tanh(_affine(xt, wi["n"]) + r * _affine(h, wh["n"]))
        h = (1.0 - z) * n + z * h
        return h, h

    h0 = jnp.zeros((x.shape[0], hidden), x.dtype)
    _, ys = jax.lax.scan(step, h0, jnp.swapaxes(x, 0, 1))
    return jnp.swapaxes(ys, 0, 1)
