"""Elementwise unary/binary/scalar ops.

Counterpart of ``mxnet_tpu/ops/elemwise.py``: the reference's
``src/operator/tensor/elemwise_{unary,binary,binary_broadcast,binary_scalar}_op*``
families, with the same names, aliases and dtype rules, over torch tensors.
Scalars go in as 0-d tensors, which torch promotes as JAX promotes weak
Python scalars: a float16/bfloat16 operand keeps its dtype, an integer
operand with a float scalar becomes float32.
"""
from __future__ import annotations

import torch

from ..base import dtype_torch
from .registry import alias, register


def _round(x):
    # reference round is ::roundf, half away from zero; integers pass through
    if not x.is_floating_point():
        return x
    return (torch.sign(x) * torch.floor(torch.abs(x) + 0.5)).to(x.dtype)


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


_UNARY = {
    "abs": torch.abs, "sign": torch.sign, "round": _round,
    "rint": torch.round, "ceil": torch.ceil, "floor": torch.floor,
    "trunc": torch.trunc, "fix": torch.trunc,
    "exp": torch.exp, "log": torch.log, "log10": torch.log10,
    "log2": torch.log2, "log1p": torch.log1p, "expm1": torch.expm1,
    "sqrt": torch.sqrt, "square": torch.square, "cbrt": _cbrt,
    "negative": torch.negative, "reciprocal": lambda x: 1.0 / x,
    "rsqrt": torch.rsqrt, "rcbrt": lambda x: 1.0 / _cbrt(x),
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "erf": torch.erf, "erfinv": torch.erfinv, "sigmoid": torch.sigmoid,
    "softsign": lambda x: x / (1 + torch.abs(x)), "relu": torch.relu,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "logical_not": lambda x: torch.logical_not(x).to(x.dtype),
    "isnan": torch.isnan, "isinf": torch.isinf, "isfinite": torch.isfinite,
}

_NONDIFF_UNARY = {"isnan", "isinf", "isfinite", "logical_not"}

for _name, _fn in _UNARY.items():
    register(_name, nin=1, differentiable=_name not in _NONDIFF_UNARY)(
        (lambda f: lambda data: f(data))(_fn))

alias("negative", "_np_negative")
alias("abs", "_abs")


# -- the gamma family, with JAX's values at the poles: digamma is NaN at
#    0 (torch gives -inf) and its derivative +inf at every non-positive
#    integer (torch's trigamma is finite at the negative ones), so the
#    gradients of gammaln and gamma are NaN there, as in the JAX package.
def _digamma(x):
    return torch.where(x == 0, torch.nan, torch.digamma(x))


def _trigamma(x):
    pole = (x <= 0) & (x == torch.floor(x))
    return torch.where(pole, torch.inf, torch.polygamma(1, x))


@register("digamma", nin=1,
          grad=lambda p, i, o, g: [g[0] * _trigamma(i[0])])
def _digamma_op(data):
    return _digamma(data)


@register("gammaln", nin=1,
          grad=lambda p, i, o, g: [g[0] * _digamma(i[0])])
def _gammaln_op(data):
    return torch.lgamma(data)


@register("gamma", nin=1,
          grad=lambda p, i, o, g: [g[0] * o[0] * _digamma(i[0])])
def _gamma_op(data):
    return torch.exp(torch.lgamma(data))


@register("hard_sigmoid", nin=1)
def _hard_sigmoid(data, alpha=0.2, beta=0.5):
    return torch.clamp(alpha * data + beta, 0.0, 1.0)


@register("copy", nin=1, aliases=["_copy", "identity"])
def _copy(data):
    return data.clone()


@register("BlockGrad", nin=1, aliases=["stop_gradient"])
def _block_grad(data):
    return data.detach()


@register("make_loss", nin=1)
def _make_loss(data):
    return data


@register("zeros_like", nin=1)
def _zeros_like(data):
    return torch.zeros_like(data)


@register("ones_like", nin=1)
def _ones_like(data):
    return torch.ones_like(data)


@register("cast", nin=1, aliases=["Cast"])
def _cast(data, dtype="float32"):
    return data.to(dtype_torch(dtype))


@register("clip", nin=1)
def _clip(data, a_min=None, a_max=None):
    # select-based so the gradient at an input exactly on a bound is 1
    # (reference clip backward: a_min <= x <= a_max ? 1 : 0)
    out = data
    if a_max is not None:
        out = torch.where(out > a_max, a_max, out)
    if a_min is not None:
        out = torch.where(out < a_min, a_min, out)
    return out.to(data.dtype)


def _flip_negative_steps(data, key):
    """``data[key]`` for a basic key whose slices may step backwards, which
    torch slicing refuses: each such dimension is flipped and its slice
    rewritten with a positive step."""
    key = key if isinstance(key, tuple) else (key,)
    if not any(isinstance(k, slice) and k.step is not None and k.step < 0
               for k in key):
        return data, key
    consumed = sum(k.ndim if isinstance(k, torch.Tensor) and
                   k.dtype == torch.bool else 0 if k is None or k is Ellipsis
                   else 1 for k in key)
    dim, out = 0, []
    for k in key:
        if k is Ellipsis:
            dim += data.ndim - consumed
        elif k is None:
            pass
        elif isinstance(k, slice) and k.step is not None and k.step < 0:
            n = data.shape[dim]
            idx = range(*k.indices(n))
            data = data.flip(dim)
            k = (slice(n - 1 - idx[0], n - idx[-1], -k.step) if len(idx)
                 else slice(0, 0))
            dim += 1
        else:
            dim += (k.ndim if isinstance(k, torch.Tensor)
                    and k.dtype == torch.bool else 1)
        out.append(k)
    return data, tuple(out)


@register("_getitem", nin=1)
def _getitem(data, key=None):
    k = key.key if hasattr(key, "key") else key
    data, k = _flip_negative_steps(data, k)
    return data[k]


# ---------------------------------------------------------------------------
# binary broadcast ops (reference elemwise_binary_broadcast_op_*.cc)
# ---------------------------------------------------------------------------
class _FloorDivide(torch.autograd.Function):
    """Floor division, whose gradient is zero wherever it has one (as the
    JAX package's is); torch defines none."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.like = [(t.shape, t.dtype) if t.requires_grad else None
                    for t in (a, b)]
        return torch.floor_divide(a, b)

    @staticmethod
    def backward(ctx, grad):
        return tuple(None if like is None else grad.new_zeros(like[0],
                                                              dtype=like[1])
                     for like in ctx.like)


def _floor_divide(a, b):
    return _FloorDivide.apply(a, b)


def _cmp(fn):
    # reference comparison ops return the lhs dtype (0/1 values), not bool
    def wrapped(lhs, rhs):
        return fn(lhs, rhs).to(lhs.dtype)
    return wrapped


_BINARY = {
    "broadcast_add": torch.add, "broadcast_sub": torch.sub,
    "broadcast_mul": torch.mul, "broadcast_div": torch.true_divide,
    "broadcast_mod": torch.remainder, "broadcast_power": torch.pow,
    "broadcast_hypot": torch.hypot,
    "broadcast_floordiv": _floor_divide,
    "broadcast_equal": _cmp(torch.eq), "broadcast_not_equal": _cmp(torch.ne),
    "broadcast_greater": _cmp(torch.gt),
    "broadcast_greater_equal": _cmp(torch.ge),
    "broadcast_lesser": _cmp(torch.lt),
    "broadcast_lesser_equal": _cmp(torch.le),
    "broadcast_logical_and": _cmp(torch.logical_and),
    "broadcast_logical_or": _cmp(torch.logical_or),
    "broadcast_logical_xor": _cmp(torch.logical_xor),
    "arctan2": torch.atan2,
    "ldexp": lambda x, e: torch.ldexp(x, e.to(x.dtype)),
}

for _name, _fn in _BINARY.items():
    register(_name, nin=2)((lambda f: lambda lhs, rhs: f(lhs, rhs))(_fn))


# -- maximum/minimum with JAX's gradient: an operand equal to the result
#    takes the gradient, half of it on a tie, so a NaN result sends it to
#    neither side (torch sends it to the NaN operand).
def _chosen(a, b, z, g):
    w = torch.where(a == z, torch.where(b == z, 0.5, 1.0), 0.0)
    return (g * w.to(g.dtype)).sum_to_size(a.shape)


def _maxmin_grad(params, inputs, outputs, out_grads):
    x, y = inputs
    z, g = outputs[0], out_grads[0]
    return [_chosen(x, y, z, g), _chosen(y, x, z, g)]


def _maxmin_scalar_grad(params, inputs, outputs, out_grads):
    x, z = inputs[0], outputs[0]
    return [_chosen(x, _s(params.get("scalar", 0.0)), z, out_grads[0])]


@register("broadcast_maximum", nin=2, grad=_maxmin_grad)
def _maximum(lhs, rhs):
    return torch.maximum(lhs, rhs)


@register("broadcast_minimum", nin=2, grad=_maxmin_grad)
def _minimum(lhs, rhs):
    return torch.minimum(lhs, rhs)

alias("broadcast_add", "elemwise_add")
alias("broadcast_add", "_plus")
alias("broadcast_sub", "elemwise_sub")
alias("broadcast_sub", "_minus")
alias("broadcast_mul", "elemwise_mul")
alias("broadcast_div", "elemwise_div")
alias("broadcast_maximum", "_maximum")
alias("broadcast_minimum", "_minimum")
alias("broadcast_power", "_power")


@register("_scatter_elemwise_div", nin=2)
def _scatter_div(lhs, rhs):
    return lhs / rhs


@register("add_n", nin=None, aliases=["ElementWiseSum", "_sum_of"])
def _add_n(args):
    """Reference ``ElementwiseSum`` (ndarray.cc:1298)."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@register("smooth_l1", nin=1)
def _smooth_l1(data, scalar=1.0):
    s2 = scalar * scalar
    absd = torch.abs(data)
    return torch.where(absd < 1.0 / s2, 0.5 * s2 * data * data,
                       absd - 0.5 / s2)


# ---------------------------------------------------------------------------
# scalar ops (reference elemwise_binary_scalar_op_*.cc — `_plus_scalar` etc.)
# ---------------------------------------------------------------------------
def _s(s):
    return torch.as_tensor(s)


_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    "_mod_scalar": lambda x, s: torch.remainder(x, _s(s)),
    "_rmod_scalar": lambda x, s: torch.remainder(_s(s), x),
    "_power_scalar": lambda x, s: torch.pow(x, _s(s)),
    "_rpower_scalar": lambda x, s: torch.pow(_s(s), x),
    "_floordiv_scalar": lambda x, s: _floor_divide(x, _s(s)),
    "_hypot_scalar": lambda x, s: torch.hypot(x, torch.tensor(s, dtype=x.dtype)),
    "_equal_scalar": lambda x, s: (x == s).to(x.dtype),
    "_not_equal_scalar": lambda x, s: (x != s).to(x.dtype),
    "_greater_scalar": lambda x, s: (x > s).to(x.dtype),
    "_greater_equal_scalar": lambda x, s: (x >= s).to(x.dtype),
    "_lesser_scalar": lambda x, s: (x < s).to(x.dtype),
    "_lesser_equal_scalar": lambda x, s: (x <= s).to(x.dtype),
    "_logical_and_scalar": lambda x, s: torch.logical_and(x, _s(s)).to(x.dtype),
    "_logical_or_scalar": lambda x, s: torch.logical_or(x, _s(s)).to(x.dtype),
    "_logical_xor_scalar": lambda x, s: torch.logical_xor(x, _s(s)).to(x.dtype),
}

for _name, _fn in _SCALAR.items():
    register(_name, nin=1)(
        (lambda f: lambda data, scalar=0.0: f(data, scalar))(_fn))


@register("_maximum_scalar", nin=1, grad=_maxmin_scalar_grad)
def _maximum_scalar(data, scalar=0.0):
    return torch.maximum(data, _s(scalar))


@register("_minimum_scalar", nin=1, grad=_maxmin_scalar_grad)
def _minimum_scalar(data, scalar=0.0):
    return torch.minimum(data, _s(scalar))
