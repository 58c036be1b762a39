"""Random sampling ops (reference ``src/operator/random/``).

Counterpart of ``mxnet_tpu/ops/random_ops.py``.  Every sampler takes
``generator``: :func:`~mxnet_tpu_torch.ndarray.ndarray.invoke` passes the
device's ``mx.random`` stream unless the caller gives a
``torch.Generator`` of its own.  A CUDA graph registers the device's
stream, so each replay draws fresh numbers, as the JAX package's threefry
key (an input of its compiled programs) does.  The same seed gives other
numbers than the JAX package's: tests compare shapes, dtypes and moments.

The creators (``nin=0``) take the target ``device`` from ``invoke``; the
``sample_*`` ops draw one block of ``shape`` per element of their
parameter arrays.  Gamma, Poisson and the negative binomials (a
gamma-Poisson mixture) use ``torch._standard_gamma`` and
``torch.poisson``; categorical draws use ``torch.multinomial``.
"""
from __future__ import annotations

import math

import torch

from ..base import attr_truthy, dtype_torch
from .registry import register


def _shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def _dtype(dtype, default=torch.float32):
    return dtype_torch(dtype) or default


def _gamma(alpha, generator):
    """Gamma(alpha, 1) draws, one per element of the tensor ``alpha``."""
    return torch._standard_gamma(alpha, generator=generator)


def _poisson(lam, generator):
    return torch.poisson(lam, generator=generator)


@register("_random_uniform", nin=0, differentiable=False,
          aliases=["random_uniform", "uniform"])
def _uniform(low=0.0, high=1.0, shape=None, dtype="float32", device=None,
             generator=None):
    return torch.empty(_shape(shape), dtype=_dtype(dtype),
                       device=device).uniform_(float(low), float(high),
                                               generator=generator)


@register("_random_normal", nin=0, differentiable=False,
          aliases=["random_normal", "normal"])
def _normal(loc=0.0, scale=1.0, shape=None, dtype="float32", device=None,
            generator=None):
    return torch.empty(_shape(shape), dtype=_dtype(dtype),
                       device=device).normal_(float(loc), float(scale),
                                              generator=generator)


@register("_random_gamma", nin=0, differentiable=False,
          aliases=["random_gamma"])
def _gamma_op(alpha=1.0, beta=1.0, shape=None, dtype="float32", device=None,
              generator=None):
    a = torch.full(_shape(shape), float(alpha), device=device)
    return (_gamma(a, generator) * float(beta)).to(_dtype(dtype))


@register("_random_exponential", nin=0, differentiable=False,
          aliases=["random_exponential"])
def _exponential(lam=1.0, shape=None, dtype="float32", device=None,
                 generator=None):
    return torch.empty(_shape(shape), dtype=_dtype(dtype),
                       device=device).exponential_(float(lam),
                                                   generator=generator)


@register("_random_poisson", nin=0, differentiable=False,
          aliases=["random_poisson"])
def _poisson_op(lam=1.0, shape=None, dtype="float32", device=None,
                generator=None):
    lam = torch.full(_shape(shape), float(lam), device=device)
    return _poisson(lam, generator).to(_dtype(dtype))


@register("_random_negative_binomial", nin=0, differentiable=False,
          aliases=["random_negative_binomial"])
def _neg_binomial(k=1, p=1.0, shape=None, dtype="float32", device=None,
                  generator=None):
    """Failures before the ``k``-th success of probability ``p``: Poisson
    of a Gamma(k)·(1 − p)/p rate."""
    p = float(p)
    rate = _gamma(torch.full(_shape(shape), float(k), device=device),
                  generator) * (1.0 - p) / p
    return _poisson(rate, generator).to(_dtype(dtype))


@register("_random_generalized_negative_binomial", nin=0,
          differentiable=False,
          aliases=["random_generalized_negative_binomial"])
def _gen_neg_binomial(mu=1.0, alpha=1.0, shape=None, dtype="float32",
                      device=None, generator=None):
    """Mean ``mu``, dispersion ``alpha``: Poisson of a
    Gamma(1/alpha)·mu·alpha rate."""
    mu, alpha = float(mu), float(alpha)
    r = torch.full(_shape(shape), 1.0 / max(alpha, 1e-12), device=device)
    rate = _gamma(r, generator) * mu * alpha
    return _poisson(rate, generator).to(_dtype(dtype))


@register("_random_randint", nin=0, differentiable=False,
          aliases=["random_randint", "randint"])
def _randint(low=0, high=1, shape=None, dtype="int32", device=None,
             generator=None):
    return torch.randint(int(low), int(high), _shape(shape),
                         generator=generator, device=device,
                         dtype=_dtype(dtype, torch.int32))


@register("_sample_multinomial", nin=1, differentiable=False,
          aliases=["sample_multinomial", "multinomial"])
def _multinomial(data, shape=None, get_prob=False, dtype="int32",
                 generator=None):
    """Category indices drawn with probabilities ``data`` (the last axis;
    one row or a batch of rows): ``shape`` draws per row, or one without
    it.  ``get_prob`` also returns each draw's log-probability."""
    s = _shape(shape)
    n = max(math.prod(s), 1)
    rows = data.reshape(-1, data.shape[-1]).float()
    draws = torch.multinomial(rows, n, replacement=True, generator=generator)
    lead = tuple(data.shape[:-1])
    out = draws.reshape(lead + s) if s else draws[:, 0].reshape(lead)
    out = out.to(_dtype(dtype, torch.int32))
    if not attr_truthy(get_prob):
        return out
    logp = torch.log(torch.clamp(rows, min=1e-38))
    picked = torch.gather(logp, 1, draws if s else draws[:, :1])
    return out, picked.reshape(out.shape).to(data.dtype)


@register("_shuffle", nin=1, differentiable=False, aliases=["shuffle"])
def _shuffle_op(data, generator=None):
    """``data`` with its first axis in a random order."""
    perm = torch.randperm(data.shape[0], generator=generator,
                          device=data.device)
    return data[perm]


@register("_sample_unique_zipfian", nin=0, differentiable=False)
def _sample_unique_zipfian(range_max=1, shape=None, device=None,
                           generator=None):
    """Log-uniform (Zipfian) class ids in ``[0, range_max)``, int32 (the
    JAX package's int64 request under its 32-bit index width)."""
    u = torch.empty(_shape(shape), device=device).uniform_(
        generator=generator)
    out = (torch.exp(u * math.log(int(range_max) + 1.0)) - 1.0).to(
        torch.int32)
    return torch.clamp(out, 0, int(range_max) - 1)


# -- element-wise-parameter samplers (reference sample_op.cc): one block of
#    ``shape`` per element of the parameter arrays
def _per_element(param, shape):
    return param.reshape(tuple(param.shape) + (1,) * len(shape))


def _expand(param, shape):
    return _per_element(param, shape).expand(tuple(param.shape) + shape)


@register("sample_uniform", nin=2, differentiable=False)
def _sample_uniform(low, high, shape=None, dtype="float32", generator=None):
    s = _shape(shape)
    u = torch.empty(tuple(low.shape) + s, dtype=_dtype(dtype),
                    device=low.device).uniform_(generator=generator)
    return _per_element(low, s) + u * _per_element(high - low, s)


@register("sample_normal", nin=2, differentiable=False)
def _sample_normal(mu, sigma, shape=None, dtype="float32", generator=None):
    s = _shape(shape)
    z = torch.empty(tuple(mu.shape) + s, dtype=_dtype(dtype),
                    device=mu.device).normal_(generator=generator)
    return _per_element(mu, s) + z * _per_element(sigma, s)


@register("sample_gamma", nin=2, differentiable=False)
def _sample_gamma(alpha, beta, shape=None, dtype="float32", generator=None):
    s = _shape(shape)
    g = _gamma(_expand(alpha.float(), s).contiguous(), generator)
    return (g * _per_element(beta, s)).to(_dtype(dtype))


@register("sample_exponential", nin=1, differentiable=False,
          aliases=["_sample_exponential"])
def _sample_exponential(lam, shape=None, dtype="float32", generator=None):
    s = _shape(shape)
    e = torch.empty(tuple(lam.shape) + s, dtype=_dtype(dtype),
                    device=lam.device).exponential_(generator=generator)
    return e / _per_element(lam, s)


@register("sample_poisson", nin=1, differentiable=False,
          aliases=["_sample_poisson"])
def _sample_poisson(lam, shape=None, dtype="float32", generator=None):
    s = _shape(shape)
    rate = _expand(lam.float(), s).contiguous()
    return _poisson(rate, generator).to(_dtype(dtype))


@register("sample_negative_binomial", nin=2, differentiable=False,
          aliases=["_sample_negative_binomial"])
def _sample_neg_binomial(k, p, shape=None, dtype="float32", generator=None):
    s = _shape(shape)
    pp = _expand(p.float(), s)
    rate = _gamma(_expand(k.float(), s).contiguous(), generator) * (
        1.0 - pp) / torch.clamp(pp, min=1e-12)
    return _poisson(rate, generator).to(_dtype(dtype))


@register("sample_generalized_negative_binomial", nin=2,
          differentiable=False,
          aliases=["_sample_generalized_negative_binomial"])
def _sample_gen_neg_binomial(mu, alpha, shape=None, dtype="float32",
                             generator=None):
    s = _shape(shape)
    a = _expand(alpha.float(), s)
    r = 1.0 / torch.clamp(a, min=1e-12)
    rate = _gamma(r.contiguous(), generator) * _expand(mu.float(), s) * a
    return _poisson(rate, generator).to(_dtype(dtype))
