"""``mx.nd.random``: the sampler namespace (counterpart of
``mxnet_tpu/ndarray/random.py``, reference ``python/mxnet/ndarray/
random.py``).  Each sampler draws from the device's ``mx.random`` stream,
or from ``generator`` (a ``torch.Generator`` on the target device) when
one is given."""
from __future__ import annotations

from .ndarray import invoke

__all__ = ["uniform", "normal", "randn", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial", "randint",
           "multinomial", "shuffle"]


def _draw(op, ctx, out, generator, **params):
    return invoke(op, [], dict(params, ctx=ctx, generator=generator),
                  out=out)


def uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None,
            out=None, generator=None, **kw):
    return _draw("_random_uniform", ctx, out, generator, low=low, high=high,
                 shape=shape, dtype=dtype)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
           out=None, generator=None, **kw):
    return _draw("_random_normal", ctx, out, generator, loc=loc, scale=scale,
                 shape=shape, dtype=dtype)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None,
          generator=None, **kw):
    return normal(loc, scale, shape, dtype, ctx, generator=generator)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32", ctx=None,
          out=None, generator=None, **kw):
    return _draw("_random_gamma", ctx, out, generator, alpha=alpha,
                 beta=beta, shape=shape, dtype=dtype)


def exponential(scale=1.0, shape=None, dtype="float32", ctx=None, out=None,
                generator=None, **kw):
    return _draw("_random_exponential", ctx, out, generator,
                 lam=1.0 / scale, shape=shape, dtype=dtype)


def poisson(lam=1.0, shape=None, dtype="float32", ctx=None, out=None,
            generator=None, **kw):
    return _draw("_random_poisson", ctx, out, generator, lam=lam,
                 shape=shape, dtype=dtype)


def negative_binomial(k=1, p=1.0, shape=None, dtype="float32", ctx=None,
                      out=None, generator=None, **kw):
    return _draw("_random_negative_binomial", ctx, out, generator, k=k, p=p,
                 shape=shape, dtype=dtype)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None,
                                  dtype="float32", ctx=None, out=None,
                                  generator=None, **kw):
    return _draw("_random_generalized_negative_binomial", ctx, out,
                 generator, mu=mu, alpha=alpha, shape=shape, dtype=dtype)


def randint(low=0, high=1, shape=None, dtype="int32", ctx=None, out=None,
            generator=None, **kw):
    return _draw("_random_randint", ctx, out, generator, low=low, high=high,
                 shape=shape, dtype=dtype)


def multinomial(data, shape=None, get_prob=False, dtype="int32",
                generator=None, **kw):
    return invoke("_sample_multinomial", [data],
                  dict(shape=shape, get_prob=get_prob, dtype=dtype,
                       generator=generator))


def shuffle(data, generator=None, **kw):
    return invoke("_shuffle", [data], {"generator": generator})
