"""Port parity: the samplers of ``mxnet_tpu/ops/random_ops.py`` and the
``mx.nd.random`` / ``mx.sym.random`` namespaces, on the CPU.  The two
packages draw from different generators, so the draws are never compared:
each sampler's output shape and dtype are held to the JAX package's, and
its mean and variance over ``N`` draws to the distribution's (and the JAX
package's sample moments to the same numbers, which checks the
parameterisation both packages read).

Tolerance: a mean within 6 standard errors, a variance within 15% (20%
for the heavy-tailed negative binomials).  Categorical draws: each
category's frequency within 6 standard errors, and ``get_prob``'s
log-probabilities within 1e-6 (relative) of the log of the drawn
category's probability.
"""
import math

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import registry as treg

N = 20000


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tmx.set_default_context(tmx.cpu())
    tmx.random.seed(11)
    yield
    tmx.set_default_context(prev)


def _moments_ok(x, mean, var, var_rel=0.15, what=""):
    x = np.asarray(x, np.float64).reshape(-1)
    se = math.sqrt(var / x.size)
    assert abs(x.mean() - mean) <= 6 * se, (what, x.mean(), mean)
    assert abs(x.var() - var) <= var_rel * var, (what, x.var(), var)


# (namespace function, kwargs, mean, variance, dtype)
CREATORS = [
    ("uniform", dict(low=-1.0, high=3.0), 1.0, 16 / 12, "float32"),
    ("normal", dict(loc=2.0, scale=0.5), 2.0, 0.25, "float32"),
    ("gamma", dict(alpha=2.0, beta=1.5), 3.0, 4.5, "float32"),
    ("exponential", dict(scale=2.0), 2.0, 4.0, "float32"),
    ("poisson", dict(lam=3.0), 3.0, 3.0, "float32"),
    ("negative_binomial", dict(k=3, p=0.4), 4.5, 11.25, "float32"),
    ("generalized_negative_binomial", dict(mu=2.0, alpha=0.5), 2.0, 4.0,
     "float32"),
    ("randint", dict(low=-2, high=5), 1.0, 4.0, "int32"),
    ("normal", dict(loc=0.0, scale=1.0, dtype="float16"), 0.0, 1.0,
     "float16"),
]


@pytest.mark.parametrize("case", CREATORS, ids=lambda c: c[0])
def test_creator_moments_match(case):
    name, kw, mean, var, dtype = case
    got = getattr(tmx.nd.random, name)(shape=(N // 100, 100), **kw)
    ref = getattr(jmx.nd.random, name)(shape=(N // 100, 100), **kw)
    assert got.shape == ref.shape == (N // 100, 100)
    assert str(got.dtype) == str(ref.dtype) == dtype
    rel = 0.2 if "binomial" in name else 0.15
    _moments_ok(got.asnumpy(), mean, var, rel, f"port {name}")
    _moments_ok(ref.asnumpy(), mean, var, rel, f"jax {name}")


# (op, parameter arrays, kwargs, per-element means, per-element variances)
_P = np.array([1.0, 4.0], np.float32)
SAMPLERS = [
    ("sample_uniform", [np.array([0.0, -2.0], np.float32), _P], {},
     [0.5, 1.0], [1 / 12, 3.0]),
    ("sample_normal", [np.array([1.0, -3.0], np.float32), _P], {},
     [1.0, -3.0], [1.0, 16.0]),
    ("sample_gamma", [np.array([2.0, 0.5], np.float32), _P], {},
     [2.0, 2.0], [2.0, 8.0]),
    ("sample_exponential", [_P], {}, [1.0, 0.25], [1.0, 1 / 16]),
    ("_sample_exponential", [_P], {}, [1.0, 0.25], [1.0, 1 / 16]),
    ("sample_poisson", [_P], {}, [1.0, 4.0], [1.0, 4.0]),
    ("_sample_poisson", [_P], dict(dtype="int32"), [1.0, 4.0], [1.0, 4.0]),
    ("sample_negative_binomial", [np.array([2.0, 5.0], np.float32),
                                  np.array([0.5, 0.8], np.float32)], {},
     [2.0, 1.25], [4.0, 1.5625]),
    ("_sample_negative_binomial", [np.array([2.0], np.float32),
                                   np.array([0.5], np.float32)], {},
     [2.0], [4.0]),
    ("sample_generalized_negative_binomial",
     [np.array([2.0, 1.0], np.float32), np.array([0.5, 0.25], np.float32)],
     {}, [2.0, 1.0], [4.0, 1.25]),
    ("_sample_generalized_negative_binomial",
     [np.array([2.0], np.float32), np.array([0.5], np.float32)], {},
     [2.0], [4.0]),
]


@pytest.mark.parametrize("case", SAMPLERS, ids=lambda c: c[0])
def test_sampler_moments_match(case):
    name, params, kw, means, variances = case
    got = getattr(tmx.nd, name)(*[tmx.nd.array(p) for p in params],
                                shape=(N,), **kw)
    ref = getattr(jmx.nd, name)(*[jmx.nd.array(p) for p in params],
                                shape=(N,), **kw)
    assert got.shape == ref.shape == (params[0].shape[0], N)
    assert str(got.dtype) == str(ref.dtype)
    rel = 0.2 if "binomial" in name else 0.15
    for i, (m, v) in enumerate(zip(means, variances)):
        _moments_ok(got.asnumpy()[i], m, v, rel, f"port {name}[{i}]")
        _moments_ok(ref.asnumpy()[i], m, v, rel, f"jax {name}[{i}]")


@pytest.mark.parametrize("name", ["multinomial", "sample_multinomial",
                                  "_sample_multinomial"])
def test_multinomial(name):
    """Rows of probabilities: draw frequencies, and ``get_prob`` on one
    row (the JAX package's ``get_prob`` gathers a batch of rows only one
    draw per row; the port's gathers each row's draws)."""
    probs = np.array([[0.1, 0.2, 0.7], [0.5, 0.5, 0.0]], np.float32)
    for mx in (tmx, jmx):
        fn = getattr(mx.nd, name)
        draws = fn(mx.nd.array(probs), shape=(N // 4,))
        assert draws.shape == (2, N // 4) and str(draws.dtype) == "int32"
        for row, p in zip(draws.asnumpy(), probs):
            freq = np.bincount(row, minlength=3) / row.size
            se = np.sqrt(p * (1 - p) / row.size)
            assert (np.abs(freq - p) <= 6 * se + 1e-12).all(), (mx, freq)
        d, logp = fn(mx.nd.array(probs[0]), shape=(8, 4), get_prob=True)
        assert d.shape == logp.shape == (8, 4)
        assert str(logp.dtype) == "float32"
        np.testing.assert_allclose(logp.asnumpy(),
                                   np.log(probs[0][d.asnumpy()]), rtol=1e-6)
        one = fn(mx.nd.array(probs[0]))
        assert one.shape == () and 0 <= int(one.asnumpy()) < 3
    d, logp = tmx.nd.random.multinomial(tmx.nd.array(probs), shape=(2, 3),
                                        get_prob=True)
    assert d.shape == logp.shape == (2, 2, 3)
    np.testing.assert_allclose(
        logp.asnumpy(), np.log(np.take_along_axis(
            probs, d.asnumpy().reshape(2, -1), 1)).reshape(2, 2, 3),
        rtol=1e-6)


def test_shuffle_and_zipfian():
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    for mx in (tmx, jmx):
        for fn in (mx.nd.random.shuffle, mx.nd.shuffle, mx.nd._shuffle):
            s = fn(mx.nd.array(x)).asnumpy()
            assert s.shape == x.shape
            # rows stay whole; every row appears once
            assert sorted(map(tuple, s.tolist())) == sorted(map(tuple,
                                                               x.tolist()))
    got = tmx.nd._sample_unique_zipfian(range_max=100, shape=(N,))
    ref = jmx.nd._sample_unique_zipfian(range_max=100, shape=(N,))
    assert got.shape == ref.shape and str(got.dtype) == str(ref.dtype)
    k = np.arange(100)
    p = np.log((k + 2) / (k + 1)) / np.log(101)
    p[-1] += 1 - p.sum()
    mean, var = (k * p).sum(), ((k - (k * p).sum()) ** 2 * p).sum()
    for a in (got.asnumpy(), ref.asnumpy()):
        assert a.min() >= 0 and a.max() < 100
        _moments_ok(a, mean, var, 0.15, "zipfian")


def test_streams_and_generators():
    """``mx.random.seed`` restarts the device's stream; a caller's
    generator gives its own reproducible draws and leaves the stream
    alone."""
    tmx.random.seed(5)
    a = tmx.nd.random.normal(shape=(8,)).asnumpy()
    tmx.random.seed(5)
    b = tmx.nd.random.normal(shape=(8,)).asnumpy()
    assert np.array_equal(a, b)
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    c = tmx.nd.random.uniform(shape=(8,), generator=g1).asnumpy()
    d = tmx.nd.uniform(shape=(8,), generator=g2).asnumpy()
    assert np.array_equal(c, d)
    tmx.random.seed(5)
    tmx.nd.random.normal(shape=(8,), generator=g1)
    assert np.array_equal(tmx.nd.random.normal(shape=(8,)).asnumpy(), a)
    x = tmx.nd.ones((4, 3))
    e = tmx.nd.random.shuffle(x, generator=torch.Generator().manual_seed(1))
    assert e.shape == (4, 3)


def test_every_sampler_name_resolves():
    """The 36 registry names, through ``mx.nd``, and ``mx.sym`` where the
    JAX package exposes them; the symbolic creators compose nodes whose
    evaluation draws the declared shape."""
    names = [n for n, op in treg.REGISTRY.items()
             if op.fn.__module__.endswith("random_ops")]
    assert len(names) == 36
    for n in names:
        assert callable(getattr(tmx.nd, n))
        if hasattr(jmx.sym, n):
            assert callable(getattr(tmx.sym, n))
    for fname in ("uniform", "normal", "gamma", "exponential", "poisson",
                  "negative_binomial", "generalized_negative_binomial",
                  "randint"):
        jsym = getattr(jmx.sym.random, fname)(shape=(3, 4))
        tsym = getattr(tmx.sym.random, fname)(shape=(3, 4))
        assert tsym.infer_shape()[1] == jsym.infer_shape()[1] == [(3, 4)]
        assert tsym.eval_with({}).shape == (3, 4)
    m = tmx.sym.random.multinomial(tmx.sym.var("p"), shape=(5,))
    assert m.eval_with({"p": tmx.nd.array([[0.5, 0.5]])}).shape == (1, 5)
    r = tmx.sym.random.randn(2, 3)
    assert r.infer_shape()[1] == [(2, 3)]
    s = tmx.sym.random.shuffle(tmx.sym.var("x"))
    assert s.infer_shape(x=(4, 2))[1] == [(4, 2)]
