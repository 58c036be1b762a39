"""Helpers of the op parity tests (``tests/test_torch_ops_*.py``): run one
registry op through both packages' ``mx.nd`` on the same numpy inputs and
hold the port's outputs, dtypes and gradients to the JAX package's."""
import numpy as np

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag

REL = 1e-6


def outs(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def op_fn(mx, name):
    """``mx.nd.<name>``; the JAX package registers a few names after its
    ``mx.nd`` is generated (``_split_v2``, ``_contrib_boolean_mask``,
    ``_np_copy``, ``_mod``), which this reaches through ``invoke``."""
    fn = getattr(mx.nd, name, None)
    if fn is not None:
        return fn
    variadic = mx.ops.registry.get(name).nin is None
    return lambda *a, **k: mx.nd.ndarray.invoke(
        name, [list(a)] if variadic else list(a), k)


def _run(mx, ag, name, arrays, params, grad):
    """``mx.nd.<name>`` on ``arrays`` (numpy; call it on the CPU), the outputs as numpy and,
    for the float inputs when ``grad``, the gradients of a seeded
    weighted sum of the float outputs."""
    nds = [mx.nd.array(a, dtype=a.dtype) for a in arrays]
    wrt = [x for x, a in zip(nds, arrays) if grad and a.dtype == np.float32]
    for x in wrt:
        x.attach_grad()
    fn = op_fn(mx, name)
    if not wrt:
        return [o.asnumpy() for o in outs(fn(*nds, **params))], []
    rng = np.random.RandomState(7)
    with ag.record():
        results = outs(fn(*nds, **params))
        head = None
        for o in results:
            if str(o.dtype) != "float32":
                continue
            w = mx.nd.array(np.asarray(rng.rand(*o.shape), np.float32))
            term = (o * w).sum()
            head = term if head is None else head + term
    if head is None:
        return [o.asnumpy() for o in results], []
    head.backward()
    return [o.asnumpy() for o in results], [x.grad.asnumpy() for x in wrt]


def same(got, ref, what, rel=REL):
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert got.dtype == ref.dtype, (what, got.dtype, ref.dtype)
    if got.dtype.kind == "f":
        both_nan = np.isnan(got) & np.isnan(ref)
        g, r = np.where(both_nan, 0, got), np.where(both_nan, 0, ref)
        bound = rel * max(float(np.abs(r).max(initial=0.0)), 1.0)
        assert np.array_equal(np.isinf(g), np.isinf(r)), what
        fin = np.isfinite(r)
        assert float(np.abs(g[fin] - r[fin]).max(initial=0.0)) <= bound, what
    else:
        assert np.array_equal(got, ref), (what, got, ref)


def check(name, arrays, params=None, grad=False, rel=REL):
    """``name`` on ``arrays`` in both packages: outputs (and, with
    ``grad``, the float inputs' gradients) within ``rel`` of the largest
    |value|, dtypes and integer outputs exactly."""
    params = params or {}
    ref, ref_g = _run(jmx, jag, name, arrays, params, grad)
    got, got_g = _run(tmx, tag, name, arrays, params, grad)
    assert len(got) == len(ref), name
    for i, (g, r) in enumerate(zip(got, ref)):
        same(g, r, f"{name} output {i}", rel)
    for i, (g, r) in enumerate(zip(got_g, ref_g)):
        same(g, r, f"{name} gradient {i}", rel)
