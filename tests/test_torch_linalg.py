"""Port parity for the linear-algebra ops (``ops/linalg.py``), ``mx.nd.linalg``
and ``mx.sym.linalg``.

Every registry name of the 18 ops (39 with the aliases) runs through both
packages on the same seeded float32 inputs, forward and gradient (of a
seeded weighted sum of the outputs).  Element by element, the outputs
hold within FWD_REL and the gradients within GRAD_REL of the JAX side's
largest |value| (float32: LAPACK and XLA order their sums differently,
and a decomposition's gradient goes through a solve).  ``gelqf`` and
``syevd`` fix a sign per vector that LAPACK, cuSOLVER and XLA may choose
differently (and ``svd``, whose signs also differed between LAPACK and
XLA on the CPU), so they are held by their invariants (L·Q = A with
Q·Qᵀ = I and L lower triangular; Uᵀ·diag(w)·U = A with U·Uᵀ = I;
U·diag(s)·Vᵀ = A with orthonormal U and V), their eigen- and singular
values directly, and their gradients through heads that a sign flip
leaves alone (L², Q², w, U², s, V² elementwise), against the JAX
package's.
Only float32 is ported and tested: the JAX package runs without 64-bit
types.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

FWD_REL = 1e-5
GRAD_REL = 1e-4
INV_ABS = 1e-5


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)


rng = np.random.RandomState(0)


def _r(*shape):
    return rng.randn(*shape).astype(np.float32)


def _spd(b, n):
    m = rng.randn(b, n, n).astype(np.float32)
    return (m @ m.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32))


def _lower(b, n):
    return np.tril(rng.randn(b, n, n).astype(np.float32)) + \
        3 * np.eye(n, dtype=np.float32)


# op -> [(inputs, params)]; every registry name of the op runs each case
CASES = {
    "_linalg_gemm": [
        ([_r(2, 3, 4), _r(2, 4, 5), _r(2, 3, 5)], dict(alpha=0.5, beta=2.0)),
        ([_r(4, 3), _r(5, 4), _r(3, 5)],
         dict(transpose_a=True, transpose_b=True))],
    "_linalg_gemm2": [
        ([_r(2, 3, 4), _r(2, 4, 5)], {}),
        ([_r(3, 4), _r(5, 4)], dict(transpose_b=True, alpha=1.5))],
    "_linalg_potrf": [([_spd(2, 4)], {})],
    "_linalg_potri": [([_lower(2, 4)], {})],
    "_linalg_trsm": [
        ([_lower(2, 3), _r(2, 3, 4)], dict(alpha=2.0)),
        ([_lower(1, 3)[0], _r(4, 3)], dict(rightside=True, transpose=True)),
        ([_lower(1, 3)[0].T.copy(), _r(3, 2)], dict(lower=False))],
    "_linalg_trmm": [
        ([_r(2, 3, 3), _r(2, 3, 4)], dict(alpha=0.5)),
        ([_r(3, 3), _r(4, 3)], dict(rightside=True, lower=False,
                                    transpose=True))],
    "_linalg_syrk": [([_r(2, 3, 4)], {}),
                     ([_r(3, 4)], dict(transpose=True, alpha=2.0))],
    "_linalg_sumlogdiag": [([_spd(2, 4)], {})],
    "_linalg_extractdiag": [([_r(2, 4, 4)], {}), ([_r(4, 4)], dict(offset=1)),
                            ([_r(4, 4)], dict(offset=-2))],
    "_linalg_makediag": [([_r(2, 3)], {}), ([_r(3)], dict(offset=-1))],
    "_linalg_extracttrian": [([_r(2, 4, 4)], {}),
                             ([_r(4, 4)], dict(offset=1, lower=False)),
                             ([_r(4, 4)], dict(offset=-1))],
    "_linalg_maketrian": [([_r(2, 6)], {}),
                          ([_r(6)], dict(offset=1, lower=False)),
                          ([_r(3)], dict(offset=-1))],
    "_linalg_inverse": [([_spd(2, 4)], {})],
    "_linalg_det": [([_spd(2, 3) / 3], {})],
    "_linalg_slogdet": [([_r(2, 4, 4)], {})],
}
INVARIANT = {"_linalg_gelqf": ([_r(2, 3, 5)], {}),
             "_linalg_syevd": ([_spd(2, 4)], {}),
             "svd": ([_r(2, 4, 3)], {})}


def _names(op):
    from mxnet_tpu_torch.ops.registry import get
    o = get(op)
    return [o.name] + o.aliases


def _run(mx, name, inputs, params, head=None):
    """Outputs and input gradients (numpy) of mx.nd.<name>; ``head``
    maps the outputs to the summed terms (default: seeded weights)."""
    xs = [mx.nd.array(a) for a in inputs]
    for x in xs:
        x.attach_grad()
    with mx.autograd.record():
        outs = getattr(mx.nd, name)(*xs, **params)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        terms = head(mx, outs) if head else [
            o * mx.nd.array(np.random.RandomState(i).rand(*o.shape)
                            .astype(np.float32))
            for i, o in enumerate(outs) if o.dtype == np.float32]
        loss = terms[0].sum()
        for t in terms[1:]:
            loss = loss + t.sum()
    loss.backward()
    return ([o.asnumpy() for o in outs], [x.grad.asnumpy() for x in xs])


def _close(got, want, rel):
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, (
        np.abs(got - want).max() / scale)


PARAMS = [(op, name, i) for op, cases in CASES.items()
          for name in _names(op) for i in range(len(cases))]


@pytest.mark.parametrize("op,name,case", PARAMS)
def test_op_matches_jax(op, name, case):
    inputs, params = CASES[op][case]
    got_o, got_g = _run(tmx, name, inputs, params)
    want_o, want_g = _run(jmx, name, inputs, params)
    assert len(got_o) == len(want_o)
    for g, w in zip(got_o, want_o):
        _close(g, w, FWD_REL)
    for g, w in zip(got_g, want_g):
        _close(g, w, GRAD_REL)


def _sq(mx, outs):
    return [(o * o) * mx.nd.array(np.random.RandomState(i).rand(*o.shape)
                                  .astype(np.float32))
            for i, o in enumerate(outs)]


@pytest.mark.parametrize("name", _names("_linalg_gelqf"))
def test_gelqf_by_invariants(name):
    (a,), params = INVARIANT["_linalg_gelqf"]
    (lo, q), _ = _run(tmx, name, [a], params, head=_sq)
    np.testing.assert_allclose(lo @ q, a, atol=INV_ABS * np.abs(a).max())
    eye = np.broadcast_to(np.eye(q.shape[-2], dtype=np.float32),
                          lo.shape)
    np.testing.assert_allclose(q @ q.transpose(0, 2, 1), eye, atol=INV_ABS)
    assert np.all(np.triu(lo, 1) == 0)
    _, got_g = _run(tmx, name, [a], params, head=_sq)
    _, want_g = _run(jmx, name, [a], params, head=_sq)
    _close(got_g[0], want_g[0], GRAD_REL)


def _eig_head(mx, outs):
    u, w = outs
    return [w * mx.nd.array(np.linspace(1, 2, w.shape[-1]).astype(
        np.float32)), (u * u) * mx.nd.array(np.random.RandomState(1).rand(
            *u.shape).astype(np.float32))]


@pytest.mark.parametrize("name", _names("_linalg_syevd"))
def test_syevd_by_invariants(name):
    (a,), params = INVARIANT["_linalg_syevd"]
    (u, w), got_g = _run(tmx, name, [a], params, head=_eig_head)
    (_, w_ref), want_g = _run(jmx, name, [a], params, head=_eig_head)
    _close(w, w_ref, FWD_REL)
    rebuilt = u.transpose(0, 2, 1) @ (w[..., None] * u)
    np.testing.assert_allclose(rebuilt, a, atol=INV_ABS * np.abs(a).max())
    np.testing.assert_allclose(u @ u.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(4, dtype=np.float32),
                                               u.shape), atol=INV_ABS)
    _close(got_g[0], want_g[0], GRAD_REL)


def _svd_head(mx, outs):
    u, s, vt = outs
    return [s * mx.nd.array(np.linspace(1, 2, s.shape[-1]).astype(
        np.float32))] + _sq(mx, [u, vt])


@pytest.mark.parametrize("name", _names("svd"))
def test_svd_by_invariants(name):
    (a,), params = INVARIANT["svd"]
    (u, sv, vt), got_g = _run(tmx, name, [a], params, head=_svd_head)
    (_, s_ref, _), want_g = _run(jmx, name, [a], params, head=_svd_head)
    _close(sv, s_ref, FWD_REL)
    np.testing.assert_allclose(u @ (sv[..., None] * vt), a,
                               atol=INV_ABS * np.abs(a).max())
    k = sv.shape[-1]
    eye = np.broadcast_to(np.eye(k, dtype=np.float32), sv.shape + (k,))
    np.testing.assert_allclose(u.transpose(0, 2, 1) @ u, eye, atol=INV_ABS)
    np.testing.assert_allclose(vt @ vt.transpose(0, 2, 1), eye, atol=INV_ABS)
    _close(got_g[0], want_g[0], GRAD_REL)


def test_registry_names():
    """The 39 registry names of the ops, all shared with the JAX package."""
    from mxnet_tpu.ops.registry import REGISTRY as JREG
    from mxnet_tpu_torch.ops.registry import REGISTRY as TREG
    names = [n for op in list(CASES) + list(INVARIANT) for n in _names(op)]
    assert len(names) == len(set(names)) == 39
    assert all(n in JREG and n in TREG for n in names)


@pytest.mark.parametrize("short", ["gemm2", "potrf", "syrk", "trsm", "det"])
def test_namespaces(short):
    """mx.nd.linalg.<x> is the op; mx.sym.linalg.<x> composes it and the
    bound symbol gives the same values."""
    inputs, params = CASES["_linalg_" + short][0]
    xs = [tmx.nd.array(a) for a in inputs]
    want = getattr(tmx.nd, "_linalg_" + short)(*xs, **params).asnumpy()
    got = getattr(tmx.nd.linalg, short)(*xs, **params).asnumpy()
    np.testing.assert_array_equal(got, want)
    names = [f"x{i}" for i in range(len(xs))]
    sym = getattr(tmx.sym.linalg, short)(*[tmx.sym.var(n) for n in names],
                                         **params)
    ex = sym.bind(tmx.cpu(), dict(zip(names, xs)))
    np.testing.assert_allclose(ex.forward()[0].asnumpy(), want, rtol=1e-6)
