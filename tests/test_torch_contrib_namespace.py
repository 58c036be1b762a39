"""The ``mx.nd.contrib`` and ``mx.sym.contrib`` namespaces of the port
against the JAX package's.

- every ``_contrib_<x>`` name the two registries share is ``<x>`` in both
  namespaces of both packages: the generated function itself where the
  namespace defines no function of that name, and a name registered after
  import resolves too;
- ``mx.nd.contrib.DeformableConvolution`` is
  ``mx.nd._contrib_DeformableConvolution``;
- the names the reference defines in Python (``isinf`` ...
  ``multi_mp_adamw_update``, ``multi_mp_lamb_update``) give what
  ``mx.nd.<op>`` gives and what the JAX package's give (exactly:
  the same float32 arithmetic);
- ``quadratic``, ``getnnz`` and ``rand_zipfian``'s expected counts
  against the JAX package's; ``rand_zipfian``'s draws by their range;
- the DGL names raise, naming ROADMAP A15 (they take CSR graphs).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops.registry import REGISTRY as JREG
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry as treg


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)


SHARED = sorted(n for n in JREG if n.startswith("_contrib_")
                and n in treg.REGISTRY)
DEFINED = {"quadratic", "index_copy", "index_array", "getnnz",
           "boolean_mask"}


def test_shared_names():
    assert len(SHARED) == 17


@pytest.mark.parametrize("full", SHARED)
def test_contrib_name_resolves_in_both_namespaces(full):
    short = full[len("_contrib_"):]
    for mx in (jmx, tmx):
        assert callable(getattr(mx.nd.contrib, short))
        assert callable(getattr(mx.sym.contrib, short))
    if short not in DEFINED:
        assert getattr(tmx.nd.contrib, short) is getattr(tmx.nd, full)
        assert getattr(tmx.sym.contrib, short) is getattr(tmx.sym, full)


def test_deformable_convolution_is_the_generated_function():
    assert tmx.nd.contrib.DeformableConvolution is \
        tmx.nd._contrib_DeformableConvolution
    assert tmx.sym.contrib.DeformableConvolution is \
        tmx.sym._contrib_DeformableConvolution


def test_late_registration_resolves():
    name = "_contrib_late_twice"

    @treg.register(name)
    def _late(x):
        return x * 2

    try:
        x = tmx.nd.array([1.0, 2.0])
        np.testing.assert_array_equal(
            tmx.nd.contrib.late_twice(x).asnumpy(), [2.0, 4.0])
        s = tmx.sym.contrib.late_twice(tmx.sym.var("x"))
        out = s.bind(tmx.cpu(), {"x": x}).forward()[0]
        np.testing.assert_array_equal(out.asnumpy(), [2.0, 4.0])
        with pytest.raises(AttributeError):
            tmx.nd.contrib.never_registered
    finally:
        del treg.REGISTRY[name]
        for mod in (tmx.nd.contrib, tmx.sym.contrib):
            mod.__dict__.pop("late_twice", None)


def _update_inputs(mx, groups, mp):
    rng = np.random.RandomState(7)
    arrs = []
    for _ in range(groups):
        w = rng.randn(3, 4).astype(np.float32)
        grp = [w, rng.randn(3, 4).astype(np.float32),
               rng.rand(3, 4).astype(np.float32) * 0.1,
               rng.rand(3, 4).astype(np.float32) * 0.1]
        if mp:
            grp.append(w.copy())
        arrs += grp
    return [mx.nd.array(a) for a in arrs]


UPDATES = {
    "isinf": lambda mx: ([mx.nd.array([1.0, np.inf, -np.inf, np.nan])], {}),
    "isfinite": lambda mx: ([mx.nd.array([1.0, np.inf, np.nan])], {}),
    "isnan": lambda mx: ([mx.nd.array([1.0, np.inf, np.nan])], {}),
    "mp_adamw_update": lambda mx: (
        _update_inputs(mx, 1, True) + [mx.nd.array([0.5])],
        dict(lr=0.01, wd=0.1, eta=1.0)),
    "multi_adamw_update": lambda mx: (
        _update_inputs(mx, 2, False) + [mx.nd.array([1.0])],
        dict(lrs=(0.01, 0.02), wds=(0.0, 0.1), etas=(1.0, 1.0),
             num_weights=2)),
    "multi_mp_adamw_update": lambda mx: (
        _update_inputs(mx, 2, True) + [mx.nd.array([1.0])],
        dict(lrs=(0.01, 0.02), wds=(0.0, 0.1), etas=(1.0, 1.0),
             num_weights=2)),
    "multi_lamb_update": lambda mx: (
        _update_inputs(mx, 2, False),
        dict(learning_rates=(0.01, 0.02), wds=(0.0, 0.1),
             step_count=(1, 3), num_tensors=2)),
}


def _flat(out):
    out = out if isinstance(out, (list, tuple)) else [out]
    return [o.asnumpy() for o in out]


@pytest.mark.parametrize("name", sorted(UPDATES))
def test_plain_op_aliases(name):
    args, kw = UPDATES[name](tmx)
    got = _flat(getattr(tmx.nd.contrib, name)(*args, **kw))
    same = _flat(getattr(tmx.nd, name)(*args, **kw))
    jargs, jkw = UPDATES[name](jmx)
    want = _flat(getattr(jmx.nd.contrib, name)(*jargs, **jkw))
    assert len(got) == len(same) == len(want)
    for g, s, w in zip(got, same, want):
        np.testing.assert_array_equal(g, s)
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


def test_multi_mp_lamb_update_matches_jax():
    kw = dict(learning_rates=(0.01, 0.02), wds=(0.0, 0.1),
              step_count=[1, 4], beta1=0.8, bias_correction=True)
    got = _flat(tmx.nd.contrib.multi_mp_lamb_update(
        *_update_inputs(tmx, 2, True), **kw))
    want = _flat(jmx.nd.contrib.multi_mp_lamb_update(
        *_update_inputs(jmx, 2, True), **kw))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_quadratic_and_getnnz_match_jax(axis):
    x = np.array([[0.0, 1.5, -2.0], [3.0, 0.0, 0.5]], np.float32)
    for fn in (lambda mx, a: mx.nd.contrib.quadratic(a, a=2.0, b=-1.0),
               lambda mx, a: mx.nd.contrib.quadratic(a),
               lambda mx, a: mx.nd._contrib_quadratic(a, a=0.5, c=3.0),
               lambda mx, a: mx.nd.contrib.getnnz(a, axis=axis)):
        got = fn(tmx, tmx.nd.array(x)).asnumpy()
        want = fn(jmx, jmx.nd.array(x)).asnumpy()
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_rand_zipfian():
    true = np.array([0, 3, 9, 99], np.float32)
    tmx.random.seed(1)
    s, e_true, e_s = tmx.nd.contrib.rand_zipfian(tmx.nd.array(true), 4096,
                                                 100)
    _, j_true, _ = jmx.nd.contrib.rand_zipfian(jmx.nd.array(true), 4096, 100)
    np.testing.assert_allclose(e_true.asnumpy(), j_true.asnumpy(), rtol=1e-5)
    draws = s.asnumpy()
    assert draws.dtype == np.int32 and draws.shape == (4096,)
    assert draws.min() >= 0 and draws.max() < 100
    # P(0) = log 2 / log 101 ≈ 0.150: the low classes dominate
    assert 0.12 < (draws == 0).mean() < 0.18
    # float64 here; the op's float32 log(k+2) - log(k+1) cancels, by up to
    # 5e-5 relative at k near 100
    want = (np.log(draws + 2.0) - np.log(draws + 1.0)) / np.log(101) * 4096
    np.testing.assert_allclose(e_s.asnumpy(), want, rtol=1e-4)


@pytest.mark.parametrize("name", [
    "dgl_adjacency", "dgl_csr_neighbor_non_uniform_sample",
    "dgl_csr_neighbor_uniform_sample", "dgl_graph_compact", "dgl_subgraph",
    "edge_id"])
def test_dgl_names_wait_for_sparse(name):
    assert hasattr(jmx.nd.contrib, name)
    with pytest.raises(MXNetError, match="A15"):
        getattr(tmx.nd.contrib, name)(tmx.nd.zeros((2, 2)))


def test_symbolic_contrib_composes():
    x = np.array([1.0, -2.0, 3.0], np.float32)
    s = tmx.sym.contrib.quadratic(tmx.sym.var("x"), a=1.0, b=2.0, c=3.0,
                                  name="q")
    out = s.bind(tmx.cpu(), {"x": tmx.nd.array(x)}).forward()[0]
    np.testing.assert_allclose(out.asnumpy(), x * x + 2 * x + 3, rtol=1e-6)
    js = jmx.sym.contrib.quadratic(jmx.sym.var("x"), a=1.0, b=2.0, c=3.0,
                                   name="q")
    assert s.tojson() == js.tojson()
