"""Port parity for ``mx.nd.contrib``'s control flow and index ops.

The cases of tests/test_control_flow.py, each run through both packages
on the same inputs, with every output and gradient compared within 1e-6
relative and 1e-6 absolute (float32; the two packages sum in other
orders): ``foreach`` with one and with several data arrays, fused and
unrolled under ``record()`` (closures then receive gradients), and its
gradient; ``while_loop``'s padding, its zero-iteration case and its
closure gradients; ``cond`` in both forms; ``boolean_mask``,
``index_copy`` and ``index_array``.  Then what only the port has: a
hybridized block that calls the fused ``_while_loop``, ``_foreach`` and
``_cond`` gives what the eager calls give, with no host read of a
condition (a CUDA graph captures the same forward on the card, see
``chip_smoke.py``'s ``ndarray_rest`` phase).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

RTOL = ATOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)


def _np(x):
    if isinstance(x, (list, tuple)):
        return [a for e in x for a in _np(e)]
    return [np.asarray(x.asnumpy())]


def _foreach_cumsum(mx):
    data = mx.nd.array(np.arange(12, dtype=np.float32).reshape(4, 3))

    def body(x, states):
        s = states[0] + x
        return s, [s]

    return contrib(mx).foreach(body, data, [mx.nd.zeros((3,))])


def _foreach_two_data(mx):
    a = mx.nd.array(np.arange(8, dtype=np.float32).reshape(4, 2))
    b = mx.nd.array(np.linspace(-1, 1, 8).astype(np.float32).reshape(4, 2))

    def body(xs, states):
        s = states[0] * 0.5 + xs[0] * xs[1]
        return [s, xs[0] - xs[1]], [s]

    return contrib(mx).foreach(body, [a, b], [mx.nd.ones((2,))])


def _foreach_grad(mx):
    data = mx.nd.array(np.linspace(0.5, 1.5, 10).astype(np.float32)
                       .reshape(5, 2))
    data.attach_grad()

    def body(x, states):
        s = states[0] * x * 2.0
        return s, [s]

    with mx.autograd.record():
        outs, final = contrib(mx).foreach(body, data, [mx.nd.ones((2,))])
        loss = final[0].sum() + outs.sum()
    loss.backward()
    return [outs, final, data.grad]


def _foreach_closure(mx):
    w = mx.nd.array([2.0])
    w.attach_grad()
    with mx.autograd.record():
        outs, fin = contrib(mx).foreach(
            lambda x, s: (x * w, [s[0] + x * w]),
            mx.nd.array([1.0, 2.0, 3.0]), [mx.nd.array([0.0])])
        loss = outs.sum() + fin[0].sum()
    loss.backward()
    return [outs, fin, w.grad]


def _foreach_bare_state(mx):
    data = mx.nd.array([[1.0, 2.0], [3.0, 4.0]])
    init = mx.nd.array([10.0, 20.0])
    with mx.autograd.record():
        _, fin = contrib(mx).foreach(lambda x, s: (x + s[0], x + s[0]),
                                     data, [init])
    _, fin2 = contrib(mx).foreach(lambda x, s: (x + s[0], x + s[0]), data,
                                  [init])
    return [fin, fin2]


def _while_padding(mx):
    def func(i_, acc_):
        return acc_ + i_, [i_ + 1.0, acc_ + i_]

    return contrib(mx).while_loop(lambda i_, acc_: i_ < 3.0, func,
                                  [mx.nd.array([0.0]), mx.nd.array([0.0])],
                                  max_iterations=6)


def _while_two_outputs(mx):
    def func(i_, x_):
        return [x_ * 2, i_ + x_], [i_ + 1, x_ * 0.5]

    return contrib(mx).while_loop(lambda i_, x_: i_.sum() < 2, func,
                                  [mx.nd.array([0.0]),
                                   mx.nd.array([4.0, 8.0])],
                                  max_iterations=4)


def _while_closure(mx):
    w = mx.nd.array([2.0])
    w.attach_grad()

    def func(i_, acc_):
        return acc_ + i_ * w, [i_ + 1, acc_ + i_ * w]

    cond = (lambda i_, acc_: i_.sum() < 3)
    vars0 = [mx.nd.array([0.0]), mx.nd.array([0.0])]
    fused = contrib(mx).while_loop(cond, func, vars0, max_iterations=5)
    with mx.autograd.record():
        outs, fin = contrib(mx).while_loop(cond, func, vars0,
                                           max_iterations=5)
        loss = fin[1].sum()
    loss.backward()
    return [fused, outs, fin, w.grad]


def _while_zero(mx):
    with mx.autograd.record():
        outs, fin = contrib(mx).while_loop(
            lambda i_: i_.sum() < 3, lambda i_: (i_ * 2, [i_ + 1]),
            [mx.nd.array([0.0])], max_iterations=0)
    fused, fin2 = contrib(mx).while_loop(
        lambda i_: i_.sum() < 3, lambda i_: (i_ * 2, [i_ + 1]),
        [mx.nd.array([0.0])], max_iterations=0)
    never, fin3 = contrib(mx).while_loop(
        lambda i_: i_.sum() > 3, lambda i_: (i_ * 2, [i_ + 1]),
        [mx.nd.array([0.0])], max_iterations=3)
    return [outs, fin, fused, fin2, never, fin3]


def _cond_inputs(mx):
    a, b = mx.nd.array([2.0, 4.0]), mx.nd.array([3.0, 1.0])
    c = contrib(mx)
    return [c.cond(lambda x, y: x.sum() < y.sum(), lambda x, y: x * 2.0,
                   lambda x, y: y * 10.0, [a, b]),
            c.cond(lambda x, y: x.sum() > y.sum(), lambda x, y: x * 2.0,
                   lambda x, y: y * 10.0, [a, b])]


def _cond_closure(mx):
    x = mx.nd.array([3.0])
    x.attach_grad()
    with mx.autograd.record():
        out = contrib(mx).cond(lambda: x.sum() > 2, lambda: x * 2,
                               lambda: x * 10)
        out.backward()
    out2 = contrib(mx).cond(lambda: x.sum() > 5, lambda: x * 2,
                            lambda: x * 10)
    return [out, x.grad, out2]


def _boolean_mask(mx):
    x = mx.nd.array(np.arange(10, dtype="float32").reshape(5, 2))
    x.attach_grad()
    w = mx.nd.array(np.arange(1, 7, dtype="float32").reshape(3, 2))
    with mx.autograd.record():
        m = contrib(mx).boolean_mask(x, mx.nd.array([1.0, 0, 1, 0, 1]))
        (m * w).sum().backward()
    return [m, x.grad]


def _index_copy(mx):
    old = mx.nd.array(np.arange(8, dtype="float32").reshape(4, 2))
    new = mx.nd.ones((2, 2)) * 7
    return [contrib(mx).index_copy(old, mx.nd.array([1.0, 3.0]), new),
            mx.nd.contrib.index_copy(old, mx.nd.array([2.0, 0.0]), new)]


def _index_array(mx):
    data = mx.nd.zeros((2, 3, 4))
    return [contrib(mx).index_array(data),
            contrib(mx).index_array(data, axes=(2, 0))]


def contrib(mx):
    return mx.nd.contrib


CASES = {f.__name__[1:]: f for f in (
    _foreach_cumsum, _foreach_two_data, _foreach_grad, _foreach_closure,
    _foreach_bare_state, _while_padding, _while_two_outputs, _while_closure,
    _while_zero, _cond_inputs, _cond_closure, _boolean_mask, _index_copy,
    _index_array)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    want = _np(CASES[name](jmx))
    got = _np(CASES[name](tmx))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g, w)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_non_scalar_condition_raises_under_record():
    with tmx.autograd.record():
        with pytest.raises(TypeError, match="scalar"):
            tmx.nd.contrib.while_loop(
                lambda v: v < 1, lambda v: (v, [v + 1]),
                [tmx.nd.array([0.0, 0.0])], max_iterations=3)


class _Loops(tmx.gluon.HybridBlock):
    """The three fused ops in one hybridized forward."""

    def hybrid_forward(self, F, x):
        outs, (i, acc) = F.contrib.while_loop(
            lambda i_, a_: i_.sum() < 3, lambda i_, a_: (a_ * x, [i_ + 1,
                                                                 a_ + x]),
            [F.zeros((1,)), F.zeros_like(x)], max_iterations=5)
        scan, _ = F.contrib.foreach(lambda r, s: (r * 2 + s[0], [s[0] + r]),
                                    outs, [F.zeros_like(x)])
        pick = F.contrib.cond(lambda a: a.sum() > 0, lambda a: a * 3,
                              lambda a: a - 1, [acc])
        return scan.sum(axis=0) + pick + i


def test_hybridized_block_matches_eager():
    x = tmx.nd.array(np.array([0.5, -2.0, 1.5], np.float32))
    eager = _Loops()(x).asnumpy()
    net = _Loops()
    net.hybridize()
    for _ in range(2):  # the first call and a cached one
        np.testing.assert_allclose(net(x).asnumpy(), eager, rtol=RTOL,
                                   atol=ATOL)
    assert net._cached_op._misses == 1 and net._cached_op._hits == 1


def test_fused_ops_record_through_their_inputs():
    """The fused op under record() (as a hybridized block's forward runs
    it on the CPU): the body records, so the inputs' gradients flow."""
    x = tmx.nd.array(np.array([1.0, 2.0], np.float32))
    x.attach_grad()
    with tmx.autograd.record():
        outs = tmx.nd.invoke("_while_loop", [[x]], {
            "cond": lambda v: v.sum() < 20, "max_iterations": 4,
            "func": lambda v: ([v * v], [v * 2])})
        (outs[0].sum() + outs[1].sum()).backward()
    # steps: v = x, 2x, 4x (sum 6, 12, 24): outputs x², 4x², 16x²... the
    # third step runs (sum 12 < 20 before it), the fourth does not
    v = np.array([1.0, 2.0])
    want = 2 * v + 8 * v + 32 * v + 8.0
    np.testing.assert_allclose(x.grad.asnumpy(), want, rtol=RTOL)
