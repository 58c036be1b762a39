"""Port parity: mxnet_tpu_torch.autograd against mxnet_tpu.autograd.

The cases of tests/test_autograd.py:9-138 and :214, each run through both
packages on the same seeded numpy inputs, with the gradients compared:
float32, computed in the same order up to XLA's and torch's own kernels,
within 1e-6 relative and 1e-6 absolute.  Then what the port's tape on
torch autograd must bridge: MXNet's ``grad_req="write"`` overwrites where
torch accumulates, an op outside ``record()`` builds no graph, a custom
``Function`` is one node, and a freed graph raises.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

RTOL = ATOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)


def _both(fn, *arrays, **kw):
    """fn(pkg, *NDArrays) in each package on the same inputs; the grads of
    the inputs, as numpy, JAX package first."""
    out = []
    for pkg in (jmx, tmx):
        xs = [pkg.nd.array(a) for a in arrays]
        for x in xs:
            x.attach_grad(**kw)
        fn(pkg, *xs)
        out.append([x.grad.asnumpy() for x in xs])
    return out


def _close(want, got):
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


rng = np.random.RandomState(0)


def _simple(pkg, x):
    with pkg.autograd.record():
        y = (x * x).sum()
    y.backward()


def _twice(pkg, x):
    with pkg.autograd.record():
        y = (x * x * 2).sum()
    y.backward()


def _branches(pkg, x):
    with pkg.autograd.record():
        y = (pkg.nd.relu(x - 2.0) + pkg.nd.sigmoid(x)).sum()
    y.backward()


def _matmul(pkg, a, b):
    with pkg.autograd.record():
        y = pkg.nd.dot(a, b).sum()
    y.backward()


def _head_grads(pkg, x):
    with pkg.autograd.record():
        y = x * 4.0
    y.backward(pkg.nd.array(np.array([1.0, 0.5, 2.0], np.float32)))


def _multi_output(pkg, x):
    with pkg.autograd.record():
        a, b = pkg.nd.split(x, num_outputs=2, axis=1)
        y = (a * 2 + b * 3).sum()
    y.backward()


def _chain(pkg, x, w):
    with pkg.autograd.record():
        h = pkg.nd.tanh(pkg.nd.dot(x, w, transpose_b=True))
        y = (pkg.nd.exp(-h) * h).mean(axis=1).sum() + (w ** 2).sum() * 0.5
    y.backward()


def _custom(pkg, x):
    class Sigmoid(pkg.autograd.Function):
        def forward(self, x):
            y = pkg.nd.sigmoid(x)
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self._saved
            return dy * y * (1 - y)

    with pkg.autograd.record():
        y = Sigmoid()(x * 2.0)
    y.backward(pkg.nd.ones((3,)))


def _custom_two_in_two_out(pkg, a, b):
    class MulAdd(pkg.autograd.Function):
        def forward(self, a, b):
            self.save_for_backward(a, b)
            return a * b, a + b

        def backward(self, dp, ds):
            a, b = self._saved
            return dp * b + ds, dp * a + ds

    with pkg.autograd.record():
        p, s = MulAdd()(a, b)
        y = (p * 3.0 + s * s).sum()
    y.backward()


CASES = {
    "simple_grad": (_simple, [rng.randn(3)]),
    "same_input_twice": (_twice, [rng.randn(2)]),
    "chain_and_branches": (_branches, [rng.randn(2, 2) * 3]),
    "matmul_grad": (_matmul, [rng.randn(3, 4), rng.randn(4, 5)]),
    "head_grads": (_head_grads, [rng.randn(3)]),
    "multi_output_op": (_multi_output, [rng.rand(2, 6)]),
    "dot_transpose_chain": (_chain, [rng.randn(5, 4), rng.randn(3, 4)]),
    "custom_function": (_custom, [rng.randn(3)]),
    "custom_function_two_outputs": (_custom_two_in_two_out,
                                    [rng.randn(4), rng.randn(4)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_grads_match_jax_package(case):
    fn, arrays = CASES[case]
    want, got = _both(fn, *[a.astype(np.float32) for a in arrays])
    _close(want, got)


@pytest.mark.parametrize("req", ["write", "add"])
def test_grad_req_across_passes(req):
    def three_passes(pkg, x):
        for k in range(3):
            with pkg.autograd.record():
                y = (x * (3.0 + k)).sum()
            y.backward()
    want, got = _both(three_passes, np.array([1.0, 2.0], np.float32),
                      grad_req=req)
    _close(want, got)
    np.testing.assert_allclose(got[0], [12.0, 12.0] if req == "add"
                               else [5.0, 5.0])


def test_autograd_grad_api_leaves_grad_buffers():
    for pkg in (jmx, tmx):
        x = pkg.nd.array(np.array([2.0, 3.0], np.float32))
        x.attach_grad()
        with pkg.autograd.record():
            y = (x ** 2).sum()
        (gx,) = pkg.autograd.grad(y, [x])
        np.testing.assert_allclose(gx.asnumpy(), [4.0, 6.0])
        np.testing.assert_allclose(x.grad.asnumpy(), 0.0)


def test_pause_and_modes():
    for pkg in (jmx, tmx):
        ag = pkg.autograd
        assert not ag.is_recording()
        with ag.record():
            assert ag.is_recording() and ag.is_training()
            with ag.pause():
                assert not ag.is_recording()
            with ag.predict_mode():
                assert not ag.is_training()
        with ag.train_mode():
            assert ag.is_training() and not ag.is_recording()
        assert not ag.is_recording()


def test_no_record_builds_no_graph_and_backward_raises():
    x = tmx.nd.array([1.0]); x.attach_grad()
    y = x * 2
    assert y._data.grad_fn is None and not y._data.requires_grad
    with tmx.autograd.record():
        with tmx.autograd.pause():
            z = x * 2
    assert z._data.grad_fn is None
    for pkg in (jmx, tmx):
        x = pkg.nd.array([1.0]); x.attach_grad()
        y = x * 2
        with pytest.raises(pkg.MXNetError):
            y.backward()


def test_backward_twice_requires_retain_graph():
    for pkg in (jmx, tmx):
        x = pkg.nd.array(np.ones((3,), dtype="float32"))
        x.attach_grad()
        with pkg.autograd.record():
            y = (x * x) + x
        y.backward(retain_graph=True)
        g1 = x.grad.asnumpy().copy()
        y.backward()
        np.testing.assert_allclose(x.grad.asnumpy(), g1)
        with pkg.autograd.record():
            z = (x * x) + x
        z.backward()
        with pytest.raises(pkg.MXNetError):
            z.backward()


def test_custom_function_is_one_node_run_off_the_tape():
    seen = {}

    class Square(tmx.autograd.Function):
        def forward(self, x):
            seen["forward_recording"] = tmx.autograd.is_recording()
            self.save_for_backward(x)
            return x * x

        def backward(self, dy):
            seen["backward_recording"] = tmx.autograd.is_recording()
            (x,) = self.saved_tensors
            return 2 * x * dy

    x = tmx.nd.array([1.0, -2.0]); x.attach_grad()
    with tmx.autograd.record():
        y = Square()(x)
    fn = y._data.grad_fn
    assert type(fn).__name__.startswith("_FunctionNode")
    assert [type(f).__name__ for f, _ in fn.next_functions] == ["AccumulateGrad"]
    y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [2.0, -4.0])
    assert seen == {"forward_recording": False, "backward_recording": False}


def test_variable_updates_outside_record_stay_variables():
    """``w -= lr * w.grad`` swaps w's buffer; w stays a leaf whose next
    backward writes its gradient."""
    for pkg in (jmx, tmx):
        w = pkg.nd.array(np.array([1.0, -1.0], np.float32))
        w.attach_grad()
        for _ in range(3):
            with pkg.autograd.record():
                loss = (w * w).sum()
            loss.backward()
            w -= 0.25 * w.grad
        np.testing.assert_allclose(w.asnumpy(), [0.125, -0.125])
        np.testing.assert_allclose(w.grad.asnumpy(), [0.5, -0.5])


def test_inplace_write_into_a_saved_input_keeps_backward_right():
    for pkg in (jmx, tmx):
        x = pkg.nd.array(np.array([1.0, 2.0], np.float32))
        x.attach_grad()
        with pkg.autograd.record():
            y = x * 1.0
            z = (y * y).sum()
        y[:] = 100.0
        y += 1
        z.backward()
        np.testing.assert_allclose(x.grad.asnumpy(), [2.0, 4.0])


def test_registered_op_gradient_is_used():
    from mxnet_tpu_torch.ops import registry

    name = "_test_double_with_unit_grad"
    if name not in registry.REGISTRY:
        registry.register(name, nin=1,
                          grad=lambda p, ins, outs, cts: [cts[0] * 0 + 1.0])(
            lambda x: 2 * x)
    x = tmx.nd.array([1.0, 2.0]); x.attach_grad()
    with tmx.autograd.record():
        y = tmx.nd.invoke(name, [x]).sum()
    y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [1.0, 1.0])


def test_identity_function_leaves_its_input_alone():
    """A gradient-reversal Function returns its input: the output is an
    array of its own and the input stays the variable."""
    class Reverse(tmx.autograd.Function):
        def forward(self, x):
            return x

        def backward(self, dy):
            return -dy

    x = tmx.nd.array([1.0, 2.0]); x.attach_grad()
    with tmx.autograd.record():
        y = Reverse()(x)
        loss = (y * 3.0).sum()
    assert y is not x and x._data.grad_fn is None
    loss.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [-3.0, -3.0])
