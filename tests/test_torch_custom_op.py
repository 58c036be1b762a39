"""Port parity for ``mx.operator`` and ``mx.nd.Custom``.

The cases of tests/test_custom_op.py, each run through both packages on
the same inputs (float32, the same arithmetic: compared exactly or within
1e-6): forward and backward, a Custom op chained with built-in ops, an
unregistered op raising, the ``add`` and ``null`` reqs, the output dtype
from ``infer_type`` and the ``is_train`` probe.  Then a user softmax head
(forward softmax, backward p - onehot(label), ``need_top_grad=False``, as
MXNet's example/numpy-ops/custom_softmax.py writes it) on a small conv
net against ``SoftmaxCrossEntropyLoss`` summed: the same gradients for
every parameter within 1e-5 of the largest |value|, in each package.
What only the port must show: the op's arrays are allocated on the
inputs' device, not the current context's, and aux states pass through.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

HEAD_REL = 1e-5


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)


def _register(mx):
    if "sqr_t" in mx.operator._PROPS:
        return

    @mx.operator.register("sqr_t")
    class SqrProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            class Sqr(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0] * in_data[0])

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0],
                                2.0 * in_data[0] * out_grad[0])
            return Sqr()

    @mx.operator.register("probe_t")
    class ProbeProp(mx.operator.CustomOpProp):
        seen = {}

        def list_arguments(self):
            return ["x"]

        def list_outputs(self):
            return ["y"]

        def infer_shape(self, s):
            return s, [s[0]], []

        def create_operator(self, ctx, sh, dt):
            seen = ProbeProp.seen

            class O(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    seen["is_train"] = is_train
                    seen["ctx"] = out_data[0].context
                    self.assign(out_data[0], req[0], in_data[0])

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    seen["grad_ctx"] = in_grad[0].context
                    self.assign(in_grad[0], req[0], out_grad[0])
            return O()

    @mx.operator.register("softmax_t")
    class SoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            class Softmax(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    x = in_data[0]
                    e = (x - x.max(axis=1, keepdims=True)).exp()
                    self.assign(out_data[0], req[0],
                                e / e.sum(axis=1, keepdims=True))

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    p = out_data[0]
                    y = mx.nd.one_hot(in_data[1], p.shape[1])
                    self.assign(in_grad[0], req[0], p - y)
            return Softmax()

    @mx.operator.register("scale_aux_t")
    class ScaleAuxProp(mx.operator.CustomOpProp):
        def list_auxiliary_states(self):
            return ["scale"]

        def create_operator(self, ctx, shapes, dtypes):
            class O(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0] * aux[0])

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0], out_grad[0] * aux[0])
            return O()


def _both(fn):
    out = []
    for mx in (jmx, tmx):
        _register(mx)
        out.append([np.asarray(a) for a in fn(mx)])
    return out


def _forward_backward(mx):
    x = mx.nd.array(np.array([[1.0, 2.0, 3.0]], "float32"))
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.Custom(x, op_type="sqr_t")
    y.backward()
    return [y.asnumpy(), x.grad.asnumpy()]


def _chained(mx):
    x = mx.nd.array(np.array([2.0, -1.0], "float32"))
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.Custom(x * 3.0, op_type="sqr_t").sum()
    y.backward()
    return [y.asnumpy(), x.grad.asnumpy()]


def _assign_reqs(mx):
    dst = mx.nd.array(np.ones(3, "float32"))
    op = mx.operator.CustomOp()
    op.assign(dst, "add", mx.nd.array(np.full(3, 2.0, "float32")))
    first = dst.asnumpy()
    op.assign(dst, "null", mx.nd.array(np.zeros(3, "float32")))
    op.assign(dst, "write", dst * 2)
    return [first, dst.asnumpy()]


def _dtype_and_mode(mx):
    prop = mx.operator.get_prop("probe_t")
    x = mx.nd.array(np.ones(2, "float32"))
    x.attach_grad()
    with mx.autograd.record():
        mx.nd.Custom(x, op_type="probe_t")
    recorded = prop.seen["is_train"]
    mx.nd.Custom(x, op_type="probe_t")
    with mx.autograd.train_mode():
        mx.nd.Custom(x, op_type="probe_t")
    forced = prop.seen["is_train"]
    xi = mx.nd.array(np.ones(2, "int32"))
    y = mx.nd.Custom(xi, op_type="probe_t")
    return [np.array([recorded, forced]), y.asnumpy(),
            np.array(str(y.dtype))]


CASES = {"forward_backward": _forward_backward, "chained": _chained,
         "assign_reqs": _assign_reqs, "dtype_and_mode": _dtype_and_mode}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    want, got = _both(CASES[name])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        if g.dtype.kind == "U":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6)


@pytest.mark.parametrize("mx", [jmx, tmx], ids=["jax", "port"])
def test_unregistered_custom_op_raises(mx):
    with pytest.raises(KeyError):
        mx.nd.Custom(mx.nd.array(np.ones(2, "float32")), op_type="nope")


@pytest.mark.parametrize("mx", [jmx, tmx], ids=["jax", "port"])
def test_register_needs_a_prop(mx):
    with pytest.raises(TypeError):
        mx.operator.register("bad")(object)


def test_arrays_on_the_inputs_device():
    """The current context is the card; the inputs are on the CPU: the
    op allocates its output and gradient arrays beside the inputs (a
    port that allocated on the current context would fail here, with no
    card)."""
    _register(tmx)
    prop = tmx.operator.get_prop("probe_t")
    tmx.set_default_context(tmx.gpu(0))
    x = tmx.nd.array(np.ones(3, "float32"), ctx=tmx.cpu())
    x.attach_grad()
    with tmx.autograd.record():
        y = tmx.nd.Custom(x, op_type="probe_t")
    y.backward()
    assert prop.seen["ctx"] == tmx.cpu() and prop.seen["grad_ctx"] == tmx.cpu()
    assert y.context == tmx.cpu() and x.grad.context == tmx.cpu()


def test_aux_states_pass_through():
    _register(tmx)
    x = tmx.nd.array(np.array([1.0, -2.0], "float32"))
    s = tmx.nd.array(np.array([3.0, 0.5], "float32"))
    x.attach_grad()
    with tmx.autograd.record():
        y = tmx.nd.Custom(x, s, op_type="scale_aux_t")
    y.backward()
    np.testing.assert_array_equal(y.asnumpy(), [3.0, -1.0])
    np.testing.assert_array_equal(x.grad.asnumpy(), [3.0, 0.5])


def _net(mx):
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Conv2D(4, 3, padding=1, activation="relu"),
                mx.gluon.nn.MaxPool2D(2), mx.gluon.nn.Flatten(),
                mx.gluon.nn.Dense(5))
    return net


def _head_grads(mx, params, custom):
    net = _net(mx)
    net.initialize()
    x = mx.nd.array(np.random.RandomState(1).rand(6, 2, 8, 8)
                    .astype("float32"))
    y = mx.nd.array(np.array([0, 4, 2, 1, 3, 4], "float32"))
    net(x)
    for (_, p), v in zip(sorted(net.collect_params().items()), params):
        p.set_data(mx.nd.array(v))
    with mx.autograd.record():
        out = net(x)
        if custom:
            head = mx.nd.Custom(out, y, op_type="softmax_t")
        else:
            head = mx.gluon.loss.SoftmaxCrossEntropyLoss()(out, y)
    head.backward()
    return [p.grad().asnumpy()
            for _, p in sorted(net.collect_params().items())]


def test_custom_softmax_head_matches_softmax_ce():
    rng = np.random.RandomState(0)
    # in the sorted order of the names: conv bias, weight, dense bias, weight
    params = [rng.randn(*s).astype("float32") * 0.3
              for s in ((4,), (4, 2, 3, 3), (5,), (5, 64))]
    grads = {}
    for mx in (jmx, tmx):
        _register(mx)
        grads[mx] = [_head_grads(mx, params, custom)
                     for custom in (True, False)]
    for custom in (0, 1):
        for g, w in zip(grads[tmx][custom], grads[jmx][custom]):
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       atol=HEAD_REL * np.abs(w).max())
    for g, w in zip(*grads[tmx]):
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=HEAD_REL * np.abs(w).max())
