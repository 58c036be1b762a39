"""Port parity for higher-order gradients: ``autograd.grad(create_graph=True)``.

The cases of tests/test_higher_order_grad.py run through both packages on
the same float32 inputs and weights: the first, second and third
derivatives of ``sin``, ``log``, ``sigmoid`` and ``x³`` (within 1e-5
relative, 1e-6 absolute, and against the closed forms), a graph with
constants, a second derivative through ``Dense``, and a WGAN-GP gradient
penalty (Gulrajani et al. 2017) on a two-layer conv critic with
BatchNorm and LeakyReLU at small width, whose penalty, input gradient
and second-order gradients hold within 1e-4 of the largest |value|
(they pass through a convolution's backward twice).  The JAX package
replays the graph as a function of the variables handed to ``grad``
only, so the penalty's gradient reaches the critic's weights there when
they are listed too: the test lists them in both packages.

Through a user ``autograd.Function``, ``create_graph`` raises
``NotImplementedError`` in both.  Through the port's kernel Functions on
the CPU (their plain versions): the flash attention op and the fused
1x1 conv + BN statistics op give the JAX package's second derivative,
which differentiates its own custom vjps (within 1e-4).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-5, 1e-6
DEEP_REL = 1e-4


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)


def _orders(mx, fn, x_np):
    """(first, second derivative, x.grad after backward of the second)."""
    x = mx.nd.array(x_np.astype(np.float32))
    x.attach_grad()
    ag = mx.autograd
    with ag.record():
        y = fn(mx, x)
        (g1,) = ag.grad(y, x, create_graph=True, retain_graph=True)
        (g2,) = ag.grad(g1, x, create_graph=True, retain_graph=True)
    g2.backward()
    return [g1.asnumpy(), g2.asnumpy(), x.grad.asnumpy()]


FUNCS = {
    "sin": (lambda mx, x: mx.nd.sin(x), np.linspace(-2, 2, 7),
            lambda v: [np.cos(v), -np.sin(v), -np.cos(v)]),
    "log": (lambda mx, x: mx.nd.log(x), np.linspace(0.5, 3, 6),
            lambda v: [1 / v, -1 / v ** 2, 2 / v ** 3]),
    "sigmoid": (lambda mx, x: mx.nd.sigmoid(x), np.linspace(-2, 2, 5),
                None),
    "cube": (lambda mx, x: x * x * x, np.array([1.0, 2.0, -3.0]),
             lambda v: [3 * v ** 2, 6 * v, np.full_like(v, 6.0)]),
}


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_orders_match_jax(name):
    fn, x, closed = FUNCS[name]
    got = _orders(tmx, fn, x)
    want = _orders(jmx, fn, x)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    if closed is not None:
        for g, c in zip(got, closed(x)):
            np.testing.assert_allclose(g, c, rtol=RTOL, atol=ATOL)


def _constants(mx):
    x = mx.nd.array(np.array([2.0, 3.0], np.float32))
    c = mx.nd.array(np.array([5.0, 7.0], np.float32))
    x.attach_grad()
    with mx.autograd.record():
        y = (x * c).sum() + mx.nd.exp(x).sum()
        (gx,) = mx.autograd.grad(y, x, create_graph=True, retain_graph=True)
    gx.backward()
    return [gx.asnumpy(), x.grad.asnumpy()]


def test_graph_with_constants_matches_jax():
    got, want = _constants(tmx), _constants(jmx)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1], np.exp([2.0, 3.0]), rtol=RTOL)


def _dense(mx):
    net = mx.gluon.nn.Dense(2, use_bias=False, in_units=3)
    net.initialize()
    (weight,) = net.collect_params().values()
    weight.set_data(mx.nd.array(np.random.RandomState(2).randn(2, 3)
                                .astype(np.float32)))
    x = mx.nd.array(np.random.RandomState(0).rand(4, 3).astype(np.float32))
    ag = mx.autograd
    with ag.record():
        out = net(x)
        loss = (out * out * out).sum()
        (gw,) = ag.grad(loss, weight.data(), create_graph=True,
                        retain_graph=True)
        gnorm = (gw * gw).sum()
    (ggw,) = ag.grad(gnorm, weight.data())
    return [gw.asnumpy(), ggw.asnumpy()]


def test_second_order_through_dense_matches_jax():
    got, want = _dense(tmx), _dense(jmx)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=ATOL * np.abs(w).max())
    assert np.abs(got[1]).sum() > 0


LAMBDA = 10.0


def _critic(mx):
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Conv2D(4, 3, strides=2, padding=1, in_channels=3,
                                   use_bias=False),
                mx.gluon.nn.BatchNorm(in_channels=4),
                mx.gluon.nn.LeakyReLU(0.2),
                mx.gluon.nn.Conv2D(1, 4, in_channels=4))
    net.initialize()
    rng = np.random.RandomState(3)
    for _, p in sorted(net.collect_params().items()):
        if p.grad_req != "null":
            p.set_data(mx.nd.array(rng.randn(*p.shape).astype(np.float32)
                                   * 0.5))
    return net


def _penalty(mx):
    """One WGAN-GP critic loss: D(x̂) on interpolates, λ·(‖∇x̂ D‖₂ − 1)²."""
    net = _critic(mx)
    rng = np.random.RandomState(4)
    real = rng.rand(4, 3, 8, 8).astype(np.float32)
    fake = rng.rand(4, 3, 8, 8).astype(np.float32)
    eps = rng.rand(4, 1, 1, 1).astype(np.float32)
    xhat = mx.nd.array(eps * real + (1 - eps) * fake)
    xhat.attach_grad()
    params = [p for _, p in sorted(net.collect_params().items())
              if p.grad_req != "null"]
    ag = mx.autograd
    with ag.record():
        d = net(xhat)
        grads = ag.grad(d, [xhat] + [p.data() for p in params],
                        create_graph=True, retain_graph=True)
        g = grads[0].reshape((4, -1))
        norm = ((g * g).sum(axis=1) + 1e-12).sqrt()
        pen = LAMBDA * ((norm - 1) ** 2).mean()
        loss = pen + d.mean()
    loss.backward()
    return [grads[0].asnumpy(), pen.asnumpy(), xhat.grad.asnumpy()] + [
        p.grad().asnumpy() for p in params]


def test_gradient_penalty_matches_jax():
    got, want = _penalty(tmx), _penalty(jmx)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=DEEP_REL,
                                   atol=DEEP_REL * np.abs(w).max())


@pytest.mark.parametrize("mx", [jmx, tmx], ids=["jax", "port"])
def test_create_graph_through_function_raises(mx):
    class Double(mx.autograd.Function):
        def forward(self, x):
            return x * 2

        def backward(self, dy):
            return dy * 2

    x = mx.nd.array(np.ones(3, np.float32))
    x.attach_grad()
    with mx.autograd.record():
        y = Double()(x * x).sum()
        with pytest.raises(NotImplementedError):
            mx.autograd.grad(y, x, create_graph=True, retain_graph=True)


def _weights(i, shape):
    return np.random.RandomState(10 + i).rand(*shape).astype(np.float32)


def _second_order(mx, name, inputs, params):
    """Every input's gradient after backward of a weighted sum of the
    first gradients (with respect to all inputs) of a weighted sum of the
    op's outputs, with those first gradients."""
    xs = [mx.nd.array(a) for a in inputs]
    for x in xs:
        x.attach_grad()
    ag = mx.autograd
    with ag.record():
        outs = getattr(mx.nd, name)(*xs, **params)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        head = None
        for i, o in enumerate(outs):
            t = (o * mx.nd.array(_weights(i, o.shape))).sum()
            head = t if head is None else head + t
        gs = ag.grad(head, xs, create_graph=True, retain_graph=True)
        total = None
        for i, g in enumerate(gs):
            t = (g * mx.nd.array(_weights(20 + i, g.shape))).sum()
            total = t if total is None else total + t
    total.backward()
    return [g.asnumpy() for g in gs] + [x.grad.asnumpy() for x in xs]


KERNEL_OPS = {
    "flash": ("flash_attention",
              [np.random.RandomState(0).randn(1, 2, 8, 4).astype(np.float32)
               for _ in range(3)], {}),
    "flash_causal": ("flash_attention",
                     [np.random.RandomState(1).randn(1, 2, 8, 4)
                      .astype(np.float32) for _ in range(3)],
                     {"causal": True}),
    "conv1x1_bn_stats": ("_contrib_conv1x1_bn_stats",
                         [np.random.RandomState(2).randn(2, 3, 3, 8)
                          .astype(np.float32),
                          np.random.RandomState(3).randn(6, 8, 1, 1)
                          .astype(np.float32)], {}),
    "conv1x1_bn_stats_relu": ("_contrib_conv1x1_bn_stats",
                              [np.random.RandomState(4).randn(2, 3, 3, 8)
                               .astype(np.float32),
                               np.random.RandomState(5).randn(6, 8, 1, 1)
                               .astype(np.float32)], {"relu_in": True}),
}


@pytest.mark.parametrize("name", sorted(KERNEL_OPS))
def test_kernel_functions_second_order_match_jax(name):
    op, inputs, params = KERNEL_OPS[name]
    got = _second_order(tmx, op, inputs, params)
    want = _second_order(jmx, op, inputs, params)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=DEEP_REL,
                                   atol=DEEP_REL * np.abs(w).max())
    assert all(np.abs(g).sum() > 0 for g in got)


def _embedding_orders(mx):
    """(first, second derivative of a cubic head through ``Embedding``,
    and the table's gradient after backward of the second), with repeated
    and negative ids."""
    ids = np.array([[0, 3, 5, 3], [7, -1, 2, 0]], np.float32)
    data = mx.nd.array(ids)
    weight = mx.nd.array(np.random.RandomState(6).randn(8, 5)
                         .astype(np.float32))
    weight.attach_grad()
    ag = mx.autograd
    with ag.record():
        out = mx.nd.Embedding(data, weight, input_dim=8, output_dim=5)
        head = (out * out * out * mx.nd.array(_weights(0, out.shape))).sum()
        (g1,) = ag.grad(head, weight, create_graph=True, retain_graph=True)
        (g2,) = ag.grad((g1 * mx.nd.array(_weights(1, g1.shape))).sum(),
                        weight, create_graph=True, retain_graph=True)
        total = (g2 * mx.nd.array(_weights(2, g2.shape))).sum()
    total.backward()
    return [g1.asnumpy(), g2.asnumpy(), weight.grad.asnumpy()]


def test_embedding_orders_match_jax_through_the_kernel_wrapper(monkeypatch):
    from mxnet_tpu_torch.ops import embedding as emb
    calls = []
    wrapper = emb.embedding_backward

    def counted(ids, dy, vocab):
        calls.append(dy.requires_grad)
        return wrapper(ids, dy, vocab)

    monkeypatch.setattr(emb, "embedding_backward", counted)
    got = _embedding_orders(tmx)
    want = _embedding_orders(jmx)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=DEEP_REL,
                                   atol=DEEP_REL * np.abs(w).max())
        assert np.abs(g).sum() > 0
    # every scatter of the three orders went through the kernel's wrapper
    assert len(calls) == 3


def test_flash_second_order_keeps_the_forward_kernel(monkeypatch):
    """The second derivative reuses the saved forward outputs: the
    forward (the kernel on the card, its plain version here) runs once."""
    from mxnet_tpu_torch.ops import attention as att
    calls = []
    plain = att._flash_forward_plain

    def counted(*args):
        calls.append(1)
        return plain(*args)

    monkeypatch.setattr(att, "_flash_forward_plain", counted)
    op, inputs, params = KERNEL_OPS["flash_causal"]
    _second_order(tmx, op, inputs, params)
    assert len(calls) == 1
