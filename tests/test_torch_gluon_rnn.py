"""Port parity: the fused Gluon layers ``gluon.rnn.RNN`` (relu, tanh),
``LSTM`` and ``GRU`` against the JAX package's, on the CPU.  The weights
cross through numpy by parameter name (``r_l0_i2h_weight`` ...), the
inputs come from a seeded numpy generator, and each case runs the
forward with initial states (the LSTM cases also without) and the
backward of a seeded weighted sum of the output and the final states, in
the ``TNC`` and ``NTC`` layouts.

Tolerance: outputs, final states and every gradient (input and
parameters) within 1e-5 of each tensor's largest |value| (fp32; the JAX
package's ``lax.scan`` and torch's RNN kernels add the gate products in
other orders).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jg

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon as tg

REL = 1e-5
T, N, C, H = 5, 3, 4, 6


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)


def _close(got, ref, what):
    got, ref = got.asnumpy(), ref.asnumpy()
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    bound = REL * max(float(np.abs(ref).max()), 1e-6)
    assert float(np.abs(got - ref).max()) <= bound, what


def _layers(kind, layout, bidirectional, input_size):
    kw = dict(num_layers=2, layout=layout, bidirectional=bidirectional,
              input_size=input_size, prefix="r_")
    if kind in ("relu", "tanh"):
        kw["activation"] = kind
        cls = "RNN"
    else:
        cls = kind
    return (getattr(jg.rnn, cls)(H, **kw), getattr(tg.rnn, cls)(H, **kw))


def _share_weights(jl, tl, seed):
    """Seeded weights into both layers, by name."""
    rng = np.random.RandomState(seed)
    jp = jl.collect_params()
    for name, p in tl.collect_params().items():
        w = (rng.randn(*p.shape) * 0.4).astype(np.float32)
        p.set_data(tmx.nd.array(w))
        jp[name].set_data(jmx.nd.array(w))


def _run(mx, ag, layer, x, states, weights):
    xs = mx.nd.array(x)
    xs.attach_grad()
    with ag.record():
        if states is None:
            out, new = layer(xs), []
        else:
            out, new = layer(xs, [mx.nd.array(s) for s in states])
        head = (out * mx.nd.array(weights[0])).sum()
        for s, w in zip(new, weights[1:]):
            head = head + (s * mx.nd.array(w)).sum()
    head.backward()
    grads = {n: p.grad() for n, p in layer.collect_params().items()}
    return out, new, xs.grad, grads


@pytest.mark.parametrize("kind,layout", [
    ("LSTM", "TNC"), ("LSTM", "NTC"), ("GRU", "NTC"), ("relu", "TNC"),
    ("tanh", "NTC")])
def test_layer_matches_jax(kind, layout):
    """The LSTM cases also run without initial states (zeros, and no
    states returned)."""
    bidirectional = kind in ("LSTM", "tanh")
    dirs = 2 if bidirectional else 1
    jl, tl = _layers(kind, layout, bidirectional, C)
    jl.initialize()
    tl.initialize()
    _share_weights(jl, tl, seed=len(kind))
    rng = np.random.RandomState(3)
    shape = (T, N, C) if layout == "TNC" else (N, T, C)
    x = rng.randn(*shape).astype(np.float32)
    n_states = 2 if kind == "LSTM" else 1
    states = [(rng.randn(2 * dirs, N, H) * 0.5).astype(np.float32)
              for _ in range(n_states)]
    out_shape = shape[:2] + (dirs * H,)
    weights = [rng.rand(*out_shape).astype(np.float32)] + [
        rng.rand(2 * dirs, N, H).astype(np.float32) for _ in states]
    for st in (states, None) if kind == "LSTM" else (states,):
        ref = _run(jmx, jag, jl, x, st, weights)
        got = _run(tmx, tag, tl, x, st, weights)
        assert got[0].shape == out_shape
        _close(got[0], ref[0], "output")
        assert len(got[1]) == len(ref[1]) == (0 if st is None else n_states)
        for g, r in zip(got[1], ref[1]):
            _close(g, r, "final state")
        _close(got[2], ref[2], "input gradient")
        assert sorted(got[3]) == sorted(ref[3])
        for name in ref[3]:
            _close(got[3][name], ref[3][name], name)


def test_deferred_input_size_and_states():
    """``input_size=0`` takes the first input's width; ``state_info`` and
    ``begin_state`` as in the JAX package."""
    jl, tl = _layers("LSTM", "TNC", True, 0)
    jl.initialize()
    tl.initialize()
    x = np.ones((T, N, 7), np.float32)
    jl(jmx.nd.array(x))
    tl(tmx.nd.array(x))
    for name, p in jl.collect_params().items():
        assert tl.collect_params()[name].shape == p.shape, name
    assert tl.state_info(N) == jl.state_info(N)
    assert [s.shape for s in tl.begin_state(N)] == \
        [s.shape for s in jl.begin_state(N)] == [(4, N, H)] * 2
    g = tg.rnn.GRU(H)
    assert len(g.state_info(2)) == 1


def test_dropout_and_hybridize():
    """Dropout between the layers only in training; a hybridized layer
    (on the CPU its CachedOp runs the block eagerly) gives the
    un-hybridized outputs."""
    tl = tg.rnn.LSTM(H, num_layers=2, dropout=0.5, input_size=C)
    tl.initialize(tmx.init.Xavier())
    x = tmx.nd.array(np.random.RandomState(0).randn(T, N, C).astype(
        np.float32))
    pred = tl(x)
    with tag.record():
        train = tl(x)
    assert not np.array_equal(pred.asnumpy(), train.asnumpy())
    tl.hybridize()
    _close(tl(x), pred, "hybridized predict")
