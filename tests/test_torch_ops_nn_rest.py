"""Port parity: the rest of ``mxnet_tpu/ops/nn.py`` (``softmin``,
``SoftmaxActivation``, ``LRN``, ``softmax_cross_entropy``,
``masked_softmax``, ``masked_log_softmax``, ``ROIPooling``, ``im2col``,
``CuDNNBatchNorm``), the fused ``RNN`` op in its four modes, the registry
op ``rope`` and the ``MXNET_TPU_CONV_LAYOUT`` knob, on the CPU, from
seeded numpy inputs through both packages' ``mx.nd``.

Tolerances: outputs and gradients within 1e-6 of the largest |value|
(``RNN``: 1e-5, the JAX package's ``lax.scan`` and torch's RNN kernels
add the gate products in other orders); masked positions exactly 0
(``masked_softmax``) and -inf (``masked_log_softmax``); the NHWC
convolutions within 1e-5 of the NCHW ones (another summation order).
"""
import math

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import nn as tnn
from torch_op_parity import check, same


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


_MASK = (np.random.RandomState(4).rand(3, 7) > 0.4).astype(np.float32)
_MASK[1] = 0                                   # a row with nothing kept
_ROIS = np.array([[0, 0, 0, 7, 7], [1, 2, 1, 5, 6], [0, 4, 4, 4, 4]],
                 np.float32)

NN = [
    ("softmin", [_rand(3, 5)], dict(axis=1)),
    ("softmin", [_rand(2, 3, 4)], dict(axis=0, temperature=2.0)),
    ("SoftmaxActivation", [_rand(2, 3, 2, 2)], {}),
    ("SoftmaxActivation", [_rand(2, 3, 2, 2)], dict(mode="channel")),
    ("LRN", [_rand(2, 6, 3, 3)], dict(nsize=3, alpha=0.1)),
    ("softmax_cross_entropy", [_rand(4, 5), np.array([0, 4, 2, 2],
                                                     np.float32)], {}),
    ("masked_softmax", [_rand(3, 7), _MASK], {}),
    ("masked_softmax", [_rand(3, 7), _MASK], dict(temperature=0.5)),
    ("masked_log_softmax", [_rand(3, 7), _MASK], {}),
    ("ROIPooling", [_rand(2, 3, 8, 8), _ROIS],
     dict(pooled_size=(2, 3), spatial_scale=1.0)),
    ("ROIPooling", [_rand(2, 2, 8, 8), _ROIS],
     dict(pooled_size=(3, 3), spatial_scale=0.5)),
    ("im2col", [_rand(2, 3, 6, 5)],
     dict(kernel=(3, 3), stride=(2, 1), dilate=(1, 2), pad=(1, 1))),
    ("im2col", [_rand(2, 3, 9)], dict(kernel=(3,), pad=(1,))),
    ("im2col", [_rand(1, 2, 4, 4, 3)], dict(kernel=(2, 2, 2))),
    ("CuDNNBatchNorm", [_rand(4, 3, 2, 2), _rand(3, seed=1),
                        _rand(3, seed=2), np.zeros(3, np.float32),
                        np.ones(3, np.float32)], dict(fix_gamma=False)),
]


@pytest.mark.parametrize("case", NN, ids=lambda c: c[0])
def test_nn_ops_match_jax(case):
    name, arrays, params = case
    check(name, arrays, params, grad=name != "ROIPooling")


def test_masked_positions_are_exact():
    x = tmx.nd.array(_rand(3, 7))
    m = tmx.nd.array(_MASK)
    p = tmx.nd.masked_softmax(x, m).asnumpy()
    lp = tmx.nd.masked_log_softmax(x, m).asnumpy()
    assert (p[_MASK == 0] == 0).all() and np.isfinite(p).all()
    assert np.isneginf(lp[_MASK == 0]).all()
    assert np.isfinite(lp[_MASK == 1]).all()


def _rnn_inputs(mode, dirs, seed):
    shapes = tnn.rnn_param_shapes(mode, 4, 6, 2, dirs)
    n = sum(math.prod(s) for s in shapes)
    arrays = [_rand(5, 3, 4, seed=seed), _rand(n, seed=seed + 1, scale=0.3),
              _rand(2 * dirs, 3, 6, seed=seed + 2, scale=0.5)]
    if mode == "lstm":
        arrays.append(_rand(2 * dirs, 3, 6, seed=seed + 3, scale=0.5))
    return arrays


@pytest.mark.parametrize("mode,bidirectional", [
    ("lstm", True), ("gru", True), ("rnn_tanh", True), ("rnn_relu", True),
    ("lstm", False)])
def test_rnn_op_matches_jax(mode, bidirectional):
    """Two layers, p = 0: the output, the final states and the gradients
    of the data, the flat parameters and the initial states (a
    bidirectional layer runs both directions)."""
    arrays = _rnn_inputs(mode, 2 if bidirectional else 1, 10)
    check("RNN", arrays, dict(state_size=6, num_layers=2, mode=mode,
                              bidirectional=bidirectional), grad=True,
          rel=1e-5)


def test_rnn_dropout_between_layers():
    """p drops each layer's output but the last's, only in training: in
    predict the op equals its p = 0 form, in training the two-layer
    output differs from it, and a one-layer op has nothing to drop."""
    arrays = [tmx.nd.array(a) for a in _rnn_inputs("lstm", 1, 20)]
    kw = dict(state_size=6, num_layers=2, mode="lstm")
    plain = tmx.nd.RNN(*arrays, p=0.0, **kw)
    pred = tmx.nd.RNN(*arrays, p=0.5, **kw)
    for a, b in zip(plain, pred):
        assert np.array_equal(a.asnumpy(), b.asnumpy())
    with tmx.autograd.record():
        train = tmx.nd.RNN(*arrays, p=0.5, **kw)
    assert not np.array_equal(train[0].asnumpy(), plain[0].asnumpy())
    first = [arrays[0], tmx.nd.array(arrays[1].asnumpy()[:288]),
             arrays[2][:1], arrays[3][:1]]
    kw["num_layers"] = 1
    with tmx.autograd.record():
        one = tmx.nd.RNN(*first, p=0.5, **kw)
    assert np.array_equal(one[0].asnumpy(),
                          tmx.nd.RNN(*first, p=0.0, **kw)[0].asnumpy())


def test_rnn_symbol_form():
    """``mx.sym.RNN``: three outputs for an LSTM (two otherwise, one
    without ``state_outputs``) and the JAX package's shapes."""
    for mode, nout in (("lstm", 3), ("gru", 2)):
        shapes = dict(data=(5, 3, 4), params=(
            sum(math.prod(s) for s in tnn.rnn_param_shapes(mode, 4, 6, 2,
                                                           2)),),
            state=(4, 3, 6))
        names = ["data", "params", "state"] + ["cell"] * (mode == "lstm")
        if mode == "lstm":
            shapes["cell"] = (4, 3, 6)
        kw = dict(state_size=6, num_layers=2, mode=mode, bidirectional=True)
        jsym = jmx.sym.RNN(*[jmx.sym.var(n) for n in names], **kw)
        tsym = tmx.sym.RNN(*[tmx.sym.var(n) for n in names], **kw)
        assert len(tsym.list_outputs()) == len(jsym.list_outputs()) == nout
        assert tsym.infer_shape(**shapes)[1] == jsym.infer_shape(**shapes)[1]
    one = tmx.sym.RNN(*[tmx.sym.var(n) for n in ("d", "p", "s")],
                      state_size=6, mode="gru", state_outputs=False)
    assert len(one.list_outputs()) == 1


@pytest.mark.parametrize("packed", [True, False])
def test_rope_op_matches_jax(packed):
    s, d = 5, 4
    ang = np.outer(np.arange(s), 1.0 / 10000 ** (np.arange(d // 2) / d))
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    x = _rand(2, s, 2 * d) if packed else _rand(2, 2, s, d)
    check("rope", [x, cos, sin], dict(num_heads=2) if packed else {},
          grad=True)
    sym = tmx.sym.rope(tmx.sym.var("x"), tmx.sym.var("c"),
                       tmx.sym.var("s"), num_heads=2)
    assert sym.infer_shape(x=(2, s, 8), c=(s, 2), s=(s, 2))[1] == [(2, s, 8)]


def test_conv_layout_knob(monkeypatch):
    """``MXNET_TPU_CONV_LAYOUT=NHWC``: a 2-D convolution runs on a
    channels_last tensor and returns one of the NCHW shape; the outputs
    and gradients hold to the NCHW run and to the JAX package under the
    same knob."""
    x, w, b = _rand(2, 3, 7, 6), _rand(4, 3, 3, 3, seed=1), _rand(4, seed=2)
    params = dict(kernel=(3, 3), stride=(2, 1), pad=(1, 1), num_filter=4)
    nchw = tmx.nd.Convolution(tmx.nd.array(x), tmx.nd.array(w),
                              tmx.nd.array(b), **params)
    monkeypatch.setenv("MXNET_TPU_CONV_LAYOUT", "NHWC")
    nhwc = tmx.nd.Convolution(tmx.nd.array(x), tmx.nd.array(w),
                              tmx.nd.array(b), **params)
    assert nhwc._data.is_contiguous(memory_format=torch.channels_last)
    assert not nchw._data.is_contiguous(memory_format=torch.channels_last)
    same(nhwc.asnumpy(), nchw.asnumpy(), "NHWC against NCHW", 1e-5)
    check("Convolution", [x, w, b], params, grad=True, rel=1e-5)
