"""Port parity: ``CompiledTrainStep`` against mxnet_tpu's, on CPU tensors.

A two-head net whose loss reads only the first head: the second head gets
no gradient.  The JAX package's compiled step differentiates with
``jax.value_and_grad``, which gives it a zero gradient, and still updates
it; the port's step must do the same (under SGD with wd the head decays by
exactly lr·wd·w, under Adam it stays).  The net takes a tuple input, which
both steps unpack into ``net(*x)``, and Adam's bias correction follows the
step's 1-based count.  Inputs and weights are seeded numpy arrays copied
into both packages.

Tolerance: fp32 parameters within 1e-6 of each tensor's largest |value|
(the same arithmetic summed in other orders), except where the test says
"exactly".
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.executor import CompiledTrainStep as JaxTrainStep
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.executor import CompiledTrainStep
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.nn import Dense

REL = 1e-6
LR, WD = 0.1, 1e-4


class _JaxTwoHead(jgluon.HybridBlock):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.read = jnn.Dense(3, in_units=4)
            self.unread = jnn.Dense(2, in_units=4)

    def hybrid_forward(self, F, x, z):
        return self.read(x + z), self.unread(x)


class _TwoHead(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.read = Dense(3, in_units=4, device="cpu")
        self.unread = Dense(2, in_units=4, device="cpu")

    def forward(self, x, z):
        return self.read(x + z), self.unread(x)


def _pair(seed=0):
    rng = np.random.RandomState(seed)
    jnet = _JaxTwoHead()
    jnet.collect_params().initialize()
    tnet = _TwoHead()
    for p, t in zip(jnet.collect_params().values(), tnet.state_dict().values()):
        value = rng.uniform(-0.5, 0.5, tuple(t.shape)).astype(np.float32)
        p.set_data(nd.array(value))
        t.copy_(torch.from_numpy(value))
    return jnet, tnet


def _batch(seed):
    rng = np.random.RandomState(100 + seed)
    return (rng.randn(6, 4).astype(np.float32),
            rng.randn(6, 4).astype(np.float32),
            rng.randint(0, 3, 6).astype(np.float32))


def _steps(opt_name, n, **opt_kw):
    """``n`` steps of the two-head net in both packages from the same
    weights; returns (JAX params, port params) as numpy, keyed by role."""
    jnet, tnet = _pair()
    jce, tce = jloss.SoftmaxCrossEntropyLoss(), SoftmaxCrossEntropyLoss()
    jstep = JaxTrainStep(jnet, lambda out, y: jce(out[0], y),
                         jopt.create(opt_name, **opt_kw), batch_size=6)
    tstep = CompiledTrainStep(tnet, lambda out, y: tce(out[0], y),
                              topt.create(opt_name, **opt_kw), batch_size=6)
    for i in range(n):
        x, z, y = _batch(i)
        jstep((nd.array(x), nd.array(z)), nd.array(y))
        tstep((torch.from_numpy(x), torch.from_numpy(z)), torch.from_numpy(y))
    keys = list(tnet.state_dict())
    jp = dict(zip(keys, (p.data().asnumpy()
                         for p in jnet.collect_params().values())))
    tp = {k: v.detach().numpy() for k, v in tnet.state_dict().items()}
    return jp, tp, tstep


def _close(got, ref, what):
    bound = REL * float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= bound, f"{what}: max err {err} > {bound}"


def test_sgd_decays_the_unread_head_like_jax():
    """SGD, wd 1e-4: the unread head moves by exactly lr·wd·w in both
    packages (its gradient is zero), and the read head agrees."""
    init = {k: v.numpy().copy() for k, v in _pair()[1].state_dict().items()}
    jp, tp, _ = _steps("sgd", 1, learning_rate=LR, wd=WD)
    for key in ("unread.weight", "unread.bias"):
        w = init[key]
        want = w - np.float32(LR) * (np.float32(WD) * w)
        np.testing.assert_array_equal(tp[key], want)
        np.testing.assert_array_equal(jp[key], want)
    for key in ("read.weight", "read.bias"):
        assert not np.array_equal(tp[key], init[key])
        _close(tp[key], jp[key], key)


@pytest.mark.parametrize("steps", [1, 3])
def test_adam_leaves_the_unread_head_and_matches_jax(steps):
    """Adam: the unread head does not move (m and v stay 0); the read head
    follows the reference over 1 and 3 steps, so the bias correction
    reads the same step count."""
    init = {k: v.numpy().copy() for k, v in _pair()[1].state_dict().items()}
    jp, tp, tstep = _steps("adam", steps, learning_rate=1e-2)
    for key in ("unread.weight", "unread.bias"):
        np.testing.assert_array_equal(tp[key], init[key])
        np.testing.assert_array_equal(jp[key], init[key])
    for key in ("read.weight", "read.bias"):
        _close(tp[key], jp[key], key)
    assert tstep._num_update == steps
    assert tstep._opt._step is None
    assert tstep._opt.num_update == steps


def test_step_count_drives_adams_bias_correction():
    """Inside a step Adam reads the step's count, not its own per-index
    count: an optimizer that has already made 5 updates of index 0 takes
    the first step's size on the step's first call."""
    net = Dense(1, in_units=1, device="cpu")
    with torch.no_grad():
        net.weight.fill_(1.0)
        net.bias.zero_()
    opt = topt.create("adam", learning_rate=0.5)
    for _ in range(5):
        opt._update_count(0)
    step = CompiledTrainStep(net, lambda out, y: (out - y).square(), opt)
    step(torch.ones(1, 1), torch.zeros(1, 1))
    # step 1: lr·sqrt(1 − β2)/(1 − β1)·m/(sqrt(v) + ε) = lr·(1 − ε-term)
    assert abs(net.weight.item() - 0.5) < 1e-6
