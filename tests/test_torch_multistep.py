"""Port parity: ``MultiStepTrainStep`` and ``stack_batches`` against
mxnet_tpu's, on CPU tensors.

K = 4 steps from one super-batch must equal 4 ``CompiledTrainStep`` calls
of the port exactly (the same step, run K times, each with its own
learning rate and step count), and follow the JAX ``MultiStepTrainStep``
(``lax.scan`` over K steps) within 1e-6 of each tensor's largest |value|:
SGD with momentum and wd, and Adam, each with and without a
``FactorScheduler``.  A tail super-batch of K = 2 continues the count.
Inputs and weights are seeded numpy arrays copied into both packages.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu import gluon as jgluon
from mxnet_tpu import lr_scheduler as jsched
from mxnet_tpu import nd
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.executor import MultiStepTrainStep as JaxMultiStep
from mxnet_tpu.executor import stack_batches as jax_stack_batches
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu_torch import lr_scheduler as tsched
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.executor import (CompiledTrainStep, MultiStepTrainStep,
                                      stack_batches)
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.nn import BatchNorm, Dense, Dropout

REL = 1e-6


class _JaxNet(jgluon.HybridBlock):
    """Two inputs: ``relu(fc(bn(x + z)))`` into the classifier (no bias
    before a BatchNorm, which would cancel it: its gradient would be
    rounding noise that Adam scales up to ±lr)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.fc = jnn.Dense(16, in_units=6)
            self.bn = jnn.BatchNorm(in_channels=6)
            self.out = jnn.Dense(4, in_units=16)

    def hybrid_forward(self, F, x, z):
        return self.out(F.relu(self.fc(self.bn(x + z))))


class _Net(torch.nn.Module):
    def __init__(self, dropout=0.0):
        super().__init__()
        self.fc = Dense(16, in_units=6, device="cpu")
        self.bn = BatchNorm(in_channels=6, device="cpu")
        self.out = Dense(4, in_units=16, device="cpu")
        self.drop = (Dropout(dropout, generator=torch.Generator().manual_seed(
            3)) if dropout else None)

    def forward(self, x, z):
        h = torch.relu(self.fc(self.bn(x + z)))
        if self.drop is not None:
            h = self.drop(h)
        return self.out(h)


def _pair(dropout=0.0):
    rng = np.random.RandomState(0)
    jnet = _JaxNet()
    jnet.collect_params().initialize()
    tnet = _Net(dropout)
    for p, (key, t) in zip(jnet.collect_params().values(),
                           tnet.state_dict().items()):
        value = rng.uniform(-0.5, 0.5, tuple(t.shape)).astype(np.float32)
        if "running_var" in key:
            value = np.abs(value) + 0.5
        p.set_data(nd.array(value))
        t.copy_(torch.from_numpy(value))
    return jnet, tnet


def _batches(n, seed):
    rng = np.random.RandomState(seed)
    return [((rng.randn(8, 6).astype(np.float32),
              rng.randn(8, 6).astype(np.float32)),
             rng.randint(0, 4, 8).astype(np.float32)) for _ in range(n)]


def _torch_batch(b):
    (x, z), y = b
    return (torch.from_numpy(x), torch.from_numpy(z)), torch.from_numpy(y)


def _jax_batch(b):
    (x, z), y = b
    return (nd.array(x), nd.array(z)), nd.array(y)


def _opt(module, sched, name, scheduled):
    kw = (dict(learning_rate=0.1, momentum=0.9, wd=1e-4) if name == "sgd"
          else dict(learning_rate=0.02))
    if scheduled:
        kw["lr_scheduler"] = sched.FactorScheduler(step=2, factor=0.5)
    return module.create(name, **kw)


def _close(got, ref, what):
    bound = REL * float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= bound, f"{what}: max err {err} > {bound}"


CASES = [("sgd", False), ("sgd", True), ("adam", False), ("adam", True)]


@pytest.mark.parametrize("name,scheduled", CASES)
def test_multistep_matches_jax_and_single_steps(name, scheduled):
    """K = 4 then a tail K = 2, multi-input super-batches from
    ``stack_batches``: against the JAX ``MultiStepTrainStep`` (1e-6) and
    against 6 single port steps (exact), losses included."""
    batches = _batches(6, seed=21)
    jnet, tnet = _pair()
    _, single = _pair()
    jstep = JaxMultiStep(jnet, jloss.SoftmaxCrossEntropyLoss(),
                         _opt(jopt, jsched, name, scheduled))
    tstep = MultiStepTrainStep(tnet, SoftmaxCrossEntropyLoss(),
                               _opt(topt, tsched, name, scheduled))
    sstep = CompiledTrainStep(single, SoftmaxCrossEntropyLoss(),
                              _opt(topt, tsched, name, scheduled))
    jlosses, tlosses = [], []
    for chunk in (batches[:4], batches[4:]):
        jx, jy = jax_stack_batches([_jax_batch(b) for b in chunk])
        tx, ty = stack_batches([_torch_batch(b) for b in chunk])
        assert isinstance(tx, tuple) and tuple(tx[0].shape) == (len(chunk), 8, 6)
        jlosses.append(jstep(jx, jy).asnumpy())
        tlosses.append(tstep(tx, ty))
    assert [tuple(t.shape) for t in tlosses] == [(4,), (2,)]
    slosses = torch.stack([sstep(*_torch_batch(b)) for b in batches])
    assert torch.equal(torch.cat(tlosses), slosses)
    _close(torch.cat(tlosses).numpy(), np.concatenate(jlosses), "losses")
    for key, t in tnet.state_dict().items():
        assert torch.equal(t, single.state_dict()[key]), key
    for p, (key, t) in zip(jnet.collect_params().values(),
                           tnet.state_dict().items()):
        _close(t.numpy(), p.data().asnumpy(), key)
    assert tstep._num_update == 6 and tstep._opt.num_update == 6


def test_multistep_with_dropout_equals_single_steps():
    """With Dropout(0.5) on its own generator the K steps draw the masks K
    single steps draw: bit for bit, under Adam."""
    batches = _batches(4, seed=5)
    _, tnet = _pair(dropout=0.5)
    _, single = _pair(dropout=0.5)
    tstep = MultiStepTrainStep(tnet, SoftmaxCrossEntropyLoss(),
                               topt.create("adam", learning_rate=0.02))
    sstep = CompiledTrainStep(single, SoftmaxCrossEntropyLoss(),
                              topt.create("adam", learning_rate=0.02))
    losses = tstep(*stack_batches([_torch_batch(b) for b in batches]))
    ref = torch.stack([sstep(*_torch_batch(b)) for b in batches])
    assert torch.equal(losses, ref)
    for key, t in tnet.state_dict().items():
        assert torch.equal(t, single.state_dict()[key]), key


@pytest.mark.parametrize("env_value,want", [(None, 1), ("4", 4), ("0", 1)])
def test_steps_per_call_defaults_to_the_env(env_value, want, monkeypatch):
    """``steps_per_call=None`` reads ``MXNET_TPU_STEPS_PER_CALL`` (default
    1, at least 1), as the JAX package does; an explicit value wins."""
    if env_value is None:
        monkeypatch.delenv("MXNET_TPU_STEPS_PER_CALL", raising=False)
    else:
        monkeypatch.setenv("MXNET_TPU_STEPS_PER_CALL", env_value)
    _, tnet = _pair()
    step = MultiStepTrainStep(tnet, SoftmaxCrossEntropyLoss(),
                              topt.create("sgd"))
    assert step.steps_per_call == want
    jnet, _ = _pair()
    jstep = JaxMultiStep(jnet, jloss.SoftmaxCrossEntropyLoss(),
                         jopt.create("sgd"))
    assert jstep.steps_per_call == want
    assert MultiStepTrainStep(tnet, SoftmaxCrossEntropyLoss(),
                              topt.create("sgd"),
                              steps_per_call=3).steps_per_call == 3


def test_ndarray_super_batches_give_ndarray_losses():
    """NDArray leaves (a Gluon iterator's batches) stack into NDArrays and
    the K losses come back as an NDArray, equal to the tensor path's."""
    import mxnet_tpu_torch as mx
    batches = _batches(3, seed=8)
    out = []
    for wrap in (False, True):
        _, tnet = _pair()
        step = MultiStepTrainStep(tnet, SoftmaxCrossEntropyLoss(),
                                  topt.create("sgd", learning_rate=0.1))
        tb = [_torch_batch(b) for b in batches]
        if wrap:
            tb = [((mx.nd.NDArray(x, mx.cpu()), mx.nd.NDArray(z, mx.cpu())),
                   mx.nd.NDArray(y, mx.cpu())) for (x, z), y in tb]
        sx, sy = stack_batches(tb)
        assert isinstance(sy, mx.nd.NDArray) == wrap
        losses = step(sx, sy)
        assert isinstance(losses, mx.nd.NDArray) == wrap
        out.append(losses._data if wrap else losses)
    assert torch.equal(*out)
