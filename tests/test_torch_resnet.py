"""Port parity: the ResNet v1 training slice against mxnet_tpu's, on CPU
tensors.

Weights are drawn once by the port's seeded initializer and copied into
the JAX model; the JAX model's ``collect_params()`` then goes back through
``resnet_state_dict_from_mxnet`` into a fresh port model, so both start
from the same values.  Inputs are seeded numpy arrays.

Tolerances, all stated against the reference's value:

- layers and ops in fp32: 1e-5 of each tensor's largest |value| (XLA and
  PyTorch sum convolutions and batch statistics in other orders);
- a whole training step in fp32: the loss within 1e-5 of itself, and every
  parameter, momentum and running statistic within 1e-3 of its tensor's
  largest |value| plus 1e-6 (about 50 layers of such sums, forward and
  backward; the 1e-6 covers the conv biases ahead of BatchNorm, whose
  gradient is zero up to rounding).  Each step starts from the reference's
  state: BatchNorm over the 4 values per channel of the last stage makes
  the second step amplify the first step's rounding differences (measured
  against a float64 run of the port, about 1e-3 on some parameters);
- a bf16 forward: every activation is rounded to 8 bits, at other places
  in the two packages.  The reference's own bf16 error is the distance of
  its bf16 forward from its fp32 forward of the same bf16-rounded weights
  and input; the port's distance from the reference's bf16 forward must be
  at most BF16_GAP times that, summed over the logits (and over the
  losses) of four seeded batches.  Measured: 0.59 for the logits and 0.65
  for the losses; a port that applies BatchNorm's affine in fp32 reads
  1.16 and 1.24, one that takes the batch moments in bf16 1.32 and 1.92.
"""
import contextlib
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd, nd
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.contrib import amp as jamp
from mxnet_tpu.executor import CompiledTrainStep as JaxTrainStep
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.contrib.amp import convert_block
from mxnet_tpu_torch.convert import resnet_state_dict_from_mxnet
from mxnet_tpu_torch.executor import CompiledTrainStep
from mxnet_tpu_torch.gluon.contrib.nn import FusedConv1x1BN
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo.vision import (BottleneckV1, ResNetV1,
                                                    get_resnet, resnet50_v1)
from mxnet_tpu_torch.gluon.nn import BatchNorm, Conv2D, Dense
from mxnet_tpu_torch.initializer import initialize
from mxnet_tpu_torch.ops import nn as tnn

REL = 1e-5
STEP_REL, STEP_ABS = 1e-3, 1e-6
BF16_GAP, BF16_SEEDS = 1.0, (2, 3, 4, 5)
LAYERS, CHANNELS = [1, 1, 1, 1], [8, 16, 32, 64, 128]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from torch's thread pool; one thread keeps
    this file from crowding the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.astype("float32").asnumpy() if hasattr(t, "asnumpy")
                      else t, np.float32)


def _close(got, ref, rel=REL, atol=0.0, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    bound = rel * float(np.abs(ref).max()) + atol
    err = float(np.abs(got - ref).max())
    assert err <= bound, f"{what}: max err {err} > {bound}"


@contextlib.contextmanager
def _fuse(flag):
    old = os.environ.get("MXNET_TPU_FUSE_CONV_BN")
    os.environ["MXNET_TPU_FUSE_CONV_BN"] = str(int(flag))
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("MXNET_TPU_FUSE_CONV_BN")
        else:
            os.environ["MXNET_TPU_FUSE_CONV_BN"] = old


def _tiny(fused):
    with _fuse(fused):
        return ResNetV1(BottleneckV1, LAYERS, CHANNELS, classes=10,
                        device="cpu")


def _params(jnet):
    return {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}


def _pair(fused, seed=0):
    """(JAX net, port net) holding the same seeded weights."""
    with _fuse(fused):
        jnet = jres.ResNetV1(jres.BottleneckV1, LAYERS, CHANNELS, classes=10)
    source = initialize(_tiny(fused), torch.Generator().manual_seed(seed))
    jparams = jnet.collect_params()
    for p, t in zip(jparams.values(), source.state_dict().values()):
        # the input widths a first forward would infer; the JAX Parameter
        # checks the dims it already knows against them
        p.shape = tuple(t.shape)
    jparams.initialize(init=mx.init.Zero())
    for p, t in zip(jparams.values(), source.state_dict().values()):
        p.set_data(nd.array(t.numpy()))
    tnet = _tiny(fused)
    resnet_state_dict_from_mxnet(_params(jnet), tnet)
    return jnet, tnet


def _batch(seed=0, batch=4, px=32):
    rng = np.random.RandomState(seed)
    return (rng.uniform(size=(batch, 3, px, px)).astype(np.float32),
            rng.randint(0, 10, size=(batch,)).astype(np.float32))


def _sgd(module):
    return module.create("sgd", learning_rate=0.1, momentum=0.9, wd=1e-4)


# ---------------------------------------------------------------------------
# layers and ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fast_variance", [1, 0])
def test_batch_norm_matches_jax(fast_variance, monkeypatch):
    """Training forward, its gradients and the running statistics (biased
    variance, momentum 0.9), then the evaluation forward."""
    monkeypatch.setenv("MXNET_TPU_FAST_VARIANCE", str(fast_variance))
    rng = np.random.RandomState(7)
    x = (rng.randn(3, 6, 5, 5) * 2 + 3).astype(np.float32)
    cot = rng.randn(3, 6, 5, 5).astype(np.float32)
    gamma, beta = rng.rand(6).astype(np.float32) + 0.5, rng.randn(6).astype(
        np.float32)
    jbn = jnn.BatchNorm(in_channels=6)
    jbn.collect_params().initialize()
    jbn.gamma.set_data(nd.array(gamma))
    jbn.beta.set_data(nd.array(beta))
    tbn = BatchNorm(in_channels=6, device="cpu")
    with torch.no_grad():
        tbn.gamma.copy_(torch.from_numpy(gamma))
        tbn.beta.copy_(torch.from_numpy(beta))
    jx = nd.array(x)
    jx.attach_grad()
    with autograd.record():
        jout = jbn(jx)
        (jout * nd.array(cot)).sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    tout = tbn(tx)
    (tout * torch.from_numpy(cot)).sum().backward()
    _close(tout, jout, what="train out")
    _close(tx.grad, jx.grad, what="dx")
    _close(tbn.gamma.grad, jbn.gamma.grad(), what="dgamma")
    _close(tbn.beta.grad, jbn.beta.grad(), what="dbeta")
    _close(tbn.running_mean, jbn.running_mean.data(), what="running_mean")
    _close(tbn.running_var, jbn.running_var.data(), what="running_var")
    with torch.no_grad():
        tinf = tbn.eval()(torch.from_numpy(x))
    _close(tinf, jbn(nd.array(x)), what="eval out")


@pytest.mark.parametrize("case", ["sparse", "dense", "weighted"])
def test_softmax_cross_entropy_matches_jax(case):
    rng = np.random.RandomState(8)
    pred = rng.randn(5, 7).astype(np.float32)
    if case == "dense":
        label = rng.dirichlet(np.ones(7), 5).astype(np.float32)
    else:
        label = rng.randint(0, 7, 5).astype(np.float32)
    kw = {"sparse_label": case != "dense"}
    if case == "weighted":
        kw["weight"] = 0.5
    sw = rng.rand(5, 1).astype(np.float32) if case == "weighted" else None
    ref = jloss.SoftmaxCrossEntropyLoss(**kw)(
        nd.array(pred), nd.array(label),
        None if sw is None else nd.array(sw))
    got = SoftmaxCrossEntropyLoss(**kw)(
        torch.from_numpy(pred), torch.from_numpy(label),
        None if sw is None else torch.from_numpy(sw))
    _close(got, ref, what=case)


def test_nn_ops_match_jax():
    """Max pooling 3/2/1, global average pooling, FullyConnected with
    flatten, and pick with out-of-range indices."""
    rng = np.random.RandomState(9)
    x = rng.randn(2, 3, 9, 8).astype(np.float32)
    tx = torch.from_numpy(x)
    _close(tnn.pooling(tx, (3, 3), "max", stride=(2, 2), pad=(1, 1)),
           nd.Pooling(nd.array(x), kernel=(3, 3), pool_type="max",
                      stride=(2, 2), pad=(1, 1)), what="max pool")
    _close(tnn.pooling(tx, pool_type="avg", global_pool=True),
           nd.Pooling(nd.array(x), kernel=(1, 1), pool_type="avg",
                      global_pool=True), what="global avg pool")
    w = rng.randn(4, 3 * 9 * 8).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    _close(tnn.fully_connected(tx, torch.from_numpy(w), torch.from_numpy(b)),
           nd.FullyConnected(nd.array(x), nd.array(w), nd.array(b),
                             num_hidden=4), what="fully_connected")
    data = rng.randn(4, 5).astype(np.float32)
    index = np.array([0, 4, 7, -2], np.float32)
    _close(tnn.pick(torch.from_numpy(data), torch.from_numpy(index)),
           nd.pick(nd.array(data), nd.array(index), axis=-1), what="pick")


def test_initialize_follows_gluon_defaults():
    for fused in (True, False):
        net = initialize(_tiny(fused), torch.Generator().manual_seed(1))
        for m in net.modules():
            if isinstance(m, (Conv2D, Dense)):
                assert 0 < m.weight.abs().max() <= 0.07
                assert m.bias is None or not m.bias.any()
            if isinstance(m, FusedConv1x1BN):
                out, inp = m.weight.shape[:2]
                bound = (3.0 / ((inp + out) / 2)) ** 0.5
                assert 0.07 < m.weight.abs().max() <= bound  # Xavier
            if isinstance(m, (BatchNorm, FusedConv1x1BN)):
                assert (m.gamma == 1).all() and not m.beta.any()
                assert (m.running_var == 1).all() and not m.running_mean.any()


@pytest.mark.parametrize("fused", [True, False])
def test_resnet50_v1_builds_like_jax(fused):
    """Full resnet50_v1 on the CPU, not initialised: the tensors pair with
    the JAX model's collect_params() in order and role, and the fused build
    has the 36 fused blocks that make a training step's 36 kernel
    launches."""
    with _fuse(fused):
        jnet = jres.resnet50_v1()
        tnet = resnet50_v1(device="cpu")
    names = list(jnet.collect_params().keys())
    keys = list(tnet.state_dict().keys())
    assert len(names) == len(keys)
    for n, k in zip(names, keys):
        assert n.rsplit("_", 2)[-1] == k.rsplit(".", 1)[-1].rsplit("_")[-1]
    blocks = sum(isinstance(m, FusedConv1x1BN) for m in tnet.modules())
    assert blocks == (36 if fused else 0)
    one_by_one = [m for m in tnet.modules()
                  if isinstance(m, Conv2D) and m.weight.shape[2:] == (1, 1)]
    assert len(one_by_one) == (0 if fused else 36)
    # the body's 1x1 convs carry a bias, the 4 downsample convs none
    assert sum(m.bias is None for m in one_by_one) == (0 if fused else 4)


def test_convert_round_trip_and_errors():
    jnet, tnet = _pair(True)
    params = _params(jnet)
    state = tnet.state_dict()
    assert len(params) == len(state)
    for (n, arr), t in zip(params.items(), state.values()):
        np.testing.assert_array_equal(t.numpy(), arr, err_msg=n)
    names = list(params)
    with pytest.raises(MXNetError, match="no parameter"):
        resnet_state_dict_from_mxnet(
            {n: params[n] for n in names[:-1]}, _tiny(True))
    with pytest.raises(MXNetError, match="no place"):
        resnet_state_dict_from_mxnet(dict(params, extra_weight=params[
            names[0]]), _tiny(True))
    swapped = dict(params)
    swapped[names[1]] = params[names[1]][:-1]
    with pytest.raises(MXNetError, match="shape"):
        resnet_state_dict_from_mxnet(swapped, _tiny(True))
    reordered = {n: params[n] for n in [names[0], names[2], names[1]]
                 + names[3:]}
    with pytest.raises(MXNetError, match="roles"):
        resnet_state_dict_from_mxnet(reordered, _tiny(True))


def test_get_resnet_ports_v1_only():
    # v2 is ported too since slice 19; an unknown version still raises,
    # naming the versions there are
    with pytest.raises(MXNetError, match="v1 and v2"):
        get_resnet(3, 50, device="cpu")


# ---------------------------------------------------------------------------
# the whole slice: CompiledTrainStep on the small ResNetV1
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_train_steps_match_jax(fused):
    """Two SGD steps (lr 0.1, momentum 0.9, wd 1e-4) of
    ResNetV1(BottleneckV1, [1, 1, 1, 1], [8, 16, 32, 64, 128], classes=10)
    at 32 px, batch 4, fp32: each step's loss, every updated parameter, the
    momentum and the running statistics."""
    jnet, tnet = _pair(fused)
    jstep = JaxTrainStep(jnet, jloss.SoftmaxCrossEntropyLoss(), _sgd(jopt),
                         batch_size=4)
    tstep = CompiledTrainStep(tnet, SoftmaxCrossEntropyLoss(), _sgd(topt),
                              batch_size=4)
    learnable = [k for k, p in jnet.collect_params().items()
                 if p.grad_req != "null"]
    assert len(learnable) == len(tstep._states)
    for step, seed in enumerate((0, 1)):
        if step:
            # start from the reference's state (see the module docstring)
            resnet_state_dict_from_mxnet(_params(jnet), tnet)
            for mom, ref in zip(tstep._states, jstep._states):
                mom.copy_(torch.tensor(ref.asnumpy()))
        x, y = _batch(seed)
        ref_loss = float(jstep(nd.array(x), nd.array(y)).asnumpy())
        loss = float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
        assert abs(loss - ref_loss) <= REL * abs(ref_loss), (step, loss,
                                                              ref_loss)
        for (name, ref), t in zip(_params(jnet).items(),
                                  tnet.state_dict().values()):
            _close(t, ref, STEP_REL, STEP_ABS, what=f"step {step} {name}")
        for name, mom, ref in zip(learnable, tstep._states, jstep._states):
            _close(mom, ref, STEP_REL, STEP_ABS,
                   what=f"step {step} momentum {name}")


def test_bf16_unfused_forward_and_loss_match_jax():
    """bench.py's main configuration: convert_block to bf16 (norm tensors
    stay fp32) and a training-mode forward with its per-sample losses,
    held to the reference's own bf16 error (see the module docstring)."""
    jnet, tnet = _pair(False)
    j32, _ = _pair(False)
    jamp.convert_block(jnet, "bfloat16")
    convert_block(tnet, "bfloat16")
    for (name, p), t, p32 in zip(jnet.collect_params().items(),
                                 tnet.state_dict().values(),
                                 j32.collect_params().values()):
        assert str(p.data().dtype) == str(t.dtype).split(".")[-1], name
        p32.set_data(p.data().astype("float32"))
    jnet.hybridize()
    j32.hybridize()
    jloss_fn = jloss.SoftmaxCrossEntropyLoss()
    loss_fn = SoftmaxCrossEntropyLoss()
    # summed |port - reference| and |reference bf16 - reference fp32|
    gap = {"logits": 0.0, "losses": 0.0}
    ref_err = dict(gap)
    for seed in BF16_SEEDS:
        x, y = _batch(seed)
        xb = torch.from_numpy(x).to(torch.bfloat16)
        with autograd.record():
            jout = jnet(nd.array(x).astype("bfloat16"))
            jl = jloss_fn(jout, nd.array(y))
            jout32 = j32(nd.array(xb.float().numpy()))
            jl32 = jloss_fn(jout32, nd.array(y))
        with torch.no_grad():
            tout = tnet.train()(xb)
            tl = loss_fn(tout, torch.from_numpy(y))
        assert tout.dtype == tl.dtype == torch.bfloat16
        assert str(jout.dtype) == "bfloat16"
        for key, got, ref, ref32 in (("logits", tout, jout, jout32),
                                     ("losses", tl, jl, jl32)):
            gap[key] += float(np.abs(_np(got) - _np(ref)).sum())
            ref_err[key] += float(np.abs(_np(ref) - _np(ref32)).sum())
    for key in gap:
        assert gap[key] <= BF16_GAP * ref_err[key], (key, gap[key],
                                                     ref_err[key])


def test_bf16_fused_training_fails_like_jax():
    """The fused block returns fp32 from bf16 in both packages, so the next
    bf16 3x3 conv refuses the mixed dtypes: the fused build cannot train in
    bf16 (a fault of the reference that the port keeps)."""
    jnet, tnet = _pair(True)
    jamp.convert_block(jnet, "bfloat16")
    convert_block(tnet, "bfloat16")
    x, _ = _batch(3, batch=2)
    with pytest.raises(TypeError, match="same dtypes"):
        with autograd.record():
            jnet(nd.array(x).astype("bfloat16"))
    with pytest.raises(RuntimeError):
        tnet.train()(torch.from_numpy(x).to(torch.bfloat16))
