"""Port parity: the vision model zoo (ResNet v2, AlexNet, VGG, SqueezeNet,
MobileNet v1 and v2, DenseNet, Inception v3) against the JAX package, on
the CPU, at reduced widths where a family allows it.  This file holds
the helpers, ResNet v2 with basic blocks and the tests of no one family;
the other families' tests are in ``tests/test_torch_vision_zoo_{mobilenet,
classic,densenet,squeezenet,inception}.py`` (the store's tests in the
MobileNet file, ResNet v2 with bottleneck blocks in the DenseNet file),
so that each file runs in under a minute on the CPU.

Each family is built in both packages under the same ``prefix=`` and the
two ``collect_params()`` key sets must be equal.  The port's model runs
first, on the CPU (its first forward allocates the deferred widths); the
JAX model takes each parameter's shape from it, draws its weights from
``mx.random.seed(0)``'s Xavier (the norms' gamma, beta and moving
statistics uniform around their initial values), and hands them to the
port through ``convert.params_from_mxnet``; the JAX model then runs
hybridized (one compiled program instead of one compile per op).
Compared: the eval forward of every family's model, and a training-mode
forward and backward under a seeded head gradient (every parameter's
gradient and every moving statistic after it) of the model, or for the
deep families of a few of its own blocks (see ``TRAIN_FAMILIES``), under
the centred variance against the compiled JAX run and under the default
one-pass variance against the eager JAX run (see :func:`train_check`).
A float64 run of the port's model is the second witness for the
one-pass gradients.  ``export`` writes the JAX package's symbol JSON and
``SymbolBlock.imports`` gives the block's output back.  ``get_model``
takes both spellings of a name, and a model one package publishes to the
local weight store loads in the other.  Dropout is in eval mode or off:
random draws are never compared.

Tolerances: fp32 outputs within 1e-4 of the reference's largest |value|,
gradients within 1e-3 of theirs, moving statistics within 1e-5 (each plus
1e-7 for references at 0).
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import vision as jv
from mxnet_tpu.symbol.symbol import NameManager as JNames

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.convert import params_from_mxnet
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.block import SymbolBlock
from mxnet_tpu_torch.gluon.model_zoo import vision as tv
from mxnet_tpu_torch.symbol.symbol import NameManager as TNames

OUT_REL, GRAD_REL, STAT_REL, ABS = 1e-4, 1e-3, 1e-5, 1e-7


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)


def _close(got, ref, rel, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    bound = rel * float(np.abs(ref).max()) + ABS
    err = float(np.abs(got - ref).max())
    assert err <= bound, f"{what}: max err {err} > {bound}"


# family: (build(vision module, keywords), input (batch, px)); the port's
# builds take device="cpu".  Inputs keep every training-mode BatchNorm's
# statistics over 16 or more values: over 2 (batch 2 on a 1x1 map) the
# one-pass variance cancels, and the JAX package's own eager and compiled
# runs part by 2e-2 of the output
FAMILIES = {
    "resnet18_v2_thumbnail": (lambda v, kw: v.resnet18_v2(
        classes=10, thumbnail=True, prefix="z_", **kw), (2, 32)),
    "resnet_v2_bottleneck": (lambda v, kw: v.ResNetV2(
        v.BottleneckV2, [1, 1], [8, 16, 32], classes=10, prefix="z_", **kw),
        (2, 32)),
    "alexnet": (lambda v, kw: v.alexnet(classes=10, prefix="z_", **kw),
                (2, 67)),
    "vgg11_bn": (lambda v, kw: v.vgg11_bn(classes=10, prefix="z_", **kw),
                 (4, 32)),
    "squeezenet1_1": (lambda v, kw: v.squeezenet1_1(classes=10, prefix="z_",
                                                    **kw), (2, 69)),
    "mobilenet0_25": (lambda v, kw: v.mobilenet0_25(classes=10, prefix="z_",
                                                    **kw), (4, 64)),
    "mobilenet_v2_0_25": (lambda v, kw: v.mobilenet_v2_0_25(
        classes=10, prefix="z_", **kw), (4, 64)),
    "densenet_small": (lambda v, kw: v.DenseNet(16, 8, (2, 2), classes=10,
                                                prefix="z_", **kw), (2, 32)),
    "inception_v3": (lambda v, kw: v.inception_v3(classes=10, prefix="z_",
                                                  **kw), (1, 299)),
}
_BUILT = {}
# This file holds resnet18_v2; the other families have files of their own,
# tests/test_torch_vision_zoo_{mobilenet,classic,densenet,squeezenet,
# inception}.py, which import these helpers: each file stays under a
# minute on the CPU
HERE = ("resnet18_v2_thumbnail",)


def _images(batch, px, seed=0):
    return np.random.RandomState(seed).rand(batch, 3, px, px).astype(
        np.float32)


_NORM_RANGES = {"gamma": (0.75, 1.25), "beta": (0.0, 0.5),
                "running_mean": (-0.5, 0.5), "running_var": (0.5, 1.5)}


def _spread_norms(jnet, seed=1):
    """Every norm tensor drawn away from its initializer's constant: with
    gamma 1 and beta 0 a BatchNorm -> ReLU -> BatchNorm chain is invariant
    to the first gamma's scale, whose gradient is then 0 plus rounding
    noise (3e-2 of it between the JAX package's own eager and compiled
    runs)."""
    rng = np.random.RandomState(seed)
    for name, p in jnet.collect_params().items():
        role = name.rsplit("_", 2)
        role = "_".join(role[-2:]) if role[-2] == "running" else role[-1]
        if role in _NORM_RANGES:
            p.set_data(jmx.nd.array(rng.uniform(
                *_NORM_RANGES[role], p.shape).astype(np.float32)))


def _models(family):
    """``(jax net, port net, x)``: the port net allocated by a CPU forward,
    the JAX net shaped from it, its Xavier weights carried over; built
    once per family."""
    if family in _BUILT:
        return _BUILT[family]
    build, (batch, px) = FAMILIES[family]
    x = _images(batch, px)
    tnet = build(tv, {"device": "cpu"})
    tnet.initialize(ctx=tmx.cpu())
    tnet(tmx.nd.array(x))
    jmx.random.seed(0)
    jnet = build(jv, {})
    tparams = tnet.collect_params()
    assert sorted(jnet.collect_params()) == sorted(tparams)
    for name, p in jnet.collect_params().items():
        p.shape = tuple(tparams[name].shape)
    jnet.collect_params().initialize(jmx.init.Xavier())
    _spread_norms(jnet)
    params_from_mxnet({k: p.data().asnumpy() for k, p in
                       jnet.collect_params().items()}, tnet)
    jnet.hybridize()
    _BUILT[family] = (jnet, tnet, x)
    return _BUILT[family]


def eval_check(family):
    jnet, tnet, x = _models(family)
    ref = jnet(jmx.nd.array(x))
    got = tnet(tmx.nd.array(x))
    assert got.shape[1] == 10
    _close(got, ref, OUT_REL, family)


@pytest.mark.parametrize("family", HERE)
def test_zoo_eval_forward_matches_jax(family):
    eval_check(family)


def _dropouts(net):
    """Every Dropout layer of ``net`` (either package's)."""
    return [b for b in _blocks(net) if type(b).__name__ == "Dropout"]


def _blocks(block):
    children = getattr(block, "_children", None)
    if children is None:
        children = block._modules
    out = [block]
    for child in children.values():
        out += _blocks(child)
    return out


def _train_pass(pkg, net, x, head, gradients=True):
    with pkg.autograd.record():
        out = net(pkg.nd.array(x))
    grads = {}
    if gradients:
        out.backward(pkg.nd.array(head))
        grads = {k: p.grad().asnumpy() for k, p in
                 net.collect_params().items() if p.grad_req != "null"}
    stats = {k: p.data().asnumpy() for k, p in net.collect_params().items()
             if k.endswith(("running_mean", "running_var"))}
    return out.asnumpy(), grads, stats


def _with_dropout_off(jnet, tnet, fn):
    """``fn()`` with every Dropout rate at 0 (random draws are never
    compared) and the JAX net's compiled programs dropped first."""
    drops = _dropouts(jnet) + _dropouts(tnet)
    rates = [d._rate for d in drops]
    for d in drops:
        d._rate = 0.0
    jnet.hybridize()
    try:
        return fn()
    finally:
        for d, r in zip(drops, rates):
            d._rate = r
        jnet.hybridize()


def _shallow(nn, layers):
    net = nn.HybridSequential(prefix="z_")
    with net.name_scope():
        for add in layers:
            add(net)
    return net


def _mobilenet_v1_blocks(v, kw):
    nn, m = _NN[v], v.mobilenet
    return _shallow(nn, [
        lambda n: m._add_conv(n, 8, kernel=3, stride=2, pad=1),
        lambda n: m._add_conv_dw(n, 8, 16, 1),
        lambda n: m._add_conv_dw(n, 16, 16, 2),
        lambda n: n.add(nn.GlobalAvgPool2D(), nn.Flatten(), nn.Dense(10))])


def _mobilenet_v2_blocks(v, kw):
    nn, m = _NN[v], v.mobilenet
    return _shallow(nn, [
        lambda n: m._add_conv(n, 8, kernel=3, stride=2, pad=1, relu6=True),
        lambda n: n.add(m.LinearBottleneck(8, 8, 6, 1, prefix=""),
                        m.LinearBottleneck(8, 16, 6, 2, prefix="")),
        lambda n: m._add_conv(n, 32, relu6=True),
        lambda n: n.add(nn.GlobalAvgPool2D(),
                        nn.Conv2D(10, 1, use_bias=False), nn.Flatten())])


def _inception_cells(v, kw):
    nn, m = _NN[v], v.inception
    return _shallow(nn, [
        lambda n: n.add(m._conv(32, 3, 2, 0), m._make_A(8, "A1_"),
                        m._make_E("E1_")),
        lambda n: n.add(nn.GlobalAvgPool2D(), nn.Flatten(), nn.Dense(10))])


_NN = {jv: jnn, tv: tnn}
# The training-mode checks.  Families of 30 or more layers (VGG, the
# MobileNets, Inception) run as a few of their own blocks: in a training
# forward each BatchNorm divides by the batch's deviation, so the
# packages' rounding gap (1e-7 of a conv output) grows to 1e-4 of an
# activation by MobileNet's 20th layer, past OUT_REL, and an activation
# that close to a ReLU kink lies on its other side in one package, which
# moves the gradients behind it discontinuously (2e-2 of a layer's).
TRAIN_FAMILIES = dict(
    {f: FAMILIES[f] for f in ("resnet18_v2_thumbnail", "resnet_v2_bottleneck",
                              "alexnet", "squeezenet1_1", "densenet_small")},
    vgg_bn_blocks=(lambda v, kw: v.VGG([1, 1, 1], [8, 16, 16],
                                       batch_norm=True, classes=10,
                                       prefix="z_", **kw), (4, 32)),
    mobilenet_v1_blocks=(_mobilenet_v1_blocks, (4, 32)),
    mobilenet_v2_blocks=(_mobilenet_v2_blocks, (4, 32)),
    inception_cells=(_inception_cells, (2, 35)))
ZERO_REL = 1e-5


def train_check(family, monkeypatch, gradients=True):
    """A training-mode forward (and backward) of ``TRAIN_FAMILIES[family]``
    with the dropout rates at 0: the output (batch statistics), every
    moving statistic after it and every learnable parameter's gradient.
    The gradients are compared under the centred variance
    (``MXNET_TPU_FAST_VARIANCE=0`` in both packages): under the default
    one-pass variance the JAX package's gradients lie up to 5.2e-2 of a
    tensor's largest from the float64 gradients (:func:`one_pass_check`
    holds the port's to those).  A gradient
    that is 0 up to rounding in the JAX package (below ZERO_REL of the
    model's largest, as a conv bias before a BatchNorm) must be so in the
    port too."""
    if family not in _BUILT:
        build, shape = TRAIN_FAMILIES[family]
        FAMILIES[family] = (build, shape)
    jnet, tnet, x = _models(family)
    if gradients:
        monkeypatch.setenv("MXNET_TPU_FAST_VARIANCE", "0")
    head = _head(x)
    (jo, jg, js), (to, tg, ts) = _with_dropout_off(jnet, tnet, lambda: (
        _train_pass(jmx, jnet, x, head, gradients),
        _train_pass(tmx, tnet, x, head, gradients)))
    _close(to, jo, OUT_REL, "train output")
    assert sorted(tg) == sorted(jg) and sorted(ts) == sorted(js)
    scale = max((np.abs(g).max() for g in jg.values()), default=0.0)
    for k in jg:
        if np.abs(jg[k]).max() < ZERO_REL * scale:
            assert np.abs(tg[k]).max() < 10 * ZERO_REL * scale, k
        else:
            _close(tg[k], jg[k], GRAD_REL, k)
    for k in js:
        _close(ts[k], js[k], STAT_REL, k)


def _head(x):
    return np.random.RandomState(3).randn(x.shape[0], 10).astype(np.float32)


TRAIN_HERE = HERE


@pytest.mark.parametrize("family", TRAIN_HERE)
def test_zoo_train_gradients_and_moving_stats_match_jax(family, monkeypatch):
    train_check(family, monkeypatch)


@pytest.mark.parametrize("family", HERE)
def test_zoo_train_forward_one_pass_variance_matches_jax(family,
                                                         monkeypatch):
    """The default one-pass variance in a training-mode forward: the
    output and the moving statistics."""
    train_check(family, monkeypatch, gradients=False)


def _bn_float64(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                fix_gamma=True, axis=1, training=True):
    """BatchNorm with its batch statistics in ``data``'s dtype (the port's
    op takes them in fp32): the float64 reference's."""
    red = tuple(i for i in range(data.dim()) if i != axis)
    bshape = [1] * data.dim()
    bshape[axis] = data.shape[axis]
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if training:
        mean = data.mean(dim=red)
        var = (data - mean.reshape(bshape)).square().mean(dim=red)
    else:
        mean, var = moving_mean, moving_var
    out = ((data - mean.reshape(bshape)) * torch.rsqrt(var + eps).reshape(
        bshape) * g.reshape(bshape) + beta.reshape(bshape))
    return out, mean.to(moving_mean.dtype), var.to(moving_var.dtype)


def _float64_gradients(family, monkeypatch):
    """The gradients of :func:`train_check`'s pass computed in float64:
    the port's model of ``family`` rebuilt with the same weights, every
    tensor in float64, its BatchNorm statistics too."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.ndarray.ndarray import NDArray
    from mxnet_tpu_torch.ops import nn as ops_nn
    _, tnet, x = _models(family)
    build, _ = FAMILIES[family]
    net = build(tv, {"device": "cpu"})
    net.initialize(ctx=tmx.cpu())
    net(tmx.nd.array(x))
    params_from_mxnet({k: p.data().asnumpy() for k, p in
                       tnet.collect_params().items()}, net)
    net.double()
    for d in _dropouts(net):
        d._rate = 0.0
    monkeypatch.setattr(ops_nn, "batch_norm", _bn_float64)

    def f64(a):
        return NDArray(torch.from_numpy(a.astype(np.float64)), tmx.cpu())
    with autograd.record():
        out = net(f64(x))
    assert out._data.dtype == torch.float64
    out.backward(f64(_head(x)))
    return {k: p.grad()._data.numpy() for k, p in
            net.collect_params().items() if p.grad_req != "null"}


def one_pass_check(family, monkeypatch):
    """The gradients of :func:`train_check`'s pass under the default
    one-pass variance, held to a second witness: the float64 gradients
    of the same model (:func:`_float64_gradients`).  Each tensor's fp32
    gradient in the port lies within GRAD_REL of its largest float64
    value, and the port's worst such distance is no larger than the JAX
    package's (its compiled run, as :func:`train_check` runs it), up to
    1e-6 of rounding.  Measured on the CPU (PERF.md): the port 6.9e-7
    to 1.2e-4, the JAX package 7.6e-7 to 5.2e-2 (resnet18_v2's stage 4,
    and 2.4e-2 in Inception's E cell)."""
    jnet, tnet, x = _models(family)
    ref = _float64_gradients(family, monkeypatch)
    monkeypatch.undo()
    monkeypatch.setenv("MXNET_TPU_FAST_VARIANCE", "1")
    (_, jg, _), (_, tg, _) = _with_dropout_off(jnet, tnet, lambda: (
        _train_pass(jmx, jnet, x, _head(x)),
        _train_pass(tmx, tnet, x, _head(x))))
    assert sorted(ref) == sorted(tg) == sorted(jg)
    scale = max(np.abs(g).max() for g in ref.values())
    worst = {"port": 0.0, "jax": 0.0}
    for k, want in ref.items():
        top = float(np.abs(want).max())
        if top < ZERO_REL * scale:
            assert np.abs(tg[k]).max() < 10 * ZERO_REL * scale, k
            continue
        for who, got in (("port", tg[k]), ("jax", jg[k])):
            worst[who] = max(worst[who],
                             float(np.abs(got - want).max()) / top)
        err = float(np.abs(tg[k] - want).max())
        assert err <= GRAD_REL * top, f"{k}: max err {err} > {GRAD_REL * top}"
    assert worst["port"] <= worst["jax"] + 1e-6, worst


@pytest.mark.parametrize("family", TRAIN_HERE)
def test_zoo_train_gradients_one_pass_variance_against_float64(family,
                                                               monkeypatch):
    one_pass_check(family, monkeypatch)


def export_check(family, tmp_path):
    """``export`` writes the JAX package's symbol JSON (Inception's
    concurrent cells and DenseNet's concatenations included), and
    ``SymbolBlock.imports`` of the port's files gives the block's eval
    output."""
    jnet, tnet, x = _models(family)
    want = tnet(tmx.nd.array(x))
    jnet(jmx.nd.array(x))
    TNames.reset()
    tnet.export(str(tmp_path / "t"))
    JNames.reset()
    jnet.export(str(tmp_path / "j"))
    with open(tmp_path / "t-symbol.json") as a, \
            open(tmp_path / "j-symbol.json") as b:
        assert json.load(a) == json.load(b)
    imported = SymbolBlock.imports(str(tmp_path / "t-symbol.json"), ["data"],
                                   str(tmp_path / "t-0000.params"),
                                   ctx=tmx.cpu())
    _close(imported(tmx.nd.array(x)), want, OUT_REL, "imported")


@pytest.mark.parametrize("family", HERE)
def test_zoo_export_imports_and_matches_jax_json(family, tmp_path):
    export_check(family, tmp_path)


def test_resnet_v2_first_batch_norm_takes_no_gradient():
    """ResNet v2's first BatchNorm has ``scale=False, center=False``: its
    gamma and beta take no gradient and a training step leaves them (at 1
    and 0) as they were, as in the JAX package."""
    jnet, tnet, _ = _models("resnet18_v2_thumbnail")
    first = tnet.features[0]
    for name in ("gamma", "beta"):
        key = f"z_batchnorm0_{name}"
        assert tnet.collect_params()[key].grad_req == "null"
        assert jnet.collect_params()[key].grad_req == "null"
        assert not getattr(first, name).requires_grad
    from mxnet_tpu_torch import optimizer
    from mxnet_tpu_torch.executor import CompiledTrainStep
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    net = tv.resnet18_v2(classes=10, thumbnail=True, device="cpu")
    net.initialize(tmx.init.Xavier())
    step = CompiledTrainStep(net, SoftmaxCrossEntropyLoss(),
                             optimizer.create("sgd", learning_rate=0.5))
    before = net.features[0].gamma.detach().clone()
    step(torch.from_numpy(_images(2, 32)), torch.tensor([1.0, 3.0]))
    assert torch.equal(net.features[0].gamma, before)
    assert torch.equal(net.features[0].beta,
                       torch.zeros_like(net.features[0].beta))


def test_densenet_dropout_draws_in_training_only():
    """A dense layer's dropout is the identity in evaluation and draws a
    mask in training, on tensors too (from the device's stream)."""
    net = tv.DenseNet(8, 4, (1,), dropout=0.5, classes=3, prefix="d_")
    net.initialize(ctx=tmx.cpu())
    x = torch.from_numpy(_images(2, 16))
    net.eval()
    with torch.no_grad():
        a, b = net(x), net(x)
    assert torch.equal(a, b)
    net.train()
    with torch.no_grad():
        c, d = net(x), net(x)
    assert not torch.equal(c, d)


@pytest.mark.parametrize("ref,canon", [
    ("mobilenetv2_0.25", "mobilenet_v2_0_25"),
    ("mobilenet0.25", "mobilenet0_25"), ("squeezenet1.1", "squeezenet1_1"),
    ("inceptionv3", "inception_v3"), ("ResNet18_V2", "resnet18_v2")])
def test_get_model_takes_both_spellings(ref, canon):
    a = tv.get_model(ref, classes=5, prefix="g_", device="cpu")
    b = tv.get_model(canon, classes=5, prefix="g_", device="cpu")
    j = jv.get_model(ref, classes=5, prefix="g_")
    assert type(a) is type(b)
    assert type(a).__name__ == type(j).__name__
    assert sorted(a.collect_params()) == sorted(j.collect_params())
    assert sorted(tv._models) == sorted(jv._models)
    with pytest.raises(ValueError, match="not found"):
        tv.get_model("resnet19_v2")


def test_get_model_device_places_deferred_parameters():
    """``device=`` initializes the deferred parameters there: the first
    forward allocates them on that device, and a later ``initialize``
    with another initializer still takes effect."""
    net = tv.get_model("mobilenet0_25", classes=4, device="cpu")
    net.initialize(tmx.init.Constant(0.5))
    net(tmx.nd.array(_images(1, 32)))
    w = net.output.weight
    assert w.device.type == "cpu" and torch.all(w == 0.5)
