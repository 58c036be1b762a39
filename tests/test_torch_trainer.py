"""Port parity: the canonical Gluon training loop against mxnet_tpu's, on
the CPU:

    with autograd.record(): l = loss(net(x), y)
    l.backward()
    trainer.step(batch_size)

Both packages run 3 steps from the same weights (copied by name with
``convert.params_from_mxnet``) on the same seeded batches, and every
step's losses, parameters, BatchNorm moving statistics and optimizer
states are compared.

Tolerances, against the reference's value:

- ``train_mnist.py``'s net (no BatchNorm), fp32: losses and every
  parameter within 1e-5 of the tensor's largest |value| (XLA and PyTorch
  sum convolutions and products in other orders), after each of the 3
  steps, each package running on from its own state.  Under Adam a
  parameter may also differ by ADAM_LR_SHARE of the learning rate: the
  step ``lr·m/(sqrt(v) + eps)`` divides each gradient by its own size, so
  a small gradient's relative rounding difference (about 1e-3 where the
  gradient is 1e-4 of the tensor's largest) becomes that share of lr
  (measured: at most 8.2e-4);
- the small fused ResNetV1, fp32: the loss within 1e-4 of itself, every
  parameter, moving statistic and momentum within 3e-3 of its tensor's
  largest |value| plus 1e-6, each step starting from the reference's
  state, as in ``tests/test_torch_resnet.py``.  BatchNorm over the 4
  values per channel of the last stage makes the step ill-conditioned
  (see that file's docstring): from the reference's state after the
  first step, a float64 run of the port puts the second step's gradients
  up to 1.7e-3 (port) and 2.3e-3 (reference) of their tensor's largest
  |value| away, and the loss 1.0e-5 and 1.2e-5; the packages then differ
  by up to 1.7e-3 (a momentum) and 1.6e-5 (the loss), measured;
- the port's Gluon loop against its own ``CompiledTrainStep``, and the
  mixed-precision SGD update against the reference's: bit for bit.  A batch of 4 makes the mean loss's head gradient 1/4, a power of
  two, so the backward of the sum scaled by ``rescale_grad = 1/4`` is the
  same arithmetic.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jg
from mxnet_tpu import lr_scheduler as jls
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon as tg
from mxnet_tpu_torch import lr_scheduler as tls
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.convert import params_from_mxnet
from mxnet_tpu_torch.executor import CompiledTrainStep
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres

REL = 1e-5
ADAM_LR_SHARE = 2e-3
STEP_REL, STEP_ABS, STEP_LOSS_REL = 3e-3, 1e-6, 1e-4
BATCH = 4
ADAM_LR = 0.01
RESNET = ([1, 1, 1, 1], [8, 16, 32, 64, 128])


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = mx.set_default_context(mx.cpu())
    yield
    mx.set_default_context(prev)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x,
                      np.float32)


def _close(got, ref, rel=REL, atol=0.0, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    bound = rel * float(np.abs(ref).max()) + atol
    err = float(np.abs(got - ref).max())
    assert err <= bound, f"{what}: max err {err} > {bound}"


def _params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def mnist_net(g):
    """``examples/image_classification/train_mnist.py``'s ``build_net``."""
    net = g.nn.Sequential(prefix="mnist_")
    with net.name_scope():
        net.add(g.nn.Conv2D(32, 3, padding=1, activation="relu"),
                g.nn.MaxPool2D(2),
                g.nn.Conv2D(64, 3, padding=1, activation="relu"),
                g.nn.MaxPool2D(2),
                g.nn.Flatten(),
                g.nn.Dense(128, activation="relu"),
                g.nn.Dense(10))
    return net


def _batch(seed, shape=(1, 28, 28), classes=10):
    rng = np.random.RandomState(100 + seed)
    return (rng.rand(BATCH, *shape).astype(np.float32),
            rng.randint(0, classes, BATCH).astype(np.float32))


def _mnist_pair():
    jnet, tnet = mnist_net(jg), mnist_net(tg)
    jnet.initialize()
    tnet.initialize()
    x, _ = _batch(0)
    jnet(jnd.array(x))
    tnet(tnd.array(x))
    params_from_mxnet(_params(jnet), tnet)
    return jnet, tnet


def _step(g, ag, nd, net, trainer, loss_fn, x, y):
    with ag.record():
        loss = loss_fn(net(nd.array(x)), nd.array(y))
    loss.backward()
    trainer.step(BATCH)
    return loss.asnumpy()


# ---------------------------------------------------------------------------
# train_mnist.py's loop
# ---------------------------------------------------------------------------
def _optimizer(case, ls):
    if case == "adam":
        return "adam", {"learning_rate": ADAM_LR, "wd": 1e-4}
    kw = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    if case == "factor_scheduler":
        kw["lr_scheduler"] = ls.FactorScheduler(step=1, factor=0.5)
    return "sgd", kw


@pytest.mark.parametrize("case", ["sgd", "adam", "grad_req_add",
                                  "factor_scheduler"])
def test_mnist_loop_matches_jax(case):
    """3 steps of SGD (momentum 0.9, wd 1e-4), Adam, SGD with every
    ``grad_req='add'`` (gradients accumulate over the steps) and SGD under
    a ``FactorScheduler`` halving the rate every update."""
    nets = _mnist_pair()
    runs = []
    for net, g, ag, nd, ls in zip(nets, (jg, tg), (jag, tag), (jnd, tnd),
                                  (jls, tls)):
        if case == "grad_req_add":
            net.collect_params().setattr("grad_req", "add")
        name, kw = _optimizer(case, ls)
        runs.append((net, g, ag, nd, g.Trainer(net.collect_params(), name,
                                               kw),
                     g.loss.SoftmaxCrossEntropyLoss()))
    for step in range(3):
        x, y = _batch(step)
        (jloss, jlr), (tloss, tlr) = [
            (_step(g, ag, nd, net, tr, lf, x, y), tr.learning_rate)
            for net, g, ag, nd, tr, lf in runs]
        _close(tloss, jloss, what=f"step {step} loss")
        assert tlr == jlr, (step, tlr, jlr)
        atol = ADAM_LR_SHARE * ADAM_LR if case == "adam" else 0.0
        for (name, ref), got in zip(_params(runs[0][0]).items(),
                                    _params(runs[1][0]).values()):
            _close(got, ref, atol=atol, what=f"step {step} {name}")
    if case == "factor_scheduler":
        assert runs[1][4].learning_rate == 0.1 * 0.5 ** 2


# ---------------------------------------------------------------------------
# the small fused ResNetV1
# ---------------------------------------------------------------------------
def _resnet_pair(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_FUSE_CONV_BN", "1")
    tnet = tres.ResNetV1(tres.BottleneckV1, *RESNET, classes=10,
                         ctx=mx.cpu(), prefix="rn_")
    jnet = jres.ResNetV1(jres.BottleneckV1, *RESNET, classes=10,
                         prefix="rn_")
    for p, t in zip(jnet.collect_params().values(),
                    tnet.collect_params().values()):
        # the input widths a first forward would infer (no eager compiles)
        p.shape = t.shape
    jnet.initialize()
    tnet.initialize()
    params_from_mxnet(_params(jnet), tnet)
    return jnet, tnet


def _sgd(g, net):
    return g.Trainer(net.collect_params(), "sgd",
                     {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})


def test_fused_resnet_loop_matches_jax(monkeypatch):
    """3 SGD steps of ResNetV1(BottleneckV1, [1, 1, 1, 1],
    [8, 16, 32, 64, 128], classes=10) built fused (the fused op's plain
    version is on the Gluon path) at 32 px, fp32: each step's loss, every
    parameter, moving statistic and momentum."""
    jnet, tnet = _resnet_pair(monkeypatch)
    assert sum(isinstance(m, tg.contrib.nn.FusedConv1x1BN)
               for m in tnet.modules()) == 12
    jtr, ttr = _sgd(jg, jnet), _sgd(tg, tnet)
    jce, tce = jg.loss.SoftmaxCrossEntropyLoss(), \
        tg.loss.SoftmaxCrossEntropyLoss()
    names = list(jnet.collect_params())
    for step in range(3):
        if step:
            # start from the reference's state (see the module docstring)
            params_from_mxnet(_params(jnet), tnet)
            for i, state in jtr._updaters[0].states.items():
                ttr._updaters[0].states[i].copy_(
                    torch.from_numpy(state.asnumpy().copy()))
        x, y = _batch(step, (3, 32, 32))
        jloss = _step(jg, jag, jnd, jnet, jtr, jce, x, y)
        tloss = _step(tg, tag, tnd, tnet, ttr, tce, x, y)
        _close(tloss, jloss, STEP_LOSS_REL, what=f"step {step} loss")
        for (name, ref), got in zip(_params(jnet).items(),
                                    _params(tnet).values()):
            _close(got, ref, STEP_REL, STEP_ABS, what=f"step {step} {name}")
        assert sorted(ttr._updaters[0].states) == sorted(
            jtr._updaters[0].states)
        for i, ref in jtr._updaters[0].states.items():
            _close(ttr._updaters[0].states[i], ref, STEP_REL, STEP_ABS,
                   what=f"step {step} momentum {names[i]}")


def test_gluon_update_equals_compiled_train_step(monkeypatch):
    """The port's Gluon loop and its ``CompiledTrainStep`` from the same
    weights: two steps give the same parameters, moving statistics and
    momenta, bit for bit (see the module docstring)."""
    monkeypatch.setenv("MXNET_TPU_FUSE_CONV_BN", "1")
    nets = [tres.ResNetV1(tres.BottleneckV1, *RESNET, classes=10,
                          ctx=mx.cpu()) for _ in range(2)]
    nets[0].initialize(mx.init.Xavier(magnitude=2))
    nets[1].load_state_dict(nets[0].state_dict())
    trainer = _sgd(tg, nets[0])
    loss_fn = tg.loss.SoftmaxCrossEntropyLoss()
    step = CompiledTrainStep(nets[1], loss_fn,
                             topt.create("sgd", learning_rate=0.1,
                                         momentum=0.9, wd=1e-4),
                             batch_size=BATCH)
    for i in range(2):
        x, y = _batch(i, (3, 32, 32))
        loss = _step(tg, tag, tnd, nets[0], trainer, loss_fn, x, y)
        mean = step(torch.from_numpy(x), torch.from_numpy(y))
        assert float(mean) == float(torch.tensor(loss).mean())
        for (key, got), ref in zip(nets[0].state_dict().items(),
                                   nets[1].state_dict().values()):
            assert torch.equal(got, ref), (i, key)
        learnable = [j for j, p in enumerate(
            nets[0].collect_params().values()) if p.grad_req != "null"]
        assert len(learnable) == len(step._states)
        for j, mom in zip(learnable, step._states):
            assert torch.equal(trainer._updaters[0].states[j], mom), (i, j)


def test_save_and_load_states_round_trip(tmp_path):
    """``save_states`` -> ``load_states`` restores every momentum, and a
    trainer that loaded them takes the same next step as the one that
    saved them."""
    net = mnist_net(tg)
    net.initialize()
    trainer = _sgd(tg, net)
    loss_fn = tg.loss.SoftmaxCrossEntropyLoss()
    for i in range(2):
        _step(tg, tag, tnd, net, trainer, loss_fn, *_batch(i))
    trainer.save_states(str(tmp_path / "states"))
    again = _sgd(tg, net)
    again.load_states(str(tmp_path / "states"))
    saved = trainer._updaters[0].states
    assert sorted(again._updaters[0].states) == sorted(saved)
    for i, mom in saved.items():
        assert torch.equal(again._updaters[0].states[i], mom)
    start = {k: v.clone() for k, v in net.state_dict().items()}
    x, y = _batch(2)
    _step(tg, tag, tnd, net, trainer, loss_fn, x, y)
    first = {k: v.clone() for k, v in net.state_dict().items()}
    net.load_state_dict(start)
    _step(tg, tag, tnd, net, again, loss_fn, x, y)
    for key, value in net.state_dict().items():
        assert torch.equal(value, first[key]), key


def test_updater_multi_precision_matches_jax():
    """``get_updater`` over SGD with momentum and ``multi_precision`` on an
    fp16 weight: three updates through the fp32 master copy give the
    reference's fp16 weight, fp32 copy and momentum (the same arithmetic,
    so exactly)."""
    from mxnet_tpu import optimizer as jopt
    rng = np.random.RandomState(12)
    w = rng.uniform(-0.1, 0.1, (16, 8)).astype(np.float16)
    grads = [rng.randn(16, 8).astype(np.float16) for _ in range(3)]
    kw = dict(learning_rate=0.1, momentum=0.9, wd=1e-3, rescale_grad=0.5,
              multi_precision=True)
    jup = jopt.get_updater(jopt.create("sgd", **kw))
    tup = topt.get_updater(topt.create("sgd", **kw))
    jw, tw = jnd.array(w, dtype="float16"), tnd.array(w, dtype="float16")
    for g in grads:
        jup(0, jnd.array(g, dtype="float16"), jw)
        tup(0, tnd.array(g, dtype="float16"), tw)
    assert str(tw.dtype) == "float16"
    np.testing.assert_array_equal(tw.asnumpy(), jw.asnumpy())
    (tmom, tw32), (jmom, jw32) = tup.states[0], jup.states[0]
    np.testing.assert_array_equal(tw32.numpy(), jw32.asnumpy())
    np.testing.assert_array_equal(tmom.numpy(), jmom.asnumpy())
    assert tup.optimizer.num_update == jup.optimizer.num_update == 3


def test_set_learning_rate_matches_jax():
    for g, ls in ((jg, jls), (tg, tls)):
        net = g.nn.Dense(2, in_units=2)
        net.initialize()
        trainer = _sgd(g, net)
        trainer.set_learning_rate(0.05)
        assert trainer.learning_rate == 0.05
        scheduled = g.Trainer(net.collect_params(), "sgd", {
            "learning_rate": 0.2,
            "lr_scheduler": ls.FactorScheduler(step=2, factor=0.5)})
        assert scheduled.learning_rate == 0.2
        with pytest.raises(UserWarning):
            scheduled.set_learning_rate(0.1)


# ---------------------------------------------------------------------------
# the example itself
# ---------------------------------------------------------------------------
EXAMPLE = (Path(__file__).resolve().parents[1] / "examples"
           / "image_classification" / "train_mnist.py")


@pytest.mark.parametrize("compiled", [False, True], ids=["trainer",
                                                         "compiled_step"])
def test_train_mnist_example_runs_on_the_port(compiled, monkeypatch, capsys):
    """``train_mnist.py`` with only its imports of the JAX package pointed
    at the port (and the CPU as the default context) trains an epoch of
    its synthetic data through ``gluon.Trainer`` or ``CompiledTrainStep``
    and reports a validation accuracy."""
    source = EXAMPLE.read_text()
    ported = source.replace("mxnet_tpu", "mxnet_tpu_torch")
    changed = [b for a, b in zip(source.splitlines(), ported.splitlines())
               if a != b]
    assert changed and all(line.lstrip().startswith(("import ", "from "))
                           for line in changed)
    module = {"__name__": "train_mnist_on_the_port",
              "__file__": str(EXAMPLE)}
    exec(compile(ported, str(EXAMPLE), "exec"), module)
    argv = ["train_mnist.py", "--synthetic", "--epochs", "1"]
    monkeypatch.setattr(sys, "argv", argv + ["--compiled"] * compiled)
    assert module["main"]() == 0
    out = capsys.readouterr().out
    accuracy = float(out.split("val accuracy=")[1].split()[0])
    assert 0.0 <= accuracy <= 1.0
