"""Port parity: all 17 registered optimizers against mxnet_tpu's, on the
CPU, from the same seeded numpy inputs.

For each name:

- the port's eager optimizer against the JAX one over 5 updates of two
  parameters, with weight decay, gradient rescale and clip, and an lr
  multiplier on the first: every weight and state after each update;
- the port's ``CompiledTrainStep`` (eager on the CPU, reading the step's
  lr and count as 0-dim tensors, as its graph does on the card) against
  the JAX package's eager ``gluon.Trainer`` loop, 3 steps of a
  Dense + BatchNorm + Dense net from the same weights on the same
  batches: every parameter and moving statistic after each step.  The JAX
  compiled step cannot be the oracle: it cannot trace LARS or SGLD and
  freezes Nadam's and LBSGD's host scalars at the trace;
- ``Updater.get_states`` / ``set_states`` across the packages both ways,
  for every state shape (FTML's triple, DCASGD's ``(None, prev)``,
  RMSProp's centered triple).

SGLD's noise is made zero in both packages by a patch here (no file of
the JAX package changes); a separate test holds the port's noise to
N(0, lr): the variance of 2**16 draws within 5% of lr (the standard
error of a sample variance is lr·sqrt(2/n) = 0.55% of lr), its mean
within 5 standard errors of 0.  No random draws are compared.

Tolerance, as ``tests/test_torch_trainer.py`` states it: within 1e-5 of
each tensor's largest |value| (1e-6 for the eager updates, which run the
same arithmetic on the same inputs), and for the optimizers that divide
by a running size of the gradient (and Signum, which takes its sign) also
within ADAPTIVE_LR_SHARE of the learning rate per element: a gradient
near zero carries its rounding difference (XLA and PyTorch sum the
forward's products in other orders) into a step of up to lr.  The batch
of 8 makes the mean loss's head gradient a power of two, so the port's
mean and the JAX package's sum times ``rescale_grad = 1/8`` differ only
in those sums.
"""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jg
from mxnet_tpu import lr_scheduler as jls
from mxnet_tpu import optimizer as jopt

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon as tg
from mxnet_tpu_torch import lr_scheduler as tls
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.convert import params_from_mxnet
from mxnet_tpu_torch.executor import CompiledTrainStep

NAMES = ["sgd", "nag", "signum", "ftml", "dcasgd", "sgld", "adam", "adamw",
         "adagrad", "adadelta", "rmsprop", "ftrl", "adamax", "nadam", "lars",
         "lbsgd", "lamb"]
ADAPTIVE = {"signum", "ftml", "adam", "adamw", "adagrad", "adadelta",
            "rmsprop", "adamax", "nadam", "lamb", "ftrl"}
ADAPTIVE_LR_SHARE = 2e-3
LR = 0.05
BATCH = 8


def _kwargs(name, sched):
    """Each optimizer's options: its momentum-like knobs on, LBSGD with a
    warmup that moves every step and a FactorScheduler (``sched`` is the
    package's lr_scheduler module)."""
    kw = dict(learning_rate=LR, wd=0.01, clip_gradient=0.5)
    extra = {"sgd": dict(momentum=0.9), "nag": dict(momentum=0.9),
             "signum": dict(momentum=0.9, wd_lh=0.01),
             "dcasgd": dict(momentum=0.9), "lars": dict(momentum=0.9,
                                                        eta=0.01),
             "rmsprop": dict(centered=True, clip_weights=2.0),
             "lbsgd": dict(momentum=0.9, warmup_epochs=1,
                           updates_per_epoch=4, batch_scale=4,
                           lr_scheduler=sched.FactorScheduler(2, 0.5))}
    kw.update(extra.get(name, {}))
    return kw


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)


@pytest.fixture(autouse=True)
def _quiet_sgld(monkeypatch):
    """SGLD's noise set to zero in both packages."""
    import mxnet_tpu.ndarray.random as jrandom

    import mxnet_tpu_torch.optimizer.optimizer as toptmod

    def zeros(loc=0, scale=1, shape=None, dtype="float32", ctx=None, **kw):
        return jmx.nd.zeros(shape, ctx, dtype=dtype)
    monkeypatch.setattr(jrandom, "normal", zeros)
    monkeypatch.setattr(toptmod, "_sgld_noise",
                        lambda weight, lr: torch.zeros_like(weight))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.asnumpy(), np.float32)


def _close(got, ref, rel, what, abs_=0.0):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref)
    bound = rel * float(np.abs(ref).max()) + abs_
    assert float(err.max()) <= bound, \
        f"{what}: max err {float(err.max())} > {bound}"


def _state_leaves(state):
    """The arrays of a state (None, an array or a tuple), None kept."""
    if isinstance(state, tuple):
        return [x for s in state for x in _state_leaves(s)]
    return [state]


# ------------------------------------------------------------ eager update
@pytest.mark.parametrize("name", NAMES)
def test_eager_updates_match_jax(name):
    rng = np.random.RandomState(len(name))
    shapes = [(6, 5), (5,)]
    ws = [rng.randn(*s).astype(np.float32) for s in shapes]
    jo = jopt.create(name, rescale_grad=0.5, **_kwargs(name, jls))
    to = topt.create(name, rescale_grad=0.5, **_kwargs(name, tls))
    for o in (jo, to):
        o.set_lr_mult({0: 2.0})
    jw = [jmx.nd.array(w) for w in ws]
    tw = [torch.tensor(w) for w in ws]
    jst = [jo.create_state(i, w) for i, w in enumerate(jw)]
    tst = [to.create_state(i, w) for i, w in enumerate(tw)]
    for step in range(5):
        for i, s in enumerate(shapes):
            g = rng.randn(*s).astype(np.float32)
            jo.update(i, jw[i], jmx.nd.array(g), jst[i])
            to.update(i, tw[i], torch.tensor(g), tst[i])
            _close(tw[i], jw[i], 1e-6, f"{name} step {step} weight {i}")
            for j, (a, b) in enumerate(zip(_state_leaves(tst[i]),
                                           _state_leaves(jst[i]))):
                assert (a is None) == (b is None)
                if a is not None:
                    _close(a, b, 1e-6, f"{name} step {step} state {i}.{j}")
    assert to.num_update == jo.num_update == 5


# ------------------------------------------------------------------- step
def _net(g, device=None):
    kw = {} if device is None else {"device": device}
    net = g.nn.HybridSequential(prefix="optnet_")
    with net.name_scope():
        # no bias before the BatchNorm: BN cancels it, so its gradient
        # would be rounding noise, which the adaptive steps scale up to lr
        net.add(g.nn.Dense(8, in_units=6, use_bias=False, **kw),
                g.nn.BatchNorm(in_channels=8, **kw),
                g.nn.Activation("relu"),
                g.nn.Dense(3, in_units=8, **kw))
    return net


def _pair(seed):
    jnet = _net(jg)
    jnet.initialize(jmx.init.Xavier())
    tnet = _net(tg, device="cpu")
    tnet.initialize(tmx.init.Xavier())
    rng = np.random.RandomState(seed)
    params = {k: rng.randn(*p.shape).astype(np.float32) * 0.5
              for k, p in jnet.collect_params().items()}
    for k, p in jnet.collect_params().items():
        if "running" in k or "moving" in k:
            params[k] = np.abs(params[k]) + (1.0 if "var" in k else 0.0)
        p.set_data(jmx.nd.array(params[k]))
    params_from_mxnet(params, tnet)
    return jnet, tnet


@pytest.mark.parametrize("name", NAMES)
def test_compiled_step_matches_jax_trainer(name):
    jnet, tnet = _pair(len(name))
    trainer = jg.Trainer(jnet.collect_params(), name, _kwargs(name, jls))
    step = CompiledTrainStep(tnet, tg.loss.L2Loss(),
                             topt.create(name, **_kwargs(name, tls)),
                             batch_size=BATCH)
    jloss = jg.loss.L2Loss()
    rng = np.random.RandomState(100 + len(name))
    abs_ = ADAPTIVE_LR_SHARE * LR if name in ADAPTIVE else 0.0
    for k in range(3):
        x = rng.randn(BATCH, 6).astype(np.float32)
        y = rng.randn(BATCH, 3).astype(np.float32)
        with jag.record():
            loss = jloss(jnet(jmx.nd.array(x)), jmx.nd.array(y))
        loss.backward()
        trainer.step(BATCH)
        tl = step(torch.tensor(x), torch.tensor(y))
        np.testing.assert_allclose(float(tl), float(loss.mean().asnumpy()),
                                   rtol=1e-5)
        tparams = tnet.collect_params()
        for key, p in jnet.collect_params().items():
            _close(tparams[key].data(), p.data(), 1e-5,
                   f"{name} step {k + 1} {key}", abs_)
    assert step._num_update == 3


# ---------------------------------------------------------------- updater
def _updater_states(pkg, name, ws, grads):
    """An Updater of ``pkg`` after two updates of each weight."""
    mx = jmx if pkg == "jax" else tmx
    opt = (jopt if pkg == "jax" else topt).create(
        name, **dict(_kwargs(name, jls if pkg == "jax" else tls),
                     **({"momentum": 0.0} if name == "dcasgd" else {})))
    up = (jopt if pkg == "jax" else topt).get_updater(opt)
    arrays = [mx.nd.array(w) for w in ws]
    for g in grads:
        for i, w in enumerate(arrays):
            up(i, mx.nd.array(g[i]), w)
    return up


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("name", NAMES)
def test_updater_states_cross_packages(name, direction):
    rng = np.random.RandomState(7)
    ws = [rng.randn(4, 3).astype(np.float32), rng.randn(3).astype(np.float32)]
    grads = [[rng.randn(*w.shape).astype(np.float32) for w in ws]
             for _ in range(2)]
    src, dst = (("port", "jax") if direction == "port_to_jax"
                else ("jax", "port"))
    a = _updater_states(src, name, ws, grads)
    b = (jopt if dst == "jax" else topt).get_updater(
        (jopt if dst == "jax" else topt).create(name))
    b.set_states(a.get_states())
    assert sorted(b.states) == sorted(a.states) == [0, 1]
    for i in (0, 1):
        la, lb = _state_leaves(a.states[i]), _state_leaves(b.states[i])
        assert len(la) == len(lb)
        assert isinstance(a.states[i], tuple) == \
            isinstance(b.states[i], tuple)
        for x, y in zip(la, lb):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(_np(x), _np(y))
    # the blob round-trips through pickle in the destination too
    pickle.loads(b.get_states())


def test_sgld_noise_is_n0_lr(monkeypatch):
    """The port's SGLD noise, from the device's stream: zero gradient and
    decay, so each update moves the weight by the noise alone."""
    monkeypatch.undo()
    n, lr = 1 << 16, 0.01
    tmx.random.seed(3)
    opt = topt.create("sgld", learning_rate=lr)
    w = torch.zeros(n)
    opt.update(0, w, torch.zeros(n), None)
    first = w.clone()
    var = float(first.double().var())
    assert abs(var - lr) <= 0.05 * lr, var
    assert abs(float(first.double().mean())) <= 5 * (lr / n) ** 0.5
    opt.update(0, w, torch.zeros(n), None)
    assert not torch.equal(w - first, first)      # fresh draws


def test_step_keeps_nadam_schedule_on_the_device():
    """Inside the step Nadam's running schedule is a device tensor the
    step owns (in its reads and its world copy), multiplied once per
    parameter per step; the host float stays at its start until the
    optimizer is pickled."""
    _, tnet = _pair(1)
    opt = topt.create("nadam", learning_rate=LR)
    step = CompiledTrainStep(tnet, tg.loss.L2Loss(), opt)
    x, y = torch.randn(BATCH, 6), torch.randn(BATCH, 3)
    for _ in range(2):
        step(x, y)
    sched = opt._m_schedule_t
    assert step._opt_tensors == [sched] and opt.m_schedule == 1.0
    want = 1.0
    n = len(step._learnable)
    for t in (1, 2):
        mt = 0.9 * (1.0 - 0.5 * 0.96 ** (t * 0.004))
        want *= mt ** n
    assert abs(float(sched) - want) <= 1e-6 * want
    assert any(t is sched for t in step._world())
    assert pickle.loads(pickle.dumps(opt)).m_schedule == float(sched)


def test_step_folds_lbsgd_warmup_into_its_lr():
    """The host lr the step writes for step n is the scheduler's times the
    warmup at n; inside the step ``_get_lr`` adds nothing to it."""
    opt = topt.create("lbsgd", **_kwargs("lbsgd", tls))
    lrs = [opt._lr_at_step(n) for n in range(1, 6)]
    sched = tls.FactorScheduler(2, 0.5)
    sched.base_lr = LR
    want = [sched(n) * (1.0 + 3.0 * min(n, 4) / 4) for n in range(1, 6)]
    np.testing.assert_allclose(lrs, want, rtol=1e-12)
    opt._step, opt.lr, opt.lr_scheduler = torch.tensor(3.0), 0.125, None
    assert opt._get_lr(0) == 0.125


@pytest.mark.parametrize("name", ["lamb", "lars", "nadam", "sgld"])
def test_trainer_and_module_take_the_name(name):
    """``gluon.Trainer(params, name)`` steps and ``Module.init_optimizer``
    accepts the name (both raised ``unknown optimizer`` before)."""
    net = tg.nn.Dense(3, in_units=4)
    net.initialize(tmx.init.Xavier())
    trainer = tg.Trainer(net.collect_params(), name, {"learning_rate": LR})
    before = net.weight.detach().clone()
    with tmx.autograd.record():
        loss = tg.loss.L2Loss()(net(tmx.nd.ones((2, 4))), tmx.nd.zeros((2, 3)))
    loss.backward()
    trainer.step(2)
    assert not torch.equal(net.weight.detach(), before)
    data = tmx.sym.var("data")
    sym = tmx.sym.LinearRegressionOutput(
        tmx.sym.FullyConnected(data, num_hidden=2, name="fc"),
        tmx.sym.var("softmax_label"), name="out")
    mod = tmx.module.Module(sym, label_names=["softmax_label"])
    mod.bind([("data", (4, 3))], [("softmax_label", (4, 2))])
    mod.init_params(tmx.init.Xavier())
    mod.init_optimizer(kvstore=None, optimizer=name,
                       optimizer_params={"learning_rate": LR})
    assert type(mod._optimizer).__name__.lower() == name
