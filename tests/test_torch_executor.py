"""Port parity: ``CompiledTrainStep`` against mxnet_tpu's, on CPU tensors.

A two-head net whose loss reads only the first head: the second head gets
no gradient.  The JAX package's compiled step differentiates with
``jax.value_and_grad``, which gives it a zero gradient, and still updates
it; the port's step must do the same (under SGD with wd the head decays by
exactly lr·wd·w, under Adam it stays).  The net takes a tuple input, which
both steps unpack into ``net(*x)``, and Adam's bias correction follows the
step's 1-based count.  Inputs and weights are seeded numpy arrays copied
into both packages.

The later tests hold the learning-rate schedule (indexed by the step's
own count), the step's device scalars, the optimizer's counts (a
deliberate difference), the update ops with a tensor lr on bf16 weights,
BatchNorm's moving statistics, ``remat``/``fuse_grad_buckets``/``donate``,
the options that are not ported and ``compile_forward`` against the JAX
package.

Tolerance: fp32 parameters within 1e-6 of each tensor's largest |value|
(the same arithmetic summed in other orders), except where the test says
"exactly"; bf16 update ops within one bf16 ulp of each element.
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
    # step 1: lr·sqrt(1 − β2)/(1 − β1)·m/(sqrt(v) + ε), the step size in
    # fp32 as the JAX compiled step computes it (about lr: 1 − 0.999 in
    # fp32 is 9.999871e-4)
    f32 = np.float32
    size = (f32(0.5) * np.sqrt(f32(1) - f32(0.999) ** f32(1))
            / (f32(1) - f32(0.9) ** f32(1)))
    m, v = f32(1 - 0.9) * f32(2), f32(1 - 0.999) * f32(4)
    want = f32(1) - size * m / (np.sqrt(v) + f32(1e-8))
    assert abs(net.weight.item() - want) < 1e-6
    assert abs(net.weight.item() - 0.5) < 1e-5


# ---------------------------------------------------------------------------
# The learning-rate schedule, the step's device scalars and the optimizer's
# counts
# ---------------------------------------------------------------------------
def _dense_pair(seed=0):
    """``Dense(3, in_units=4)`` in both packages from the same weights."""
    rng = np.random.RandomState(seed)
    jnet = jnn.Dense(3, in_units=4)
    jnet.collect_params().initialize()
    tnet = Dense(3, in_units=4, device="cpu")
    for p, t in zip(jnet.collect_params().values(), tnet.state_dict().values()):
        value = rng.uniform(-0.5, 0.5, tuple(t.shape)).astype(np.float32)
        p.set_data(nd.array(value))
        t.copy_(torch.from_numpy(value))
    return jnet, tnet


def _sq_loss(out, y):
    return ((out - y) ** 2).mean(axis=1)


def _sq_loss_t(out, y):
    return (out - y).square().mean(dim=1)


def _schedule_steps(opt_name, begin, n=3, **extra):
    from mxnet_tpu import lr_scheduler as jsched
    from mxnet_tpu_torch import lr_scheduler as tsched
    jnet, tnet = _dense_pair()
    lr = 0.1 if opt_name == "sgd" else 0.05
    kw = dict(learning_rate=lr, begin_num_update=begin, **extra)
    jo = jopt.create(opt_name, lr_scheduler=jsched.FactorScheduler(
        step=1, factor=0.5), **kw)
    to = topt.create(opt_name, lr_scheduler=tsched.FactorScheduler(
        step=1, factor=0.5), **kw)
    jstep = JaxTrainStep(jnet, _sq_loss, jo, batch_size=6)
    tstep = CompiledTrainStep(tnet, _sq_loss_t, to, batch_size=6)
    rng = np.random.RandomState(7)
    for _ in range(n):
        x = rng.randn(6, 4).astype(np.float32)
        y = rng.randn(6, 3).astype(np.float32)
        jstep(nd.array(x), nd.array(y))
        tstep(torch.from_numpy(x), torch.from_numpy(y))
    return jnet, tnet, jo, to


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
@pytest.mark.parametrize("begin", [0, 4])
def test_schedule_is_indexed_by_the_steps_own_count(opt_name, begin):
    """FactorScheduler(step=1, factor=0.5) over 3 steps: the step's lr is
    ``lr_scheduler(step + 1)`` whatever ``begin_num_update`` is, as the
    JAX ``_lr_at`` gives it (the optimizer's own count started at 4 took
    lr/16 instead, 0.48 away after 3 SGD steps)."""
    extra = {"momentum": 0.9, "wd": 1e-4} if opt_name == "sgd" else {}
    jnet, tnet, _, _ = _schedule_steps(opt_name, begin, **extra)
    for p, (key, t) in zip(jnet.collect_params().values(),
                           tnet.state_dict().items()):
        _close(t.numpy(), p.data().asnumpy(), key)


def test_optimizer_counts_once_per_step_not_once_per_trace():
    """A deliberate difference: after 3 steps the port's optimizer has
    counted 3 updates of every index (MXNet's count, as the eager step and
    a replayed graph keep it); the JAX step counts once per trace."""
    _, _, jo, to = _schedule_steps("sgd", 0)
    assert to.num_update == 3
    assert to._index_update_count == {0: 3, 1: 3}
    assert jo.num_update == 1
    _, _, jo, to = _schedule_steps("sgd", 4)
    assert (to.num_update, jo.num_update) == (7, 5)


def test_step_scalars_are_device_tensors_and_restored():
    """Inside the step the optimizer reads lr and the step count as 0-dim
    fp32 tensors on the parameters' device (what a CUDA graph reads), with
    no scheduler and rescale_grad 1.0; all are restored after."""
    from mxnet_tpu_torch import lr_scheduler as tsched
    _, tnet = _dense_pair()
    sched = tsched.FactorScheduler(step=1, factor=0.5)
    opt = topt.create("adam", learning_rate=0.2, lr_scheduler=sched,
                      rescale_grad=0.25)
    seen = []
    update = opt.update

    def spy(index, weight, grad, state):
        seen.append((opt.lr, opt._step, opt.lr_scheduler, opt.rescale_grad))
        update(index, weight, grad, state)
    opt.update = spy
    step = CompiledTrainStep(tnet, _sq_loss_t, opt)
    x, y = torch.ones(2, 4), torch.zeros(2, 3)
    for _ in range(3):
        step(x, y)
    assert len(seen) == 6
    for k, (lr, t, sch, rescale) in enumerate(seen):
        assert isinstance(lr, torch.Tensor) and lr.dim() == 0
        assert lr.dtype == t.dtype == torch.float32
        assert lr.device == t.device == tnet.weight.device
        assert sch is None and rescale == 1.0
    # the tensors are written before each step: the last values are step 3's
    assert float(seen[-1][1]) == 3.0
    assert float(seen[-1][0]) == pytest.approx(0.2 * 0.25)
    assert opt.lr == 0.2 and opt.lr_scheduler is sched
    assert opt.rescale_grad == 0.25 and opt._step is None


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_tensor_lr_update_ops_keep_bf16_and_match_jax(opt_name):
    """With lr a float32 tensor (the step's), a bf16 weight and its states
    stay bf16, and each equals the JAX op called with a float32 array lr
    and written back into its bf16 array (invoke's ``out=``), within one
    bf16 ulp of each element (the JAX op may keep fp32 inside a fusion)."""
    import jax.numpy as jnp
    from mxnet_tpu.ops import optimizer_ops as jops
    from mxnet_tpu_torch.ops import optimizer_ops as tops
    rng = np.random.RandomState(3)
    arrays = [rng.randn(6, 5).astype(np.float32) for _ in range(4)]
    jb = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    lr = 0.05
    if opt_name == "sgd":
        kw = dict(momentum=0.9, wd=1e-2)
        ref = jops._sgd_mom_update(jb[0], jb[1], jb[2],
                                   lr=jnp.float32(lr), **kw)
        tops.sgd_mom_update(tb[0], tb[1], tb[2],
                            lr=torch.tensor(lr, dtype=torch.float32), **kw)
        got = [tb[0], tb[2]]
        ref_w = jops._sgd_update(jb[0], jb[1], lr=jnp.float32(lr), wd=1e-2)
        w = torch.from_numpy(arrays[0]).to(torch.bfloat16)
        tops.sgd_update(w, tb[1], lr=torch.tensor(lr), wd=1e-2)
        got.append(w)
        ref = list(ref) + [ref_w]
    else:
        kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, wd=1e-2)
        ref = jops._adam_update(jb[0], jb[1], jb[2], jnp.abs(jb[3]),
                                lr=jnp.float32(lr), **kw)
        var = tb[3].abs()
        tops.adam_update(tb[0], tb[1], tb[2], var,
                         lr=torch.tensor(lr, dtype=torch.float32), **kw)
        got = [tb[0], tb[2], var]
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        r = np.asarray(r.astype(jnp.bfloat16).astype(jnp.float32))
        g = g.float().numpy()
        ulp = np.abs(r) * 2.0 ** -7 + 1e-30
        assert np.all(np.abs(g - r) <= ulp), np.abs(g - r).max()


def test_bf16_weights_keep_their_dtype_through_the_step():
    """A bf16 Dense under SGD with momentum and under Adam: after 2 steps
    the weights and every state are still bf16, in both packages."""
    for opt_name, kw in (("sgd", dict(learning_rate=0.1, momentum=0.9)),
                         ("adam", dict(learning_rate=0.1))):
        _, tnet = _dense_pair()
        tnet.cast("bfloat16")
        step = CompiledTrainStep(tnet, lambda o, y: _sq_loss_t(o.float(), y),
                                 topt.create(opt_name, **kw))
        x = torch.ones(2, 4, dtype=torch.bfloat16)
        for _ in range(2):
            loss = step(x, torch.zeros(2, 3))
        assert torch.isfinite(loss)
        assert all(p.dtype == torch.bfloat16 for p in tnet.parameters())
        from mxnet_tpu_torch.executor import _leaves
        assert all(t.dtype == torch.bfloat16
                   for s in step._states for t in _leaves(s))


# ---------------------------------------------------------------------------
# BatchNorm, options, compile_forward
# ---------------------------------------------------------------------------
class _JaxBnNet(jgluon.HybridBlock):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.fc = jnn.Dense(64, in_units=5)
            self.bn = jnn.BatchNorm(in_channels=64)
            self.out = jnn.Dense(3, in_units=64)

    def hybrid_forward(self, F, x):
        return self.out(F.relu(self.bn(self.fc(x))))


class _BnNet(torch.nn.Module):
    """Dense, BatchNorm, ReLU, [Dropout,] Dense on the CPU."""

    def __init__(self, dropout=0.0, seed=5):
        super().__init__()
        from mxnet_tpu_torch.gluon.nn import BatchNorm, Dropout
        self.fc = Dense(64, in_units=5, device="cpu")
        self.bn = BatchNorm(in_channels=64, device="cpu")
        self.out = Dense(3, in_units=64, device="cpu")
        self.drop = (Dropout(dropout, generator=torch.Generator().manual_seed(
            seed)) if dropout else None)

    def forward(self, x):
        h = torch.relu(self.bn(self.fc(x)))
        if self.drop is not None:
            h = self.drop(h)
        return self.out(h)


def _bn_pair(seed=0, dropout=0.0):
    rng = np.random.RandomState(seed)
    jnet = _JaxBnNet()
    jnet.collect_params().initialize()
    tnet = _BnNet(dropout)
    for p, (key, t) in zip(jnet.collect_params().values(),
                           tnet.state_dict().items()):
        value = rng.uniform(-0.5, 0.5, tuple(t.shape)).astype(np.float32)
        if "running_var" in key:
            value = np.abs(value) + 0.5
        p.set_data(nd.array(value))
        t.copy_(torch.from_numpy(value))
    return jnet, tnet


def _bn_batches(n, seed=11):
    rng = np.random.RandomState(seed)
    return [(rng.randn(8, 5).astype(np.float32),
             rng.randint(0, 3, 8).astype(np.float32)) for _ in range(n)]


def test_batchnorm_moving_statistics_follow_jax():
    """Two SGD steps of Dense-BatchNorm-Dense: the moving statistics move
    and every tensor (weights, statistics) follows the JAX step."""
    jnet, tnet = _bn_pair()
    before = {k: v.clone() for k, v in tnet.state_dict().items()}
    jce, tce = jloss.SoftmaxCrossEntropyLoss(), SoftmaxCrossEntropyLoss()
    kw = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)
    jstep = JaxTrainStep(jnet, jce, jopt.create("sgd", **kw))
    tstep = CompiledTrainStep(tnet, tce, topt.create("sgd", **kw))
    for x, y in _bn_batches(2):
        jstep(nd.array(x), nd.array(y))
        tstep(torch.from_numpy(x), torch.from_numpy(y))
    for p, (key, t) in zip(jnet.collect_params().values(),
                           tnet.state_dict().items()):
        if "running" in key:
            assert not torch.equal(t, before[key]), key
        _close(t.numpy(), p.data().asnumpy(), key)


def _plain_and(option, opt_name, dropout):
    """Three steps with ``option`` on and off from the same state: the
    nets' state dicts."""
    out = []
    for on in (False, True):
        _, tnet = _bn_pair(dropout=dropout)
        kw = ({"momentum": 0.9, "wd": 1e-4} if opt_name == "sgd" else {})
        step = CompiledTrainStep(tnet, SoftmaxCrossEntropyLoss(),
                                 topt.create(opt_name, learning_rate=0.05,
                                             **kw),
                                 **({option: True} if on else {}))
        for x, y in _bn_batches(3):
            step(torch.from_numpy(x), torch.from_numpy(y))
        out.append((tnet.state_dict(), step))
    return out


@pytest.mark.parametrize("option", ["remat", "fuse_grad_buckets"])
@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_remat_and_grad_buckets_change_no_bit(option, opt_name, monkeypatch):
    """``remat=True`` (the forward recomputed in the backward, the dropout
    masks drawn again from the same generator state) and
    ``fuse_grad_buckets=True`` (a 1 KiB bucket cap, so several buckets)
    give exactly the plain step's weights and statistics."""
    monkeypatch.setenv("MXNET_KVSTORE_BUCKET_KB", "1")
    (plain, _), (other, step) = _plain_and(option, opt_name, dropout=0.5)
    if option == "fuse_grad_buckets":
        assert 1 < step.grad_bucket_count < len(step._learnable)
    for key in plain:
        assert torch.equal(plain[key], other[key]), key


@pytest.mark.parametrize("kwargs,item", [
    ({"mesh": object()}, "A11"),
    ({"shard_optimizer_state": True}, "A11"),
    ({"param_spec_fn": lambda p: None}, "A11"),
    ({"health": True}, "A12")])
def test_unported_options_raise_naming_the_roadmap(kwargs, item):
    from mxnet_tpu_torch.base import MXNetError
    _, tnet = _dense_pair()
    with pytest.raises(MXNetError, match=item):
        CompiledTrainStep(tnet, _sq_loss_t, topt.create("sgd"), **kwargs)


def test_donate_is_accepted_and_changes_nothing():
    outs = []
    for donate in (True, False):
        _, tnet = _dense_pair()
        step = CompiledTrainStep(tnet, _sq_loss_t,
                                 topt.create("sgd", learning_rate=0.1),
                                 donate=donate)
        step(torch.ones(2, 4), torch.zeros(2, 3))
        outs.append(tnet.weight.detach().clone())
    assert torch.equal(*outs)


@pytest.mark.parametrize("training", [False, True])
def test_compile_forward_matches_jax(training):
    """``compile_forward``'s pure function over the module's tensors
    against the JAX one (``tests/test_executor.py``'s contract) on the
    BatchNorm net, in evaluation and in training (batch statistics)."""
    import jax
    from mxnet_tpu.executor import compile_forward as jax_compile_forward
    from mxnet_tpu_torch.executor import compile_forward
    jnet, tnet = _bn_pair()
    x = _bn_batches(1)[0][0]
    jpure, jlearn, jaux = jax_compile_forward(jnet, training=training)
    ref = jpure(tuple(p.data()._data for p in jlearn),
                tuple(p.data()._data for p in jaux), nd.array(x)._data,
                jax.random.PRNGKey(0))
    pure, learn, aux = compile_forward(tnet, training=training)
    assert len(learn) == len(jlearn) and len(aux) == len(jaux)
    got = pure(tuple(learn), tuple(t.clone() for t in aux),
               torch.from_numpy(x), torch.Generator().manual_seed(0))
    _close(got.detach().numpy(), np.asarray(ref), "forward")
    if not training:
        with torch.no_grad():
            tnet.eval()
            _close(tnet(torch.from_numpy(x)).numpy(), np.asarray(ref), "net")


def test_executor_module_gives_the_symbol_executor():
    from mxnet_tpu_torch import executor
    from mxnet_tpu_torch.symbol.symbol import Executor
    assert executor.Executor is Executor
    with pytest.raises(AttributeError):
        executor.NoSuchThing
