"""Port parity for four repaired faults, on the CPU.

- C9, float floor division: ``broadcast_floordiv`` and
  ``_floordiv_scalar`` take ``jnp.floor_divide``'s float form (NaN for a
  nonzero over zero, +0 for -0 // 2); compared exactly, NaNs equal and
  the sign of every zero too, in fp32 and bf16.
- C10, optimizer state files cross between the packages: a ``.states``
  file written by ``Trainer.save_states``, ``Module.save_optimizer_states``
  (with and without a kvstore, so through the kvstore's
  ``save_optimizer_states`` too) loads in the other package; loading it
  into fresh optimizers over the same weights and stepping once gives the
  same weights in both, within 1e-5 of each tensor's largest |value| plus
  ADAM_LR_SHARE of Adam's learning rate (Adam divides each gradient by its
  own size, so a tiny gradient's rounding difference becomes a share of
  lr, as in ``tests/test_torch_trainer.py``).  The states themselves load
  bit for bit.  A bfloat16 state is written as the JAX package writes one:
  ``("nd", array, "bfloat16")`` with the array in numpy's bfloat16 from
  ``ml_dtypes``; the port reads it by its bits.
- C11: a backward from a head that ``isnan``, ``isinf``, ``isfinite`` or
  ``logical_not`` made raises ``MXNetError`` in both packages; heads made
  by ``stop_gradient``, ``BlockGrad``, ``==`` and ``ones_like`` give zero
  gradients in both.
- C12: the Embedding backward's plain version against ``F.embedding``'s
  gradient on the CPU, bit for bit in fp32 (``zeros().index_add_``) and
  bf16 (row by row, each add rounded, as the JAX package's scatter-add),
  with the forward's rules for ids out of range; and the Gluon
  ``Embedding``'s gradient against the JAX package's, within 1e-6 of the
  largest |value|.
- C13: after a bare ``import mxnet_tpu_torch as mx`` in a fresh process,
  every submodule of the JAX package's ``_SUBMODULES`` list that the port
  has resolves as ``mx.<name>``, as it does in the JAX package.
"""
import pickle
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jg
from mxnet_tpu import nd as jnd
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu.optimizer import optimizer as jopt

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon as tg
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import params_from_mxnet
from mxnet_tpu_torch.ops import embedding as EMB
from mxnet_tpu_torch.optimizer import optimizer as topt

REL = 1e-5
ADAM_LR = 0.01
ADAM_LR_SHARE = 2e-3
BATCH = 4


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = mx.set_default_context(mx.cpu())
    yield
    mx.set_default_context(prev)


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


# ---------------------------------------------------------------------------
# C9: float floor division
# ---------------------------------------------------------------------------
_X = np.array([1.5, -2.5, 3.0, 0.0, -0.0, 7.0, -7.0, 5.5, -0.0], np.float32)
_Y = np.array([0.0, 0.0, -0.0, 0.0, 2.0, -2.0, 3.0, -2.0, -3.0], np.float32)


def _same(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert np.array_equal(got, ref, equal_nan=True), (got, ref)
    zeros = ref == 0
    assert np.array_equal(np.signbit(got[zeros]), np.signbit(ref[zeros])), \
        (got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_floordiv_matches_jax(dtype):
    """The ROADMAP C9 vectors (and two more signed zeros) through
    ``broadcast_floordiv``, ``_floordiv_scalar`` with 0 and with its
    default, and ``-0.0 // 2``."""
    tx, ty = tnd.array(_X, dtype=dtype), tnd.array(_Y, dtype=dtype)
    jx, jy = jnd.array(_X, dtype=dtype), jnd.array(_Y, dtype=dtype)

    def f32(a):
        return a.astype("float32").asnumpy()

    _same(f32(tx // ty), f32(jx // jy))
    _same(f32(tnd.broadcast_floordiv(tx, ty)),
          f32(jnd.broadcast_floordiv(jx, jy)))
    for kw in ({"scalar": 0.0}, {}):
        _same(f32(tnd.invoke("_floordiv_scalar", [tx], kw)),
              f32(jnd.invoke("_floordiv_scalar", [jx], kw)))
    _same(f32(tnd.invoke("_floordiv_scalar", [tx], {"scalar": 2.0})),
          f32(jnd.invoke("_floordiv_scalar", [jx], {"scalar": 2.0})))
    neg0 = np.array([-0.0], np.float32)
    got = f32(tnd.array(neg0, dtype=dtype) // 2)
    _same(got, f32(jnd.array(neg0, dtype=dtype) // 2))
    assert not np.signbit(got[0])                    # +0, as jnp gives


def test_floordiv_gradient_stays_zero():
    x = tnd.array(_X[4:7])
    x.attach_grad()
    with tag.record():
        y = (x // 2.0) + x
    y.backward()
    np.testing.assert_array_equal(x.grad.asnumpy(), np.ones(3, np.float32))


# ---------------------------------------------------------------------------
# C10: optimizer state files
# ---------------------------------------------------------------------------
def _states_equal(got: dict, ref: dict):
    """Two Updater state dicts (either package) hold the same bits."""
    assert set(got) == set(ref)
    for k in ref:
        _state_equal(got[k], ref[k], k)


def _state_equal(got, ref, where):
    if ref is None:
        assert got is None, where
        return
    if isinstance(ref, tuple):
        assert isinstance(got, tuple) and len(got) == len(ref), where
        for g, r in zip(got, ref):
            _state_equal(g, r, where)
        return
    assert np.array_equal(_np(got), _np(ref)), where


def _gluon_net(g):
    net = g.nn.Sequential(prefix="c10_")
    with net.name_scope():
        # no conv bias: BatchNorm cancels it, so its gradient is rounding
        # noise that Adam would scale up to a share of lr
        net.add(g.nn.Conv2D(4, 3, padding=1, use_bias=False),
                g.nn.BatchNorm(),
                g.nn.Activation("relu"), g.nn.Flatten(), g.nn.Dense(3))
    return net


def _gluon_batch(seed):
    rng = np.random.RandomState(50 + seed)
    return (rng.rand(BATCH, 2, 6, 6).astype(np.float32),
            rng.randint(0, 3, BATCH).astype(np.float32))


def _gluon_step(g, ag, nd, net, trainer, seed):
    x, y = _gluon_batch(seed)
    with ag.record():
        loss = g.loss.SoftmaxCrossEntropyLoss()(net(nd.array(x)),
                                                nd.array(y))
    loss.backward()
    trainer.step(BATCH)


def _gluon_params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


_PKGS = {"jax": (jg, jag, jnd), "port": (tg, tag, tnd)}


def _fresh_trainer(side, params):
    g, ag, nd = _PKGS[side]
    net = _gluon_net(g)
    net.initialize()
    net(nd.array(_gluon_batch(0)[0]))
    if side == "port":
        params_from_mxnet(params, net)
    else:
        for k, p in net.collect_params().items():
            p.set_data(jnd.array(params[k]))
    return net, g.Trainer(net.collect_params(), "adam",
                          {"learning_rate": ADAM_LR})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_trainer_states_cross(writer, tmp_path):
    """The writer trains 2 Adam steps and saves its states; both packages
    load the file into fresh trainers over the writer's weights and step
    once on the same batch."""
    g, ag, nd = _PKGS[writer]
    net = _gluon_net(g)
    net.initialize()
    net(nd.array(_gluon_batch(0)[0]))
    trainer = g.Trainer(net.collect_params(), "adam",
                        {"learning_rate": ADAM_LR})
    for seed in (1, 2):
        _gluon_step(g, ag, nd, net, trainer, seed)
    fname = str(tmp_path / f"{writer}.states")
    trainer.save_states(fname)
    params = _gluon_params(net)
    after = {}
    for side in ("jax", "port"):
        net2, tr2 = _fresh_trainer(side, params)
        tr2.load_states(fname)
        _states_equal(tr2._updaters[0].states, trainer._updaters[0].states)
        _gluon_step(*_PKGS[side], net2, tr2, 3)
        after[side] = _gluon_params(net2)
    for k, ref in after["jax"].items():
        _close(after["port"][k], ref, atol=ADAM_LR_SHARE * ADAM_LR, what=k)


def _symbol(mx_):
    data = mx_.sym.var("data")
    net = mx_.sym.Convolution(data, num_filter=4, kernel=(3, 3),
                              pad=(1, 1), no_bias=True, name="conv")
    net = mx_.sym.BatchNorm(net, fix_gamma=False, name="bn")
    net = mx_.sym.Activation(net, act_type="relu")
    net = mx_.sym.FullyConnected(mx_.sym.Flatten(net), num_hidden=3,
                                 name="fc")
    return mx_.sym.SoftmaxOutput(net, mx_.sym.var("softmax_label"),
                                 name="softmax")


_MX = {"jax": jmx, "port": mx}


def _module(side, kvstore, arg, aux):
    mx_ = _MX[side]
    mod = mx_.module.Module(_symbol(mx_))
    mod.bind([("data", (BATCH, 2, 6, 6))], [("softmax_label", (BATCH,))])
    mod.init_params(arg_params={k: mx_.nd.array(v) for k, v in arg.items()},
                    aux_params={k: mx_.nd.array(v) for k, v in aux.items()})
    mod.init_optimizer(kvstore=kvstore, optimizer="adam",
                       optimizer_params={"learning_rate": ADAM_LR,
                                         "rescale_grad": 1.0 / BATCH})
    return mod


def _module_step(side, mod, seed):
    mx_ = _MX[side]
    x, y = _gluon_batch(seed)
    mod.forward_backward(mx_.io.DataBatch([mx_.nd.array(x)],
                                          [mx_.nd.array(y)]))
    mod.update()


def _module_updater(mod):
    if mod._update_on_kvstore and mod._kvstore is not None:
        return mod._kvstore._updater
    return mod._updater


@pytest.mark.parametrize("kvstore", [None, "local"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_module_states_cross(writer, kvstore, tmp_path):
    """``Module.save_optimizer_states`` (through the kvstore's
    ``save_optimizer_states`` with ``'local'``) written by one package,
    loaded by both, then one step each from the same weights."""
    rng = np.random.RandomState(7)
    arg = {"conv_weight": rng.randn(4, 2, 3, 3).astype(np.float32) * 0.3,
           "bn_gamma": np.ones(4, np.float32),
           "bn_beta": np.zeros(4, np.float32),
           "fc_weight": rng.randn(3, 144).astype(np.float32) * 0.1,
           "fc_bias": np.zeros(3, np.float32)}
    aux = {"bn_moving_mean": np.zeros(4, np.float32),
           "bn_moving_var": np.ones(4, np.float32)}
    mod = _module(writer, kvstore, arg, aux)
    for seed in (1, 2):
        _module_step(writer, mod, seed)
    fname = str(tmp_path / f"{writer}.states")
    mod.save_optimizer_states(fname)
    arg2, aux2 = ({k: v.asnumpy() for k, v in d.items()}
                  for d in mod.get_params())
    after = {}
    for side in ("jax", "port"):
        m2 = _module(side, kvstore, arg2, aux2)
        m2.load_optimizer_states(fname)
        _states_equal(_module_updater(m2).states,
                      _module_updater(mod).states)
        _module_step(side, m2, 3)
        after[side] = {k: v.asnumpy() for k, v in m2.get_params()[0].items()}
    for k, ref in after["jax"].items():
        _close(after["port"][k], ref, atol=ADAM_LR_SHARE * ADAM_LR, what=k)


def test_bfloat16_and_missing_states_cross():
    """At the ``Updater`` (which all three paths call): a bfloat16 state, a
    missing (``None``) state and a tuple of both cross both ways.  The
    port writes bfloat16 as the JAX package does, ``("nd", <ml_dtypes
    bfloat16 array>, "bfloat16")``, and reads it by its bits."""
    bits = np.random.RandomState(3).randint(0, 2 ** 15, 12).astype(np.uint16)
    bf = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    f32 = torch.arange(6, dtype=torch.float32)
    port = topt.Updater(topt.create("sgd", learning_rate=0.1))
    port.states = {0: bf.reshape(3, 4), 1: None, 2: (f32, bf)}
    blob = port.get_states()
    kind, arr, dtype = pickle.loads(blob)["states"][0]
    assert (kind, dtype) == ("nd", "bfloat16")
    assert arr.dtype == np.dtype(ml_dtypes.bfloat16)
    assert np.array_equal(arr.view(np.uint16).ravel(), bits)
    jup = jopt.Updater(jopt.create("sgd", learning_rate=0.1))
    jup.set_states(blob)
    assert str(jup.states[0].dtype) == "bfloat16" and jup.states[1] is None
    assert np.array_equal(
        np.asarray(jup.states[0].asnumpy()).view(np.uint16).ravel(), bits)
    _state_equal(jup.states[2], port.states[2], "tuple")
    back = topt.Updater(topt.create("sgd", learning_rate=0.1))
    back.set_states(jup.get_states())
    assert back.states[0].dtype == torch.bfloat16 and back.states[1] is None
    assert torch.equal(back.states[0].view(torch.int16),
                       bf.reshape(3, 4).view(torch.int16))
    assert torch.equal(back.states[2][0], f32)


# ---------------------------------------------------------------------------
# C11: a backward from an untracked head
# ---------------------------------------------------------------------------
_RAISE = ("isnan", "isinf", "isfinite", "logical_not")
_ZERO = ("stop_gradient", "BlockGrad", "equal", "ones_like")


def _head(nd, x, op):
    if op == "equal":
        return x == x
    return getattr(nd, op)(x)


@pytest.mark.parametrize("op", _RAISE + _ZERO)
def test_backward_from_an_untracked_head(op):
    grads = {}
    for side, nd, ag, err in (("jax", jnd, jag, JMXNetError),
                              ("port", tnd, tag, MXNetError)):
        x = nd.array(np.array([1.0, -2.0, 0.5], np.float32))
        x.attach_grad()
        with ag.record():
            head = _head(nd, x, op)
        if op in _RAISE:
            with pytest.raises(err, match="cannot differentiate"):
                head.backward()
        else:
            head.backward()
            grads[side] = x.grad.asnumpy()
    if op in _ZERO:
        np.testing.assert_array_equal(grads["port"], grads["jax"])
        np.testing.assert_array_equal(grads["port"], np.zeros(3))


# ---------------------------------------------------------------------------
# C12: the Embedding backward's plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vocab,d,shape", [(50, 8, (4, 16)), (2, 8, (64,)),
                                           (7, 5, (3, 3, 3))])
def test_embedding_backward_plain_matches_torch(vocab, d, shape, dtype):
    """The same bits as ``F.embedding``'s CPU backward: fp32 through
    ``index_add_``, bf16 added row by row, each add rounded."""
    gen = torch.Generator().manual_seed(vocab)
    ids = torch.randint(0, vocab, shape, generator=gen)
    dy = torch.randn(*shape, d, generator=gen).to(dtype)
    got = EMB.embedding_backward(ids, dy, vocab)
    w = torch.zeros(vocab, d, dtype=dtype, requires_grad=True)
    F.embedding(ids, w).backward(dy)
    assert got.dtype == dtype and torch.equal(got, w.grad)
    # the lookup's own gradient is the same function
    w2 = torch.zeros(vocab, d, dtype=dtype, requires_grad=True)
    out, ok = EMB.embedding_lookup(ids, w2)
    assert ok.all()
    out.backward(dy)
    assert torch.equal(w2.grad, got)


def test_embedding_backward_ids_out_of_range():
    """[-V, 0) counts from the end; other ids outside [0, V) add nothing."""
    ids = torch.tensor([[0, -1, 5, 9], [-6, 2, -5, 4]])
    dy = torch.randn(2, 4, 3, generator=torch.Generator().manual_seed(1))
    got = EMB.embedding_backward(ids, dy, 5)
    want = torch.zeros(5, 3)
    for i, v in enumerate(ids.reshape(-1).tolist()):
        v = v + 5 if v < 0 else v
        if 0 <= v < 5:
            want[v] += dy.reshape(-1, 3)[i]
    _close(got, want, rel=1e-6, what="out-of-range ids")
    bf = EMB.embedding_backward(ids, dy.bfloat16(), 5)
    assert bf.dtype == torch.bfloat16
    _close(bf, want, rel=2.0 ** -7, what="bf16")


def test_gluon_embedding_gradient_matches_jax():
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 20, (6, 10)).astype(np.float32)
    head = rng.randn(6, 10, 8).astype(np.float32)
    grads = {}
    for side, g, ag, nd in (("jax", jg, jag, jnd), ("port", tg, tag, tnd)):
        emb = g.nn.Embedding(20, 8, prefix="emb_")
        emb.initialize()
        weight, = emb.collect_params().values()
        if side == "jax":
            grads["w"] = rng.randn(20, 8).astype(np.float32)
        weight.set_data(nd.array(grads["w"]))
        with ag.record():
            out = emb(nd.array(ids))
            loss = (out * nd.array(head)).sum()
        loss.backward()
        grads[side] = weight.grad().asnumpy()
    _close(grads["port"], grads["jax"], rel=1e-6, what="Embedding grad")


# ---------------------------------------------------------------------------
# C13: the package imports its submodules
# ---------------------------------------------------------------------------
_ROOT = Path(__file__).resolve().parents[1]


def _attrs_resolve(package, names):
    probe = (f"import {package} as mx\n"
             f"for n in {names!r}:\n"
             "    assert getattr(mx, n).__name__ == f'{mx.__name__}.{n}', n\n"
             "print('ok', len(%r))" % (names,))
    proc = subprocess.run([sys.executable, "-c", probe], cwd=_ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.startswith("ok"), \
        proc.stderr[-2000:]


@pytest.mark.parametrize("package", ["mxnet_tpu_torch", "mxnet_tpu"])
def test_submodules_resolve_after_import(package):
    port = _ROOT / "mxnet_tpu_torch"
    names = [n for n, _ in jmx._SUBMODULES
             if (port / n).is_dir() or (port / f"{n}.py").is_file()]
    for n in ("checkpoint", "fleet", "profiler", "observability",
              "resilience"):
        assert n in names
    _attrs_resolve(package, names)
