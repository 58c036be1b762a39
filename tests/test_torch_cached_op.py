"""Port parity: ``hybridize()`` (the CachedOp) and the ``Executor`` on the
CPU against the JAX package.

On CPU tensors a CachedOp entry and an Executor forward run the block
eagerly, as every kernel wrapper takes its plain version there; on the
card they replay CUDA graphs, which ``chip_smoke.py``'s
``graph_semantics`` phase holds.  These tests hold the semantics both must
keep: outputs and gradients, one entry per signature reused across
recorded steps, the moving statistics, fresh outputs, the ``grad_req``
key, the recompile-storm warning, and an Executor whose bound arrays are
written in place (their storage stays where a graph reads it).

Same seed, same weights through numpy in both packages.  Tolerance: fp32
within 1e-5 of each tensor's largest |value| plus 1e-6 (XLA and PyTorch
sum products in other orders); bit for bit where both sides of a check
run the same math in the port.
"""
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon import nn as jnn

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.cached_op import CachedOp
from mxnet_tpu_torch.convert import params_from_mxnet
from mxnet_tpu_torch.gluon import nn as tnn

REL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)


def _close(got, ref, rel=REL, what=""):
    got = np.asarray(got.asnumpy() if hasattr(got, "asnumpy") else got)
    ref = np.asarray(ref.asnumpy() if hasattr(ref, "asnumpy") else ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    bound = rel * float(np.abs(ref).max()) + 1e-6
    err = float(np.abs(got - ref).max())
    assert err <= bound, f"{what}: max err {err} > {bound}"


def _mlp(nn, prefix, bn=False):
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu", in_units=8),
                nn.Dense(4, in_units=16))
        if bn:
            net.add(nn.BatchNorm(in_channels=4))
    net.initialize()
    return net


def _pair(prefix, bn=False):
    """(JAX net, port net, port twin) with the JAX net's weights."""
    jnet = _mlp(jnn, prefix, bn)
    weights = {k: p.data().asnumpy()
               for k, p in jnet.collect_params().items()}
    nets = []
    for _ in range(2):
        t = _mlp(tnn, prefix, bn)
        params_from_mxnet(weights, t)
        nets.append(t)
    return jnet, nets[0], nets[1]


def _x(seed, rows=5, cols=8):
    return np.random.RandomState(seed).randn(rows, cols).astype(np.float32)


def _grads(net):
    return {k: p.grad().asnumpy() for k, p in net.collect_params().items()
            if p.grad_req != "null"}


# ------------------------------------------------------------- CachedOp
def test_hybridized_predict_matches_eager_and_jax():
    jnet, net, twin = _pair("cpa_")
    jnet.hybridize()
    net.hybridize()
    for seed in range(3):
        x = _x(seed)
        out = net(tmx.nd.array(x))
        np.testing.assert_array_equal(out.asnumpy(),
                                      twin(tmx.nd.array(x)).asnumpy())
        _close(out, jnet(jmx.nd.array(x)), what=f"call {seed}")
    stats = net._cached_op.cache_stats
    assert (stats["entries"], stats["misses"], stats["hits"]) == (1, 1, 2)


def test_record_entry_gradients_match_eager_and_jax():
    jnet, net, twin = _pair("cpb_")
    jnet.hybridize()
    net.hybridize()
    x = _x(3)
    for n, nd, ag in ((net, tmx.nd, tag), (twin, tmx.nd, tag),
                      (jnet, jmx.nd, jag)):
        with ag.record():
            loss = (n(nd.array(x)) ** 2).sum()
        loss.backward()
    got, eager, ref = _grads(net), _grads(twin), _grads(jnet)
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], eager[k])
        _close(got[k], ref[k], what=k)


def test_record_entry_built_once_and_reused_over_four_steps():
    jnet, net, _ = _pair("cpc_")
    jnet.hybridize()
    net.hybridize()
    x = _x(4)
    for step in range(4):
        for n, nd, ag in ((net, tmx.nd, tag), (jnet, jmx.nd, jag)):
            with ag.record():
                loss = (n(nd.array(x)) ** 2).sum()
            loss.backward()
        for k, g in _grads(net).items():
            _close(g, _grads(jnet)[k], what=f"step {step} {k}")
    for op in (net._cached_op, jnet._cached_op):
        stats = op.cache_stats
        assert (stats["entries"], stats["misses"], stats["hits"]) == (1, 1, 3)


def test_batchnorm_moving_stats_after_three_training_calls_match_jax():
    jnet, net, _ = _pair("cpd_", bn=True)
    jnet.hybridize()
    net.hybridize()
    bn_j = jnet[2]
    bn_t = net[2]
    for call in range(3):
        x = _x(10 + call, rows=6)
        for n, nd, ag in ((net, tmx.nd, tag), (jnet, jmx.nd, jag)):
            with ag.record():
                loss = n(nd.array(x)).sum()
            loss.backward()
    for name in ("running_mean", "running_var"):
        got = bn_t._reg_params[name].data()
        ref = getattr(bn_j, name).data()
        assert float(np.abs(got.asnumpy()).max()) > 0
        _close(got, ref, what=name)
    assert net._cached_op.cache_stats["misses"] == 1


def test_output_held_across_a_second_call_is_unchanged():
    _, net, _ = _pair("cpe_")
    net.hybridize()
    held = net(tmx.nd.array(_x(20)))
    copy = held.asnumpy().copy()
    net(tmx.nd.array(_x(21)))
    np.testing.assert_array_equal(held.asnumpy(), copy)
    with tag.record():
        held = net(tmx.nd.array(_x(22)))
    copy = held.asnumpy().copy()
    with tag.record():
        net(tmx.nd.array(_x(23)))
    np.testing.assert_array_equal(held.asnumpy(), copy)


def test_grad_req_change_makes_a_new_entry():
    jnet, net, _ = _pair("cpf_")
    jnet.hybridize()
    net.hybridize()
    for n, nd in ((net, tmx.nd), (jnet, jmx.nd)):
        x = nd.array(_x(30))
        n(x)
        n(x)
        n.collect_params()[f"{n.prefix}dense0_weight"].grad_req = "null"
        n(x)
    for op in (net._cached_op, jnet._cached_op):
        stats = op.cache_stats
        assert (stats["entries"], stats["misses"], stats["hits"]) == (2, 2, 1)
    sigs = net._cached_op.cache_stats["signatures"]
    assert ("cpf_dense0_weight", "write") in sigs[0][2]
    assert ("cpf_dense0_weight", "null") in sigs[1][2]


def test_recompile_storm_warns_once(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_RECOMPILE_WARN", "4")
    _, net, _ = _pair("cpg_")
    net.hybridize()
    with pytest.warns(RuntimeWarning, match="recompile storm"):
        for n in range(1, 6):  # five distinct batch sizes = five entries
            net(tmx.nd.zeros((n, 8)))
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        net(tmx.nd.zeros((7, 8)))


def test_hybridize_flags_and_an_inner_hybridized_block():
    """The reference's flags reach the CachedOp and select nothing; a
    hybridized child called inside its parent's entry keys nothing."""
    _, net, twin = _pair("cph_")
    net[0].hybridize()
    net.hybridize(static_alloc=True, static_shape=True)
    x = tmx.nd.array(_x(40))
    np.testing.assert_array_equal(net(x).asnumpy(), twin(x).asnumpy())
    assert net._cached_op._flags == {"static_alloc": True,
                                     "static_shape": True}
    assert net[0]._cached_op is None or \
        net[0]._cached_op.cache_stats["entries"] == 0
    assert CachedOp(lambda a: a, [], flags=())._flags == {}


def test_random_seed_restarts_the_streams_in_place():
    gen = tmx.random.device_generator("cpu")
    tmx.random.seed(5)
    assert tmx.random.device_generator("cpu") is gen
    first = torch.rand(4, generator=gen)
    tmx.random.seed(5)
    np.testing.assert_array_equal(torch.rand(4, generator=gen).numpy(),
                                  first.numpy())


# -------------------------------------------------------------- Executor
def _exec_symbol(sym):
    data = sym.var("data")
    net = sym.FullyConnected(data, num_hidden=6, name="fc1")
    net = sym.BatchNorm(net, name="bn", fix_gamma=False)
    net = sym.FullyConnected(sym.Activation(net, act_type="relu"),
                             num_hidden=3, name="fc2")
    return sym.SoftmaxOutput(net, sym.var("softmax_label"), name="softmax")


_REQ = {"data": "write", "softmax_label": "null", "fc1_weight": "write",
        "fc1_bias": "add", "bn_gamma": "write", "bn_beta": "null",
        "fc2_weight": "add", "fc2_bias": "write"}


def _bind(pkg, batch):
    ex = _exec_symbol(pkg.sym).simple_bind(
        ctx=pkg.cpu(), grad_req=_REQ, data=(batch, 5),
        softmax_label=(batch,))
    rng = np.random.RandomState(7)
    for k in sorted(ex.arg_dict):
        if k not in ("data", "softmax_label"):
            ex.arg_dict[k][:] = pkg.nd.array(
                rng.randn(*ex.arg_dict[k].shape).astype(np.float32) * 0.3)
    ex.aux_dict["bn_moving_var"][:] = pkg.nd.array(np.ones(6, np.float32))
    return ex


def test_executor_matches_jax_write_add_null_and_rebinds():
    """Forward/backward repeated at batch 8, rebound at batch 4 and back:
    outputs, every gradient (write, add; null stays unwritten) and the
    moving statistics against the JAX Executor; the moving statistics and
    the batch-8 data buffer stay at their addresses."""
    jex, tex = _bind(jmx, 8), _bind(tmx, 8)
    aux_ptr = {k: a._data.data_ptr() for k, a in tex.aux_dict.items()}
    data_ptr = tex.arg_dict["data"]._data.data_ptr()
    rng = np.random.RandomState(8)
    for step, batch in enumerate((8, 8, 4, 8)):
        x = rng.randn(batch, 5).astype(np.float32)
        y = rng.randint(0, 3, batch).astype(np.float32)
        for ex, nd in ((jex, jmx.nd), (tex, tmx.nd)):
            ex.forward(is_train=True, data=nd.array(x),
                       softmax_label=nd.array(y))
            ex.backward()
        _close(tex.outputs[0], jex.outputs[0], what=f"step {step} out")
        for k, req in _REQ.items():
            if req != "null":
                _close(tex.grad_dict[k], jex.grad_dict[k],
                       what=f"step {step} grad {k}")
        for k in tex.aux_dict:
            _close(tex.aux_dict[k], jex.aux_dict[k],
                   what=f"step {step} aux {k}")
    assert np.abs(tex.grad_dict["bn_beta"].asnumpy()).max() == 0
    assert {k: a._data.data_ptr() for k, a in tex.aux_dict.items()} == \
        aux_ptr
    assert tex.arg_dict["data"]._data.data_ptr() == data_ptr
    x = rng.randn(8, 5).astype(np.float32)
    _close(tex.forward(data=tmx.nd.array(x))[0],
           jex.forward(data=jmx.nd.array(x))[0], what="predict")
    with pytest.raises(tmx.MXNetError):
        tex.backward()


def test_bound_arrays_take_writes_in_place():
    """``arr[:] = v``, ``copy_params_from`` and a kvstore pull write into
    an Executor's bound arrays in place; a plain array keeps its value
    semantics."""
    ex = _bind(tmx, 4)
    w = ex.arg_dict["fc1_weight"]
    ptr = w._data.data_ptr()
    w[:] = tmx.nd.ones(w.shape)
    ex.copy_params_from({"fc1_weight": tmx.nd.zeros(w.shape)})
    kv = tmx.kv.create("local")
    kv.init(0, tmx.nd.ones(w.shape) * 3)
    kv.pull(0, out=w)
    assert w._data.data_ptr() == ptr
    np.testing.assert_array_equal(w.asnumpy(), np.full(w.shape, 3.0))
    plain = tmx.nd.zeros((2,))
    before = plain._data
    plain[:] = tmx.nd.ones((2,))
    assert plain._data is not before and float(before.sum()) == 0.0


def test_module_fit_keeps_every_bound_address():
    """``Module.fit`` over the 'local' kvstore (push, pull) and without one
    (the updater) leaves every bound array where it was, so a graph
    captured at the first step reads the weights every later step
    writes."""
    x = np.random.RandomState(9).rand(32, 5).astype(np.float32)
    it = tmx.io.NDArrayIter(x, x.argmax(1) % 3, batch_size=8)
    for kv in ("local", None):
        mod = tmx.module.Module(_exec_symbol(tmx.sym))
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(tmx.init.Xavier())
        mod.init_optimizer(kvstore=kv, optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1,
                                             "momentum": 0.9})
        ex = mod._exec
        ptrs = [a._data.data_ptr() for t in (ex.arg_dict, ex.aux_dict,
                                             ex.grad_dict)
                for a in t.values()]
        w0 = ex.arg_dict["fc1_weight"].asnumpy().copy()
        mod.fit(it, num_epoch=2, kvstore=kv, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
        assert [a._data.data_ptr() for t in (ex.arg_dict, ex.aux_dict,
                                             ex.grad_dict)
                for a in t.values()] == ptrs, kv
        assert not np.array_equal(ex.arg_dict["fc1_weight"].asnumpy(), w0)
