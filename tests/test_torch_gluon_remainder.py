"""Port parity: the rest of the front end against mxnet_tpu's, on the CPU,
from seeded numpy inputs: the metrics MCC, PearsonCorrelation, PCC, Torch
and Caffe; the initializers Orthogonal, Bilinear, Load, LSTMBias and
FusedRNN; ``gluon.utils``; ``Block.summary``, ``register_op_hook`` and
``reset_ctx``; ``gluon.contrib.data.IntervalSampler``; the deformable
convolution ops and layers (``gluon.contrib.cnn``) with their gradients.

Tolerances: metrics within 1e-12 relative (both compute in numpy
float64 on the host); the deterministic initializers and every index
list equal; Orthogonal by its properties (Q·Qᵀ or Qᵀ·Q = scale²·I within
1e-5, the shape, the dtype), never its draws, which come from other
generators; ``clip_global_norm`` and the deformable convolutions within
1e-5 of each tensor's largest |value| (the gather is the same arithmetic;
the products sum in other orders).  ``download`` is exercised on local
files only: nothing is fetched.
"""
import hashlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jg
from mxnet_tpu import initializer as jinit
from mxnet_tpu import metric as jmetric

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon as tg
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch import metric as tmetric


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    if isinstance(x, np.ndarray):
        return x.astype(np.float32)
    return np.asarray(x.asnumpy(), np.float32)


def _close(got, ref, rel, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    bound = rel * float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= bound, f"{what}: max err {err} > {bound}"


# ------------------------------------------------------------------ metrics
def _metric_batches(name, rng):
    if name == "pcc":
        return [(rng.randint(0, k, 12), rng.rand(12, k))
                for k in (3, 3, 5)]
    if name in ("pearsonr", "pearsoncorrelation"):
        return [(rng.rand(10), rng.rand(10)) for _ in range(3)]
    if name in ("torch", "caffe"):
        return [(None, rng.rand(4, 3)) for _ in range(3)]
    return [(rng.randint(0, 2, 16), rng.rand(16, 2)) for _ in range(2)] + \
        [(rng.randint(0, 2, 8), rng.rand(8))]


@pytest.mark.parametrize("name", ["mcc", "pearsonr", "pearsoncorrelation",
                                  "pcc", "torch", "caffe"])
def test_metric_matches_jax(name):
    rng = np.random.RandomState(len(name))
    jm, tm = jmetric.create(name), tmetric.create(name)
    assert type(tm).__name__ == type(jm).__name__ and tm.name == jm.name
    for step, (label, pred) in enumerate(_metric_batches(name, rng)):
        for m, mx in ((jm, jmx), (tm, tmx)):
            labels = None if label is None else [mx.nd.array(label)]
            m.update(labels, [mx.nd.array(pred.astype(np.float32))])
        for get in ("get", "get_global"):
            (jn, jv), (tn, tv) = getattr(jm, get)(), getattr(tm, get)()
            assert jn == tn
            np.testing.assert_allclose(tv, jv, rtol=1e-12,
                                       err_msg=f"{name} {get} {step}")
        if step == 1:
            for m in (jm, tm):
                m.reset_local()
    jm.reset()
    tm.reset()
    assert np.isnan(tm.get()[1]) == np.isnan(jm.get()[1])


# ------------------------------------------------------------- initializers
@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
@pytest.mark.parametrize("shape", [(4, 6), (6, 4), (4, 2, 2, 2)])
def test_orthogonal_properties(shape, rand_type):
    init = tinit.create("orthogonal", scale=1.5, rand_type=rand_type)
    assert isinstance(init, tinit.Orthogonal)
    gen = torch.Generator().manual_seed(0)
    t = torch.empty(shape)
    init(t, gen)
    jarr = jmx.nd.zeros(shape)
    jinit.Orthogonal(scale=1.5, rand_type=rand_type)("w_weight", jarr)
    for q in (t.numpy(), jarr.asnumpy()):
        m = q.reshape(shape[0], -1).astype(np.float64)
        gram = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
        np.testing.assert_allclose(gram, 1.5 ** 2 * np.eye(len(gram)),
                                   atol=1e-5)
    # the same generator state gives the same matrix
    again = torch.empty(shape)
    init(again, torch.Generator().manual_seed(0))
    assert torch.equal(again, t)


@pytest.mark.parametrize("shape", [(2, 3, 4, 4), (1, 1, 5, 3)])
def test_bilinear_matches_jax(shape):
    jarr = jmx.nd.zeros(shape)
    jinit.create("bilinear")("up_weight", jarr)
    tarr = tmx.nd.zeros(shape)
    tinit.create("bilinear")("up_weight", tarr)
    np.testing.assert_array_equal(tarr.asnumpy(), jarr.asnumpy())


def test_load_matches_jax():
    rng = np.random.RandomState(0)
    w = rng.randn(3, 2).astype(np.float32)
    for mx, init_mod in ((jmx, jinit), (tmx, tinit)):
        init = init_mod.Load({"arg:fc_weight": mx.nd.array(w)},
                             default_init=init_mod.One())
        a, b = mx.nd.zeros((3, 2)), mx.nd.zeros((4,))
        init("fc_weight", a)
        init("fc_bias_other", b)
        np.testing.assert_array_equal(a.asnumpy(), w)
        np.testing.assert_array_equal(b.asnumpy(), np.ones(4))
        with pytest.raises(ValueError):
            init_mod.Load({})("missing_weight", mx.nd.zeros((2,)))


@pytest.mark.parametrize("attr", [None, 2.5])
def test_lstm_bias_matches_jax(attr):
    attrs = {} if attr is None else {"__forget_bias__": str(attr)}
    jarr, tarr = jmx.nd.zeros((12,)), tmx.nd.zeros((12,))
    jinit.LSTMBias(forget_bias=0.5)(jinit.InitDesc("l0_i2h_bias", attrs),
                                    jarr)
    tinit.create("lstmbias", forget_bias=0.5)(
        tinit.InitDesc("l0_i2h_bias", attrs), tarr)
    np.testing.assert_array_equal(tarr.asnumpy(), jarr.asnumpy())
    assert tarr.asnumpy()[3:6].tolist() == [attr or 0.5] * 3


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_fused_rnn_matches_jax(mode):
    out = {}
    for pkg, mx, init_mod in (("jax", jmx, jinit), ("port", tmx, tinit)):
        assert init_mod._REGISTRY["fusedrnn"] is init_mod.FusedRNN
        init = init_mod.FusedRNN(init=init_mod.Constant(0.25), num_hidden=3,
                                 num_layers=1, mode=mode, forget_bias=2.0)
        b, w = mx.nd.zeros((12,)), mx.nd.zeros((12, 4))
        init(init_mod.InitDesc("rnn_l0_i2h_bias",
                               {"__forget_bias__": "7"}), b)
        init("rnn_l0_i2h_weight", w)
        out[pkg] = (b.asnumpy(), w.asnumpy())
        # the JSON form rebuilds the same initializer
        again = init_mod.FusedRNN(init=init._init.dumps(), num_hidden=3,
                                  num_layers=1, mode=mode)
        assert isinstance(again._init, init_mod.Constant)
    for j, t in zip(out["jax"], out["port"]):
        np.testing.assert_array_equal(t, j)


# ------------------------------------------------------------- gluon.utils
def test_split_data_and_load_match_jax():
    x = np.arange(30, dtype=np.float32).reshape(10, 3)
    for even in (True, False):
        n = 2 if even else 3
        jparts = jg.utils.split_data(jmx.nd.array(x), n, even_split=even)
        tparts = tg.utils.split_data(tmx.nd.array(x), n, even_split=even)
        assert [p.shape for p in tparts] == [p.shape for p in jparts]
        for a, b in zip(tparts, jparts):
            np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    with pytest.raises(ValueError):
        tg.utils.split_data(tmx.nd.array(x), 3)
    parts = tg.split_and_load(x, [tmx.cpu(), tmx.cpu()], batch_axis=1,
                              even_split=False)
    assert [p.shape for p in parts] == [(10, 1), (10, 2)]
    assert all(p.context == tmx.cpu() for p in parts)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_global_norm_matches_jax(max_norm):
    rng = np.random.RandomState(1)
    arrays = [rng.randn(4, 3).astype(np.float32),
              rng.randn(5).astype(np.float32)]
    ja = [jmx.nd.array(a) for a in arrays]
    ta = [tmx.nd.array(a) for a in arrays]
    jn = jg.utils.clip_global_norm(ja, max_norm)
    tn = tg.utils.clip_global_norm(ta, max_norm)
    np.testing.assert_allclose(tn, jn, rtol=1e-6)
    for a, b in zip(ta, ja):
        _close(a, b, 1e-5)
    with pytest.warns(UserWarning):
        tg.utils.clip_global_norm([tmx.nd.array(np.array([np.inf],
                                                         np.float32))], 1.0)


def test_sha1_download_and_replace_are_local(tmp_path):
    src = tmp_path / "blob.bin"
    src.write_bytes(b"mxnet" * 1000)
    sha = hashlib.sha1(src.read_bytes()).hexdigest()
    assert tg.utils.check_sha1(str(src), sha)
    assert not tg.utils.check_sha1(str(src), "0" * 40)
    # an existing file with its sha1 is returned as is: no fetch
    assert tg.utils.download("http://example.invalid/blob.bin",
                             path=str(src), sha1_hash=sha) == str(src)
    # a directory path takes the URL's file name; file:// copies
    (tmp_path / "d").mkdir()
    got = tg.utils.download("file://" + str(src), path=str(tmp_path / "d"))
    assert got == str(tmp_path / "d" / "blob.bin")
    assert tg.utils.check_sha1(got, sha)
    with pytest.raises(IOError):
        tg.utils.download("http://example.invalid/other.bin",
                          path=str(tmp_path / "other.bin"))
    tmp = tmp_path / "new.bin"
    tmp.write_bytes(b"x")
    tg.utils.replace_file(str(tmp), str(src))
    assert src.read_bytes() == b"x" and not tmp.exists()


@pytest.mark.parametrize("shape", [None, (), (0, 3), (2, 3), (4,), (3, 0)])
def test_shape_is_known_matches_jax(shape):
    assert tg.utils.shape_is_known(shape) == \
        jg.utils.shape_is_known(shape)


def test_hook_handle():
    hooks = {}
    for mod in (jg.utils, tg.utils):
        a, b = mod.HookHandle(), mod.HookHandle()
        a.attach(hooks, print)
        b.attach(hooks, print)
        assert len(hooks) == 2
        with pytest.raises(AssertionError):
            a.attach(hooks, print)
        with b:
            pass
        a.detach()
        assert hooks == {}


# ------------------------------------------------------------- the blocks
def _mlp(g, **kw):
    net = g.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(g.nn.Dense(5, in_units=4, activation="relu", **kw),
                g.nn.BatchNorm(in_channels=5, **kw),
                g.nn.Dense(2, **kw))
    return net


def test_summary_matches_jax(capsys):
    jnet, tnet = _mlp(jg), _mlp(tg)
    assert tnet.summary() == jnet.summary()
    jnet.initialize()
    tnet.initialize()
    jnet(jmx.nd.ones((3, 4)))
    tnet(tmx.nd.ones((3, 4)))
    out = tnet.summary(tmx.nd.ones((3, 4)))
    assert out == jnet.summary() and out.endswith("Total params: 57")
    assert out in capsys.readouterr().out


@pytest.mark.parametrize("monitor_all", [False, True])
def test_register_op_hook_matches_jax(monitor_all):
    x = np.random.RandomState(2).rand(3, 4).astype(np.float32)
    seen = {}
    for pkg, g, mx in (("jax", jg, jmx), ("port", tg, tmx)):
        net = _mlp(g)
        net.initialize(mx.init.One())
        calls = seen[pkg] = []
        net.register_op_hook(lambda n, a: calls.append((n, a.asnumpy())),
                             monitor_all)
        net.register_op_hook(lambda n, a: calls.append((n, a.asnumpy())),
                             monitor_all)      # replaces, does not add
        with (jag if pkg == "jax" else tag).record():
            net(mx.nd.array(x))
    assert [n for n, _ in seen["port"]] == [n for n, _ in seen["jax"]]
    for (n, a), (_, b) in zip(seen["port"], seen["jax"]):
        _close(a, b, 1e-5, n)


def test_reset_ctx_keeps_the_handle():
    net = _mlp(tg, device="cpu")
    net.initialize(tmx.init.Xavier())
    params = net.collect_params()
    dense = net[0]
    tensor, handle = dense.weight, params["mlp_dense0_weight"]
    before = handle.data().asnumpy()
    params.reset_ctx(tmx.cpu())
    handle.reset_ctx([tmx.cpu()])
    assert dense.weight is tensor and params["mlp_dense0_weight"] is handle
    assert handle.list_ctx() == [tmx.cpu()]
    np.testing.assert_array_equal(handle.data().asnumpy(), before)
    # still the module's storage: a write through the handle reaches it
    handle.set_data(np.zeros((5, 4), np.float32))
    assert float(dense.weight.abs().sum()) == 0.0
    # a deferred parameter allocates on the context it was moved to
    late = tg.nn.Dense(3)
    late.initialize()
    late.collect_params().reset_ctx(tmx.cpu())
    late(tmx.nd.ones((2, 7)))
    assert late.weight.device.type == "cpu" and late.weight.shape == (3, 7)


# ------------------------------------------------------------ gluon.contrib
@pytest.mark.parametrize("length,interval,rollover",
                         [(10, 3, True), (10, 3, False), (7, 7, True),
                          (12, 4, False)])
def test_interval_sampler_matches_jax(length, interval, rollover):
    from mxnet_tpu.gluon.contrib.data import IntervalSampler as J

    from mxnet_tpu_torch.gluon.contrib.data import IntervalSampler as T
    j, t = J(length, interval, rollover), T(length, interval, rollover)
    assert list(t) == list(j) and len(t) == len(j)
    with pytest.raises(ValueError):
        T(3, 4)


DEFORM = [dict(kernel=(3, 3), stride=(1, 1), dilate=(1, 1), pad=(1, 1),
               num_filter=4, num_group=1, num_deformable_group=1),
          dict(kernel=(3, 2), stride=(2, 1), dilate=(1, 2), pad=(1, 1),
               num_filter=6, num_group=2, num_deformable_group=2)]


@pytest.mark.parametrize("no_bias", [False, True])
@pytest.mark.parametrize("modulated", [False, True])
@pytest.mark.parametrize("case", [0, 1])
def test_deformable_convolution_op_and_grads_match_jax(case, modulated,
                                                       no_bias):
    p = dict(DEFORM[case], no_bias=no_bias)
    kh, kw = p["kernel"]
    dg, c, h, w = p["num_deformable_group"], 4, 7, 6
    oh = (h + 2 * p["pad"][0] - p["dilate"][0] * (kh - 1) - 1) \
        // p["stride"][0] + 1
    ow = (w + 2 * p["pad"][1] - p["dilate"][1] * (kw - 1) - 1) \
        // p["stride"][1] + 1
    rng = np.random.RandomState(case + 2 * modulated)
    arrays = [rng.randn(2, c, h, w),
              1.5 * rng.randn(2, 2 * dg * kh * kw, oh, ow)]   # some fall out
    if modulated:
        arrays.append(rng.rand(2, dg * kh * kw, oh, ow))
    arrays.append(rng.randn(p["num_filter"], c // p["num_group"], kh, kw))
    if not no_bias:
        arrays.append(rng.randn(p["num_filter"]))
    arrays = [a.astype(np.float32) for a in arrays]
    head = rng.randn(2, p["num_filter"], oh, ow).astype(np.float32)
    name = ("_contrib_ModulatedDeformableConvolution" if modulated
            else "_contrib_DeformableConvolution")
    res = {}
    for pkg, mx, ag in (("jax", jmx, jag), ("port", tmx, tag)):
        xs = [mx.nd.array(a) for a in arrays]
        for x in xs:
            x.attach_grad()
        with ag.record():
            y = getattr(mx.nd, name)(*xs, **p)
        y.backward(mx.nd.array(head))
        res[pkg] = [y] + [x.grad for x in xs]
    for i, (a, b) in enumerate(zip(res["port"], res["jax"])):
        _close(a, b, 1e-5, f"{name} case {case} output/grad {i}")


@pytest.mark.parametrize("cls", ["DeformableConvolution",
                                 "ModulatedDeformableConvolution"])
def test_deformable_layers_match_jax(cls):
    from mxnet_tpu.gluon.contrib import cnn as jcnn

    from mxnet_tpu_torch.gluon.contrib import cnn as tcnn
    from mxnet_tpu_torch.convert import params_from_mxnet
    kw = dict(kernel_size=3, padding=1, num_deformable_group=1,
              activation="relu")
    jnet = jg.nn.HybridSequential(prefix="net_")
    tnet = tg.nn.HybridSequential(prefix="net_")
    for net, mod in ((jnet, jcnn), (tnet, tcnn)):
        with net.name_scope():
            net.add(getattr(mod, cls)(5, **kw))
    rng = np.random.RandomState(4)
    x = rng.randn(2, 3, 6, 6).astype(np.float32)
    jnet.initialize(jmx.init.Xavier())
    tnet.initialize(tmx.init.Xavier())
    jnet(jmx.nd.array(x))
    tnet(tmx.nd.array(x))
    params = {k: rng.randn(*v.shape).astype(np.float32) * 0.3
              for k, v in jnet.collect_params().items()}
    assert sorted(params) == sorted(tnet.collect_params().keys())
    for k, v in jnet.collect_params().items():
        v.set_data(jmx.nd.array(params[k]))
    params_from_mxnet(params, tnet)
    for net, mx, ag in ((jnet, jmx, jag), (tnet, tmx, tag)):
        for p in net.collect_params().values():
            p.zero_grad()
        xin = mx.nd.array(x)
        with ag.record():
            y = net(xin)
        y.backward()
        net._y = y
    _close(tnet._y, jnet._y, 1e-5, "output")
    tp = tnet.collect_params()
    for k, v in jnet.collect_params().items():
        _close(tp[k].grad(), v.grad(), 1e-5, f"grad {k}")
    sym = tnet(tmx.sym.var("data"))
    assert sym.list_arguments()[0] == "data"
