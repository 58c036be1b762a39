"""Port parity: the symbolic training loop (``mx.module``, ``mx.model``
checkpoints, ``mx.callback``, the one-process kvstore under ``Module``)
against mxnet_tpu's, on the CPU.

The model is a 2-layer transformer encoder classifier (64 units, 4 heads,
128 hidden, vocab 100, seq 16, batch 8), built by calling each package's
Gluon blocks on ``mx.sym.var("data")`` under the same prefixes, with a
``SoftmaxOutput`` head.  Its parameters start from the port's seeded
Xavier draws and cross to the JAX package as numpy arrays; the data are
seeded numpy token ids (float32, as iterators give them) and 0/1 labels.
Also the tests of ``tests/test_module.py`` that need no CSV or
prefetching iterator.

Tolerance: fp32 values within 1e-5 of each tensor's largest |value| plus
1e-6 (XLA and PyTorch sum products in other orders, and six optimizer
steps carry that on).  Parameters trained with Adam: each element within
2·lr per step (as ``tests/test_torch_bert.py``), and at most 0.5% of the
elements beyond the fp32 bound above.  Adam divides each gradient
element by its own running RMS, so an element whose gradient is near the
packages' rounding gap (|g| about 1e-6 against a gap of 2.4e-7 in the
first step's gradients) takes a visibly different step: 122 of 78786
elements, at most 4.9e-5 after six steps at lr 1e-3.  Symbol JSON,
resumed SGD and the kvstore-free against the kvstore runs of one package
are compared exactly.
"""
import functools
import json
import logging
import re
import warnings

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.gluon import HybridBlock as JHybridBlock
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo.language.transformer import \
    TransformerEncoder as JEncoder
from mxnet_tpu.symbol.symbol import NameManager as JNames

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.gluon import HybridBlock as THybridBlock
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo.language.transformer import \
    TransformerEncoder as TEncoder
from mxnet_tpu_torch.io import DataBatch, NDArrayIter
from mxnet_tpu_torch.symbol.symbol import NameManager as TNames

REL = 1e-5
ENC = dict(vocab=100, units=64, heads=4, hidden=128, layers=2, seq=16,
           batch=8, rows=24)
OPT = {"sgd": {"learning_rate": 0.1, "momentum": 0.9,
               "rescale_grad": 1.0 / 8},
       "adam": {"learning_rate": 1e-3, "rescale_grad": 1.0 / 8}}
SIDES = {"jax": (jmx, jnn, JHybridBlock, JEncoder, JNames, {}),
         "port": (tmx, tnn, THybridBlock, TEncoder, TNames,
                  {"device": "cpu"})}


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)


def _close(got, ref, rel=REL, what=""):
    got = np.asarray(got.asnumpy() if hasattr(got, "asnumpy") else got,
                     np.float64)
    ref = np.asarray(ref.asnumpy() if hasattr(ref, "asnumpy") else ref,
                     np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    bound = rel * float(np.abs(ref).max(initial=0.0)) + 1e-6
    err = float(np.abs(got - ref).max(initial=0.0))
    assert err <= bound, f"{what}: max err {err} > {bound}"


def _close_params(got, ref, what=""):
    assert sorted(got) == sorted(ref)
    for name in ref:
        _close(got[name], ref[name], what=f"{what} {name}")


def _close_adam(got, ref, steps, what=""):
    """Adam-trained parameters: every element within 2·lr per step, and
    at most 0.5% beyond the fp32 bound (see the module docstring)."""
    assert sorted(got) == sorted(ref)
    over = total = 0
    for name in ref:
        diff = np.abs(got[name].astype(np.float64) - ref[name])
        assert diff.max() <= 2 * OPT["adam"]["learning_rate"] * steps, name
        over += int((diff > REL * np.abs(ref[name]).max() + 1e-6).sum())
        total += diff.size
    assert over <= 0.005 * total, f"{what}: {over} of {total} elements"


# -------------------------------------------------- the encoder classifier
def _classifier(side):
    """The encoder classifier's symbol, traced from ``side``'s blocks with
    fresh node counters."""
    mx, nn, HybridBlock, Encoder, names, dev = SIDES[side]
    units, seq = ENC["units"], ENC["seq"]

    class EncoderClassifier(HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.word_embed = nn.Embedding(ENC["vocab"], units,
                                               prefix="word_embed_", **dev)
                self.pos_weight = self.params.get("pos_weight",
                                                  shape=(1, seq, units))
                self.ln = nn.LayerNorm(epsilon=1e-12, in_channels=units,
                                       prefix="ln_", **dev)
                self.encoder = Encoder(ENC["layers"], units, ENC["hidden"],
                                       ENC["heads"], dropout=0.0,
                                       activation="gelu", prefix="enc_",
                                       **dev)
                self.pooler = nn.Dense(units, activation="tanh",
                                       in_units=units, prefix="pooler_",
                                       **dev)
                self.head = nn.Dense(2, in_units=units, prefix="head_",
                                     **dev)

        def hybrid_forward(self, F, x, pos_weight):
            h = self.encoder(self.ln(F.broadcast_add(self.word_embed(x),
                                                     pos_weight)))
            cls = F.reshape(F.slice_axis(h, axis=1, begin=0, end=1),
                            shape=(-1, units))
            return self.head(self.pooler(cls))

    names.reset()
    net = EncoderClassifier(prefix="cls_")
    return mx.sym.SoftmaxOutput(net(mx.sym.var("data")),
                                mx.sym.var("softmax_label"), name="softmax")


def _tokens(rows=ENC["rows"], seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, ENC["vocab"], (rows, ENC["seq"])).astype(np.float32)
    return x, rng.randint(0, 2, rows).astype(np.float32)


def _iter(side, rows=ENC["rows"], seed=0):
    return SIDES[side][0].io.NDArrayIter(*_tokens(rows, seed),
                                         batch_size=ENC["batch"])


@functools.lru_cache(maxsize=None)
def _initial_params():
    """The port's seeded Xavier draws for every parameter, as numpy."""
    tmx.random.seed(0)
    mod = tmx.module.Module(_classifier("port"), context=tmx.cpu())
    it = _iter("port")
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(tmx.init.Xavier())
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _nd_params(side, params):
    return {k: SIDES[side][0].nd.array(v) for k, v in params.items()}


def _numpy(params):
    return {k: v.asnumpy() for k, v in params.items()}


@functools.lru_cache(maxsize=None)
def _fit(side, opt, kvstore, num_epoch=2):
    """Parameters after ``num_epoch`` epochs from the initial ones."""
    mx = SIDES[side][0]
    mod = mx.module.Module(_classifier(side))
    mod.fit(_iter(side), num_epoch=num_epoch, optimizer=opt,
            optimizer_params=OPT[opt], kvstore=kvstore,
            arg_params=_nd_params(side, _initial_params()), aux_params={})
    return _numpy(mod.get_params()[0])


@functools.lru_cache(maxsize=None)
def _resumed(side, opt, tmp):
    """Epoch 0, a checkpoint with the optimizer states, then a new module
    from the checkpoint through epoch 1."""
    mx = SIDES[side][0]
    prefix = f"{tmp}/{side}_{opt}"
    mod = mx.module.Module(_classifier(side))
    mod.fit(_iter(side), num_epoch=1, optimizer=opt,
            optimizer_params=OPT[opt], kvstore="device",
            arg_params=_nd_params(side, _initial_params()), aux_params={})
    mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    sym, arg, aux = mx.model.load_checkpoint(prefix, 1)
    mod = mx.module.Module(sym)
    it = _iter(side)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params=arg, aux_params=aux)
    mod.init_optimizer(kvstore="device", optimizer=opt,
                       optimizer_params=OPT[opt])
    mod.load_optimizer_states(f"{prefix}-0001.states")
    mod.fit(it, begin_epoch=1, num_epoch=2, optimizer=opt,
            optimizer_params=OPT[opt], kvstore="device")
    return _numpy(mod.get_params()[0])


def test_encoder_classifier_traces_to_the_jax_graph():
    jsym, tsym = _classifier("jax"), _classifier("port")
    assert json.loads(tsym.tojson()) == json.loads(jsym.tojson())
    ops = {n["op"] for n in json.loads(tsym.tojson())["nodes"]}
    assert ops == {"null", "Activation", "Embedding", "FullyConnected",
                   "LayerNorm", "SoftmaxOutput", "broadcast_add",
                   "flash_attention", "reshape", "slice_axis", "split"}
    assert tsym.list_arguments() == jsym.list_arguments()
    assert "cls_enc_layer1_attn_qkv_weight" in tsym.list_arguments()


@pytest.mark.parametrize("kvstore", ["local", "device", None])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_fit_matches_jax(opt, kvstore):
    """Two epochs of ``Module.fit`` give the JAX package's parameters
    with each kvstore; within the port, each kvstore gives the same bits
    as no kvstore."""
    got = _fit("port", opt, kvstore)
    ref = _fit("jax", opt, kvstore)
    if opt == "adam":
        _close_adam(got, ref, steps=6, what=f"adam/{kvstore}")
    else:
        _close_params(got, ref, what=f"sgd/{kvstore}")
    moved = max(np.abs(got[k] - v).max() for k, v in
                _initial_params().items())
    assert moved > 1e-3
    if kvstore is not None:
        for k, v in _fit("port", opt, None).items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_fit_over_dist_sync_in_one_process():
    """``Module.fit`` over ``dist_sync`` in one process: per-key push and
    pull through the dist store, which reduces locally, so the same bits
    as the ``'device'`` store, and the JAX package's parameters.  Jobs of
    several processes: ``tests/test_torch_dist_kvstore.py``."""
    got = _fit("port", "sgd", "dist_sync")
    for k, v in _fit("port", "sgd", "device").items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    _close_params(got, _fit("jax", "sgd", "dist_sync"), what="dist_sync")


def test_fit_with_eval_data_of_another_batch_size():
    """Training batches of 8 and ``eval_data`` in batches of 12, then
    ``predict`` and ``score`` at other batch sizes: the executor runs each
    batch at its own shape, as the JAX package's does."""
    X, Y = _toy_data(n=48)
    got = {}
    for side in SIDES:
        mx = SIDES[side][0]
        mod = mx.module.Module(_mlp_softmax(mx))
        mod.fit(mx.io.NDArrayIter(X, Y, batch_size=8),
                eval_data=mx.io.NDArrayIter(X, Y, batch_size=12),
                num_epoch=2, optimizer="sgd",
                optimizer_params={"learning_rate": 0.5,
                                  "rescale_grad": 1.0 / 8},
                arg_params=_nd_params(side, _mlp_params()), aux_params={})
        pred = mod.predict(mx.io.NDArrayIter(X, Y, batch_size=12))
        score = mod.score(mx.io.NDArrayIter(X, Y, batch_size=5), "acc")
        got[side] = (_numpy(mod.get_params()[0]), pred.asnumpy(), score)
    assert got["port"][1].shape == (48, 3)
    _close_params(got["port"][0], got["jax"][0], what="params")
    _close(got["port"][1], got["jax"][1], what="predict")
    assert got["port"][2] == got["jax"][2]


def test_sgd_resume_is_exact(tmp_path):
    """SGD with momentum resumed from a checkpoint and its optimizer
    states gives the uninterrupted run's parameters, bit for bit, in the
    port, and the JAX package's resumed ones."""
    got = _resumed("port", "sgd", str(tmp_path))
    for k, v in _fit("port", "sgd", "device").items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    _close_params(got, _resumed("jax", "sgd", str(tmp_path)), what="sgd")


def test_adam_resume_matches_jax(tmp_path):
    """Adam's states file holds no update counts, so its bias correction
    restarts on resume in both packages: the resumed parameters equal
    the JAX package's resumed ones, not the uninterrupted run's."""
    got = _resumed("port", "adam", str(tmp_path))
    _close_adam(got, _resumed("jax", "adam", str(tmp_path)), steps=6,
                what="adam resumed")
    straight = _fit("port", "adam", "device")
    assert max(np.abs(got[k] - v).max() for k, v in straight.items()) > 1e-5


def _bound(side, params, rows=20, for_training=False):
    mx = SIDES[side][0]
    mod = mx.module.Module(_classifier(side))
    it = _iter(side, rows=rows, seed=3)
    mod.bind(it.provide_data, it.provide_label, for_training=for_training)
    mod.init_params(arg_params=_nd_params(side, params), aux_params={})
    return mod, it


def test_score_and_predict_with_a_padded_last_batch():
    """20 rows in batches of 8: the last batch pads 4, ``predict`` cuts
    them and merges, ``score`` counts the padded rows as the JAX package
    does."""
    outs = {}
    for side in SIDES:
        mod, it = _bound(side, _fit("port", "sgd", "device"))
        pred = mod.predict(it)
        per_batch = mod.predict(it, merge_batches=False)
        assert [len(b[0]) for b in per_batch] == [8, 8, 4]
        assert len(list(mod.iter_predict(it))) == 3
        outs[side] = (pred.asnumpy(), mod.score(it, "acc"))
    assert outs["port"][0].shape == (20, 2)
    _close(outs["port"][0], outs["jax"][0], what="predict")
    assert outs["port"][1] == outs["jax"][1]


def test_checkpoints_cross_between_packages(tmp_path):
    """A checkpoint written by either package loads in the other
    (``Module.load``) with the same outputs."""
    params = _fit("port", "adam", "device")
    preds = {}
    for side in SIDES:
        mod, it = _bound(side, params)
        mod.save_checkpoint(str(tmp_path / side), 2)
        preds[side] = mod.predict(it).asnumpy()
    for side, other in (("port", "jax"), ("jax", "port")):
        mx = SIDES[side][0]
        mod = mx.module.Module.load(str(tmp_path / other), 2)
        it = _iter(side, rows=20, seed=3)
        mod.bind(it.provide_data, it.provide_label, for_training=False)
        _close(mod.predict(it), preds[other], what=f"{side} loads {other}")
    sym, arg, aux = tmx.load_checkpoint(str(tmp_path / "jax"), 2)
    assert sym.tojson() == _classifier("port").tojson() and aux == {}
    _close_params(_numpy(arg), params, what="JAX file")


def test_callbacks_speedometer_checkpoint_and_train_metric(tmp_path,
                                                           caplog):
    """``Speedometer``, ``log_train_metric`` and ``do_checkpoint`` during
    ``fit``: the same log lines as the JAX package's (speeds aside) and
    each epoch's checkpoint with that epoch's parameters."""
    lines, files = {}, {}
    for side in SIDES:
        mx = SIDES[side][0]
        caplog.clear()
        prefix = str(tmp_path / side)
        mod = mx.module.Module(_classifier(side))
        with caplog.at_level(logging.INFO):
            mod.fit(_iter(side), num_epoch=2, optimizer="sgd",
                    optimizer_params=OPT["sgd"], kvstore="local",
                    arg_params=_nd_params(side, _initial_params()),
                    aux_params={},
                    batch_end_callback=[mx.callback.Speedometer(8, 2),
                                        mx.callback.log_train_metric(2)],
                    epoch_end_callback=mx.callback.do_checkpoint(prefix))
        lines[side] = [re.sub(r"Speed: [0-9.]+", "Speed: S",
                              re.sub(r"Time cost=[0-9.]+", "Time cost=T",
                                     r.getMessage()))
                       for r in caplog.records]
        files[side] = [tmx.model.load_params(prefix, e)[0]
                       for e in (1, 2)]
        final = _numpy(mod.get_params()[0])
        _close_params(_numpy(files[side][1]), final, what="epoch 2 file")
    assert lines["port"] == lines["jax"]
    assert sum("Speed: S samples/sec\taccuracy=" in m
               for m in lines["port"]) == 2
    assert sum(m.startswith("Iter[") and "Train-accuracy" in m
               for m in lines["port"]) == 4
    for got, ref in zip(files["port"], files["jax"]):
        _close_params(_numpy(got), _numpy(ref), what="checkpoint")
    with open(tmp_path / "port-symbol.json") as a, \
            open(tmp_path / "jax-symbol.json") as b:
        assert json.load(a) == json.load(b)


def test_validation_callbacks_params_files_and_module_checkpoint(tmp_path,
                                                                 caplog):
    """``fit`` with ``eval_data``: ``LogValidationMetricsCallback`` and
    ``ProgressBar`` log as the JAX package's; ``module_checkpoint`` saves
    the parameters and optimizer states each epoch; ``save_params`` /
    ``load_params`` carry the parameters into a fresh bound module."""
    lines = {}
    for side in SIDES:
        mx = SIDES[side][0]
        caplog.clear()
        prefix = str(tmp_path / side)
        mod = mx.module.Module(_classifier(side))
        with caplog.at_level(logging.INFO):
            mod.fit(_iter(side), eval_data=_iter(side, rows=20, seed=3),
                    num_epoch=2, optimizer="sgd", optimizer_params=OPT["sgd"],
                    arg_params=_nd_params(side, _initial_params()),
                    aux_params={},
                    epoch_end_callback=mx.callback.module_checkpoint(
                        mod, prefix, save_optimizer_states=True),
                    eval_end_callback=mx.callback.LogValidationMetricsCallback(),
                    eval_batch_end_callback=mx.callback.ProgressBar(3, 10))
        lines[side] = [re.sub(r"Time cost=[0-9.]+", "Time cost=T",
                              r.getMessage()) for r in caplog.records]
        mod.save_params(prefix + ".params")
        fresh = mx.module.Module(_classifier(side))
        it = _iter(side, rows=20, seed=3)
        fresh.bind(it.provide_data, it.provide_label, for_training=False)
        fresh.load_params(prefix + ".params")
        _close(fresh.predict(it), mod.predict(it), what=f"{side} load_params")
    assert lines["port"] == lines["jax"]
    assert sum("Validation-accuracy" in m for m in lines["port"]) == 4
    assert sum(m.startswith("[") and m.endswith("%\r")
               for m in lines["port"]) == 6
    saved = tmx.model.load_params(str(tmp_path / "port"), 2)[0]
    _close_params(_numpy(saved), _fit("port", "sgd", "local"), what="epoch 2")
    assert (tmp_path / "port-0002.states").exists()


def test_module_surface():
    """What ``Module`` raises or ignores, as the JAX package's does."""
    mod, it = _bound("port", _initial_params(), for_training=True)
    assert mod.get_states() == [] and mod.output_names == ["softmax_output"]
    with pytest.raises(MXNetError, match="monitor"):
        mod.install_monitor(object())
    with pytest.raises(MXNetError, match="A10"):
        mod.fit(it, num_epoch=1, prefetch_to_device=True)
    mod.reshape([("data", (4, ENC["seq"]))], [("softmax_label", (4,))])
    assert mod.data_shapes[0].shape == (4, ENC["seq"])
    mod.forward(DataBatch([tmx.nd.ones((4, ENC["seq"]))],
                          [tmx.nd.zeros((4,))]), is_train=False)
    assert mod.output_shapes == [("softmax_output", (4, 2))]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tmx.module.Module(_classifier("port"), group2ctxs={"a": tmx.cpu()})
    assert any("group2ctxs" in str(x.message) for x in w)


# ------------------------------------------- the tests of test_module.py
def _toy_data(n=200, d=10, classes=3, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.uniform(-1, 1, size=(n, d)).astype(np.float32)
    W = rng.uniform(-1, 1, size=(d, classes)).astype(np.float32)
    return X, np.argmax(X @ W, axis=1).astype(np.float32)


def _mlp_softmax(mx=tmx):
    data = mx.sym.var("data")
    fc1 = mx.sym.FullyConnected(data, mx.sym.var("fc1_weight"),
                                mx.sym.var("fc1_bias"), num_hidden=32,
                                name="fc1")
    act = mx.sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = mx.sym.FullyConnected(act, mx.sym.var("fc2_weight"),
                                mx.sym.var("fc2_bias"), num_hidden=3,
                                name="fc2")
    return mx.sym.SoftmaxOutput(fc2, mx.sym.var("softmax_label"),
                                name="softmax")


def test_module_fit_convergence():
    X, Y = _toy_data()
    train = NDArrayIter(X, Y, batch_size=20, shuffle=True)
    val = NDArrayIter(X, Y, batch_size=20)
    mod = tmx.module.Module(_mlp_softmax())
    mod.fit(train, eval_data=val, num_epoch=15, optimizer="sgd",
            optimizer_params={"learning_rate": 0.5, "momentum": 0.9,
                              "rescale_grad": 1.0 / 20}, kvstore="local")
    score = mod.score(val, "acc")
    assert score[0][1] > 0.9, score


def test_module_predict_and_checkpoint(tmp_path):
    X, Y = _toy_data(n=60)
    val = NDArrayIter(X, Y, batch_size=20)
    mod = tmx.module.Module(_mlp_softmax())
    mod.bind(val.provide_data, val.provide_label, for_training=False)
    mod.init_params()
    assert mod.predict(val).shape == (60, 3)
    prefix = str(tmp_path / "ckpt")
    mod.save_checkpoint(prefix, 3)
    mod2 = tmx.module.Module.load(prefix, 3, load_optimizer_states=True)
    mod2.bind(val.provide_data, val.provide_label, for_training=False)
    assert mod2.score(val, "acc") == mod.score(val, "acc")
    _close(mod2.predict(val), mod.predict(val))


def test_module_with_device_kvstore():
    X, Y = _toy_data(n=80)
    mod = tmx.module.Module(_mlp_softmax())
    mod.fit(NDArrayIter(X, Y, batch_size=16), num_epoch=8, optimizer="sgd",
            optimizer_params={"learning_rate": 0.5, "momentum": 0.9,
                              "rescale_grad": 1.0 / 16}, kvstore="device")
    score = mod.score(NDArrayIter(X, Y, batch_size=16), "acc")
    assert score[0][1] > 0.8, score


def _mlp_params(seed=0):
    rng = np.random.RandomState(seed)
    shapes = {"fc1_weight": (32, 10), "fc1_bias": (32,),
              "fc2_weight": (3, 32), "fc2_bias": (3,)}
    return {k: rng.uniform(-0.5, 0.5, s).astype(np.float32)
            for k, s in shapes.items()}


def test_module_inputs_need_grad():
    """The data's gradient (``inputs_need_grad``) equals the JAX
    package's; the parameters' too."""
    x = np.random.RandomState(1).randn(4, 10).astype(np.float32)
    y = np.array([0, 2, 1, 2], np.float32)
    got = {}
    for side in SIDES:
        mx = SIDES[side][0]
        mod = mx.module.Module(_mlp_softmax(mx))
        mod.bind([("data", (4, 10))], [("softmax_label", (4,))],
                 for_training=True, inputs_need_grad=True)
        mod.init_params(arg_params=_nd_params(side, _mlp_params()))
        mod.forward(mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(y)]),
                    is_train=True)
        mod.backward()
        (dgrad,) = mod.get_input_grads()
        got[side] = (dgrad.asnumpy(),
                     mod._exec.grad_dict["fc1_weight"].asnumpy())
    assert np.abs(got["port"][0]).sum() > 0
    for g, r in zip(got["port"], got["jax"]):
        _close(g, r)


def test_bucketing_module():
    """Buckets of two sequence lengths share one weight: trained in turn
    through ``BucketingModule``, the outputs and the shared weight equal
    the JAX package's."""
    def sym_gen(mx):
        def gen(seq_len):
            fc = mx.sym.FullyConnected(mx.sym.var("data"), mx.sym.var("w"),
                                       mx.sym.var("b"), num_hidden=4,
                                       flatten=False, name="fc")
            out = mx.sym.SoftmaxOutput(mx.sym.mean(fc, axis=1),
                                       mx.sym.var("softmax_label"),
                                       name="softmax")
            return out, ("data",), ("softmax_label",)
        return gen

    rng = np.random.RandomState(2)
    w = rng.randn(4, 6).astype(np.float32)
    xs = {k: rng.randn(2, k, 6).astype(np.float32) for k in (10, 5)}
    got = {}
    for side in SIDES:
        mx = SIDES[side][0]
        mod = mx.module.BucketingModule(sym_gen(mx), default_bucket_key=10,
                                        context=mx.cpu())
        mod.bind([("data", (2, 10, 6))], [("softmax_label", (2,))])
        mod.init_params(arg_params={"w": mx.nd.array(w),
                                    "b": mx.nd.zeros((4,))})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1,
                                             "momentum": 0.9})
        outs = []
        for key in (10, 5, 10, 5):
            batch = mx.io.DataBatch(
                [mx.nd.array(xs[key])], [mx.nd.array([1.0, 3.0])],
                bucket_key=key,
                provide_data=[mx.io.DataDesc("data", (2, key, 6))],
                provide_label=[mx.io.DataDesc("softmax_label", (2,))])
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
            outs.append(mod.get_outputs()[0].asnumpy())
        got[side] = outs + [mod.get_params()[0]["w"].asnumpy()]
        mod.prepare(mx.io.DataBatch(
            [mx.nd.zeros((2, 7, 6))], [mx.nd.zeros((2,))], bucket_key=7,
            provide_data=[mx.io.DataDesc("data", (2, 7, 6))],
            provide_label=[mx.io.DataDesc("softmax_label", (2,))]))
        assert sorted(mod._buckets) == [5, 7, 10]
        assert mod._curr_bucket_key == 5   # prepare switches back
    assert got["port"][0].shape == (2, 4)
    for g, r in zip(got["port"], got["jax"]):
        _close(g, r)


def test_init_params_allow_missing_contract():
    mod = tmx.module.Module(_mlp_softmax())
    mod.bind(data_shapes=[("data", (10, 10))],
             label_shapes=[("softmax_label", (10,))])
    partial = {"fc1_weight": tmx.nd.ones((32, 10))}
    with pytest.raises(MXNetError):
        mod.init_params(arg_params=partial, allow_missing=False)
    mod.init_params(initializer=tmx.initializer.One(), arg_params=partial,
                    allow_missing=True, force_init=True)
    np.testing.assert_allclose(mod._exec.arg_dict["fc1_weight"].asnumpy(), 1)
    np.testing.assert_allclose(mod._exec.arg_dict["fc2_weight"].asnumpy(), 1)
    np.testing.assert_allclose(mod._exec.arg_dict["fc2_bias"].asnumpy(), 0)


def test_init_params_pass_variable_attrs_to_the_initializer():
    """A variable's ``__init__`` attribute names its initializer
    (``InitDesc(name, attrs=)``), whatever the module's."""
    data = tmx.sym.var("data")
    w = tmx.sym.var("fc_weight", attr={"__init__": "ones"})
    sym = tmx.sym.SoftmaxOutput(
        tmx.sym.FullyConnected(data, w, num_hidden=3, name="fc"),
        tmx.sym.var("softmax_label"), name="softmax")
    mod = tmx.module.Module(sym)
    mod.bind([("data", (2, 4))], [("softmax_label", (2,))])
    mod.init_params(tmx.init.Zero())
    arg, _ = mod.get_params()
    np.testing.assert_array_equal(arg["fc_weight"].asnumpy(), 1.0)
    np.testing.assert_array_equal(arg["fc_bias"].asnumpy(), 0.0)


def test_feedforward_legacy_api(tmp_path):
    rng = np.random.RandomState(0)
    Y = rng.randint(0, 2, 64).astype("float32")
    X = rng.randn(64, 8).astype("float32")
    X[:, 0] += 4 * Y
    net = tmx.sym.SoftmaxOutput(
        tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=2,
                               name="fc"),
        tmx.sym.Variable("softmax_label"), name="softmax")
    ff = tmx.model.FeedForward(net, num_epoch=8, learning_rate=0.5,
                               numpy_batch_size=16)
    ff.fit(X, Y)
    preds = ff.predict(X)
    assert (preds.argmax(1) == Y).mean() > 0.9
    assert ff.score(NDArrayIter(X, Y, batch_size=16)) > 0.9
    out, data, label = ff.predict(X[:20], return_data=True)
    assert out.shape == (20, 2) and data.shape == (20, 8) and label is None
    prefix = str(tmp_path / "ff")
    ff.save(prefix, 3)
    ff2 = tmx.model.FeedForward.load(prefix, 3)
    np.testing.assert_allclose(ff2.predict(X), preds, atol=1e-5)
    arg_p, _ = tmx.model.load_params(prefix, 3)
    assert "fc_weight" in arg_p
