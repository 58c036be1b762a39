"""Port parity: ``HybridBlock.export`` / ``SymbolBlock.imports`` across the
two packages, the layers' and the transformer blocks' symbolic forms,
``hybridize`` and the BERT blocks' names, on the CPU.

Blocks are built in both packages under the same explicit ``prefix=`` and
node counters are reset before each trace, so parameter and node names
agree.  Weights cross through the files themselves (an export's
``.params`` or ``save_parameters``, the shared ``.npz`` format) or
``convert.params_from_mxnet``.

Tolerance: fp32 outputs within 1e-5 of each tensor's largest |value| plus
1e-6 (XLA and PyTorch sum convolutions and products in other orders);
symbol JSON is compared exactly.
"""
import json
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.block import SymbolBlock as JSymbolBlock
from mxnet_tpu.gluon.contrib.nn import FusedConv1x1BN as JFused
from mxnet_tpu.gluon.model_zoo.language import bert as jbert
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
from mxnet_tpu.symbol.symbol import NameManager as JNames
from mxnet_tpu.symbol import trace_to_symbol as jtrace

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.convert import params_from_mxnet
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.block import SymbolBlock
from mxnet_tpu_torch.gluon.contrib.nn import FusedConv1x1BN as TFused
from mxnet_tpu_torch.gluon.model_zoo.language import bert as tbert
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from mxnet_tpu_torch.symbol import trace_to_symbol as ttrace
from mxnet_tpu_torch.symbol.symbol import NameManager as TNames

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


def _copy(jnet, tnet):
    params_from_mxnet({k: p.data().asnumpy()
                       for k, p in jnet.collect_params().items()}, tnet)


def _export(net, names, path):
    names.reset()
    net.export(path)
    with open(f"{path}-symbol.json") as f:
        return json.load(f)


# ----------------------------------------------- export -> import, both ways
def _small_resnets(fused, monkeypatch):
    """(JAX net, port net): resnet18_v1, or a two-stage bottleneck
    ResNetV1 built fused (every 1x1 conv + BN a FusedConv1x1BN, strides 1
    and 2); 10 classes."""
    monkeypatch.setenv("MXNET_TPU_FUSE_CONV_BN", str(int(fused)))
    jmx.random.seed(0)
    if fused:
        spec = ([1, 1], [8, 16, 32])
        jnet = jres.ResNetV1(jres.BottleneckV1, *spec, classes=10,
                             prefix="rn_")
        tnet = tres.ResNetV1(tres.BottleneckV1, *spec, classes=10,
                             prefix="rn_", device="cpu")
    else:
        jnet = jres.resnet18_v1(classes=10, prefix="rn_")
        tnet = tres.resnet18_v1(classes=10, prefix="rn_", device="cpu")
    jnet.collect_params().initialize(jmx.init.Xavier())
    return jnet, tnet


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_resnet_export_crosses_between_packages(fused, tmp_path,
                                                monkeypatch):
    """Each package's export loads in the other's SymbolBlock: the same
    node list (ops, names, inputs, attrs), the same parameter files, and
    outputs equal to both blocks'.  The fused export is the folded
    inference graph (``with_stats=False``)."""
    jnet, tnet = _small_resnets(fused, monkeypatch)
    x = np.random.RandomState(0).rand(2, 3, 32, 32).astype(np.float32)
    jref = jnet(jmx.nd.array(x))        # resolves the deferred shapes
    _copy(jnet, tnet)
    tout = tnet(tmx.nd.array(x))
    _close(tout, jref, what="blocks")
    jgraph = _export(jnet, JNames, str(tmp_path / "j"))
    tgraph = _export(tnet, TNames, str(tmp_path / "t"))
    assert tgraph == jgraph
    ops = {n["op"] for n in tgraph["nodes"]}
    assert ("_contrib_conv1x1_bn_stats" in ops) == fused
    if fused:
        assert all(json.loads(n["attrs"]["with_stats"]) is False
                   for n in tgraph["nodes"]
                   if n["op"] == "_contrib_conv1x1_bn_stats")
    with open(tmp_path / "j-signature.json") as a, \
            open(tmp_path / "t-signature.json") as b:
        assert json.load(a) == json.load(b)
    jparams = jmx.nd.load(str(tmp_path / "j-0000.params"))
    tparams = tmx.nd.load(str(tmp_path / "t-0000.params"))
    assert sorted(jparams) == sorted(tparams)
    assert all(k.startswith("aux:") == k.endswith(("running_mean",
                                                   "running_var"))
               for k in tparams)
    from_jax = SymbolBlock.imports(str(tmp_path / "j-symbol.json"), "data",
                                   str(tmp_path / "j-0000.params"))
    from_port = JSymbolBlock.imports(str(tmp_path / "t-symbol.json"),
                                     "data", str(tmp_path / "t-0000.params"))
    _close(from_jax(tmx.nd.array(x)), jref, what="port imports JAX export")
    _close(from_jax(tmx.nd.array(x)), tout, what="port import vs port")
    _close(from_port(jmx.nd.array(x)), tout, what="JAX imports port export")


def test_symbolblock_runs_the_graph_through_the_registry(tmp_path):
    """An imported block reads its parameters by name, keeps aux states
    out of the gradient, and follows autograd like any block."""
    net = tnn.HybridSequential(prefix="m_")
    with net.name_scope():
        net.add(tnn.Dense(4, activation="relu", in_units=6),
                tnn.BatchNorm(in_channels=4), tnn.Dense(2, in_units=4))
    net.initialize(tmx.init.Xavier())
    x = tmx.nd.array(np.random.RandomState(1).rand(3, 6).astype(np.float32))
    ref = net(x)
    net.export(str(tmp_path / "m"), epoch=3)
    blk = SymbolBlock.imports(str(tmp_path / "m-symbol.json"), ["data"],
                              str(tmp_path / "m-0003.params"))
    _close(blk(x), ref)
    params = blk.collect_params()
    assert params["m_batchnorm0_running_mean"].grad_req == "null"
    w = params["m_dense0_weight"]
    with tmx.autograd.record():
        loss = blk(x).sum()
    loss.backward()
    assert float(np.abs(w.grad().asnumpy()).sum()) > 0


# --------------------------------------------- each layer's symbolic form
def _layer_pairs():
    """name -> (JAX layer, port layer, input shape): the layers of the
    ResNet and MLP graphs, with their input widths given."""
    def both(make):
        return make(jnn, {}), make(tnn, {"device": "cpu"})
    return {
        "dense": (*both(lambda nn, d: nn.Dense(5, activation="tanh",
                                               in_units=12, prefix="l_",
                                               **d)), (2, 3, 4)),
        "dense_nobias_noflat": (*both(lambda nn, d: nn.Dense(
            5, use_bias=False, flatten=False, in_units=4, prefix="l_",
            **d)), (2, 3, 4)),
        "conv": (*both(lambda nn, d: nn.Conv2D(
            6, 3, strides=2, padding=1, groups=2, activation="relu",
            in_channels=4, prefix="l_", **d)), (2, 4, 7, 7)),
        "conv_nobias": (*both(lambda nn, d: nn.Conv2D(
            4, 1, use_bias=False, in_channels=3, prefix="l_", **d)),
            (2, 3, 5, 5)),
        "batchnorm": (*both(lambda nn, d: nn.BatchNorm(
            in_channels=3, prefix="l_", **d)), (4, 3, 5, 5)),
        "batchnorm_noscale": (*both(lambda nn, d: nn.BatchNorm(
            scale=False, in_channels=3, prefix="l_", **d)), (4, 3, 5, 5)),
        "layernorm": (*both(lambda nn, d: nn.LayerNorm(
            in_channels=6, prefix="l_", **d)), (2, 3, 6)),
        "activation": (*both(lambda nn, d: nn.Activation("relu",
                                                         prefix="l_")),
                       (2, 3, 4)),
        "maxpool": (*both(lambda nn, d: nn.MaxPool2D(3, 2, 1,
                                                     prefix="l_")),
                    (2, 3, 8, 8)),
        "avgpool": (*both(lambda nn, d: nn.AvgPool2D(
            3, 2, 1, ceil_mode=True, count_include_pad=False,
            prefix="l_")), (2, 3, 8, 8)),
        "globalavgpool": (*both(lambda nn, d: nn.GlobalAvgPool2D(
            prefix="l_")), (2, 3, 5, 5)),
        "flatten": (*both(lambda nn, d: nn.Flatten(prefix="l_")),
                    (2, 3, 2, 2)),
        "dropout": (*both(lambda nn, d: nn.Dropout(0.5, prefix="l_")),
                    (2, 3)),
        "fused": (JFused(6, in_channels=4, strides=2, relu=True,
                         prefix="l_"),
                  TFused(6, in_channels=4, strides=2, relu=True, prefix="l_",
                         device="cpu"), (2, 4, 6, 6)),
    }


LAYERS = sorted(_layer_pairs())


def _randomize_stats(jnet, seed):
    """Non-trivial moving statistics (JAX side) for the inference
    graphs."""
    rng = np.random.RandomState(seed)
    for name, p in jnet.collect_params().items():
        if name.endswith(("running_mean", "beta", "gamma")):
            p.set_data(jmx.nd.array(rng.randn(*p.shape).astype(np.float32)))
        elif name.endswith("running_var"):
            p.set_data(jmx.nd.array(rng.rand(*p.shape).astype(np.float32)
                                    + 0.5))


@pytest.mark.parametrize("name", LAYERS)
def test_layer_symbolic_form_matches_its_tensor_forward(name):
    """Each layer's traced graph, evaluated through the registry, equals
    its tensor ``forward`` on the same weights, and its JSON equals the
    JAX layer's (so the two forms cannot drift apart)."""
    jl, tl, shape = _layer_pairs()[name]
    jl.collect_params().initialize(jmx.init.Xavier())
    _randomize_stats(jl, 3)
    tl.initialize()
    _copy(jl, tl)
    JNames.reset()
    TNames.reset()
    jsym, tsym = jtrace(jl), ttrace(tl)
    assert json.loads(tsym.tojson()) == json.loads(jsym.tojson())
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    bindings = {"data": tmx.nd.array(x)}
    bindings.update({n: p.data() for n, p in tl.collect_params().items()})
    out = tsym.eval_with(bindings)
    import torch
    with torch.no_grad():
        tl.eval()
        ref = tl(torch.from_numpy(x))
    _close(out, ref.numpy(), what=name)


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_residual_blocks_symbolic_form(block, monkeypatch):
    """The model zoo's residual blocks trace to ``broadcast_add`` and
    ``Activation`` after the body, as the JAX blocks do."""
    monkeypatch.setenv("MXNET_TPU_FUSE_CONV_BN", "0")
    jcls, tcls = ((jres.BasicBlockV1, tres.BasicBlockV1) if block == "basic"
                  else (jres.BottleneckV1, tres.BottleneckV1))
    # the blocks name their layers in the enclosing scope (the model's
    # stage), else from per-process counters: give them a scope
    jscope, tscope = jnn.HybridSequential(prefix="s_"), \
        tnn.HybridSequential(prefix="s_")
    with jscope.name_scope():
        jb = jcls(8, 2, True, in_channels=4, prefix="b_")
    with tscope.name_scope():
        tb = tcls(8, 2, True, in_channels=4, prefix="b_", device="cpu")
    x = np.random.RandomState(4).randn(2, 4, 6, 6).astype(np.float32)
    jb.collect_params().initialize(jmx.init.Xavier())
    jb(jmx.nd.array(x))
    _randomize_stats(jb, 5)
    tb.initialize()
    _copy(jb, tb)
    JNames.reset()
    TNames.reset()
    jsym, tsym = jtrace(jb), ttrace(tb)
    assert json.loads(tsym.tojson()) == json.loads(jsym.tojson())
    assert tsym._outputs[0][0].op == "Activation"
    assert tsym._outputs[0][0].inputs[0][0].op == "broadcast_add"
    bindings = {"data": tmx.nd.array(x)}
    bindings.update({n: p.data() for n, p in tb.collect_params().items()})
    _close(tsym.eval_with(bindings), tb(tmx.nd.array(x)))


def test_batchnorm_training_graph_updates_like_the_layer():
    """The BatchNorm layer traced and run in a training Executor moves
    its statistics as the layer does in training."""
    bn = tnn.BatchNorm(in_channels=3, prefix="bn_", device="cpu")
    bn.initialize()
    sym = ttrace(bn)
    x = tmx.nd.array(np.random.RandomState(6).randn(8, 3, 4, 4)
                     .astype(np.float32))
    params = bn.collect_params()
    args = {"data": x, "bn_gamma": params["bn_gamma"].data(),
            "bn_beta": params["bn_beta"].data()}
    aux = {k: params[k].data().copy()
           for k in ("bn_running_mean", "bn_running_var")}
    ex = sym.bind(args=args, aux_states=aux, grad_req="null")
    out = ex.forward(is_train=True)[0]
    with tmx.autograd.record():
        ref = bn(x)
    _close(out, ref)
    for k in aux:
        _close(ex.aux_dict[k], params[k].data(), what=k)


# ------------------------------------------------------------- hybridize
def test_hybridize_routes_through_a_cached_op():
    """``hybridize()`` keys a CachedOp per input signature, training flag
    and parameter grad_req; outputs and gradients are the eager ones."""
    net = tnn.HybridSequential(prefix="h_")
    with net.name_scope():
        net.add(tnn.Dense(4, activation="relu", in_units=3),
                tnn.Dense(2, in_units=4))
    net.initialize()
    x = tmx.nd.array(np.random.RandomState(0).rand(5, 3).astype(np.float32))
    eager = net(x).asnumpy()
    net.hybridize()
    for _ in range(2):
        np.testing.assert_array_equal(net(x).asnumpy(), eager)
    net(x[:2])
    with tmx.autograd.record():
        loss = net(x).sum()
    loss.backward()
    w = net.collect_params()["h_dense0_weight"]
    assert float(np.abs(w.grad().asnumpy()).sum()) > 0
    stats = net._cached_op.cache_stats
    assert (stats["entries"], stats["misses"], stats["hits"]) == (3, 3, 1)
    sig = stats["signatures"][0]
    assert sig[0] == (((5, 3), "float32"),) and sig[1] is False
    assert ("h_dense0_weight", "write") in sig[2]


# ------------------------------------------ the transformer blocks' forms
def _transformer_pairs():
    """name -> (JAX block, port block, whether it takes valid_length):
    the encoder blocks at 16 units, 4 heads, 32 hidden."""
    from mxnet_tpu.gluon.model_zoo.language import transformer as jtr
    from mxnet_tpu_torch.gluon.model_zoo.language import transformer as ttr

    def both(make):
        return make(jtr, {}), make(ttr, {"device": "cpu"})
    return {
        "attention": (*both(lambda m, d: m.MultiHeadAttention(
            16, 4, prefix="attn_", **d)), True),
        "attention_causal": (*both(lambda m, d: m.MultiHeadAttention(
            16, 4, causal=True, prefix="attn_", **d)), True),
        "ffn": (*both(lambda m, d: m.PositionwiseFFN(
            16, 32, prefix="ffn_", **d)), False),
        "ffn_dropout": (*both(lambda m, d: m.PositionwiseFFN(
            16, 32, dropout=0.1, prefix="ffn_", **d)), False),
        "cell": (*both(lambda m, d: m.TransformerEncoderCell(
            16, 32, 4, prefix="cell_", **d)), True),
        "cell_dropout": (*both(lambda m, d: m.TransformerEncoderCell(
            16, 32, 4, dropout=0.1, prefix="cell_", **d)), True),
        "encoder": (*both(lambda m, d: m.TransformerEncoder(
            2, 16, 32, 4, prefix="enc_", **d)), True),
    }


TRANSFORMER_CASES = [(name, vl) for name, (_, _, takes_vl)
                     in sorted(_transformer_pairs().items())
                     for vl in ((False, True) if takes_vl else (False,))]


@pytest.mark.parametrize("name,with_valid_length", TRANSFORMER_CASES)
def test_transformer_symbolic_form_matches_its_tensor_forward(
        name, with_valid_length):
    """Each encoder block traced on variables gives the JAX block's JSON
    (``split``, ``flash_attention``, with ``valid_length`` when given),
    and its graph evaluated through the registry equals its tensor
    ``forward`` and the JAX block on the same weights."""
    import torch
    jb, tb, _ = _transformer_pairs()[name]
    jb.collect_params().initialize(jmx.init.Xavier())
    _copy(jb, tb)
    inputs = ["data", "valid_length"] if with_valid_length else ["data"]
    JNames.reset()
    TNames.reset()
    jsym, tsym = jtrace(jb, *inputs), ttrace(tb, *inputs)
    assert json.loads(tsym.tojson()) == json.loads(jsym.tojson())
    ops = {n.op for n in _nodes(tsym)}
    assert ("flash_attention" in ops) == (not name.startswith("ffn"))
    rng = np.random.RandomState(7)
    x = rng.randn(2, 6, 16).astype(np.float32)
    vl = np.array([6, 3], np.float32)
    args = [x, vl] if with_valid_length else [x]
    bindings = {n: tmx.nd.array(a) for n, a in zip(inputs, args)}
    bindings.update({n: p.data() for n, p in tb.collect_params().items()})
    out = tsym.eval_with(bindings)
    tb.eval()
    with torch.no_grad():
        ref = tb(*(torch.from_numpy(a) for a in args))
    _close(out, ref.numpy(), what=f"{name} graph vs tensor forward")
    _close(out, jb(*(jmx.nd.array(a) for a in args)),
           what=f"{name} graph vs JAX block")


def _nodes(sym):
    from mxnet_tpu_torch.symbol.symbol import _topo
    return [n for n in _topo(sym._outputs) if not n.is_var]


# ------------------------------------------------------------------ BERT
BERT_CFG = dict(vocab_size=50, units=32, hidden_size=64, num_layers=2,
                num_heads=4, max_length=16, dropout=0.0)


def test_bert_blocks_carry_the_jax_names_and_weights(tmp_path):
    """The BERT blocks have the JAX package's parameter names in its
    order; a JAX ``save_parameters`` file loads into the port's
    ``BERTModel`` with the same outputs, and the port's file into the
    JAX model."""
    jnet = jbert.BERTModel(prefix="bert_", **BERT_CFG)
    jnet.collect_params().initialize(jmx.init.Normal(0.02))
    tnet = tbert.BERTModel(prefix="bert_", device="cpu", **BERT_CFG)
    assert list(tnet.collect_params()) == list(jnet.collect_params())
    assert "bert_enc_layer1_attn_qkv_weight" in tnet.collect_params()
    tokens = np.random.RandomState(0).randint(0, 50, (3, 16)).astype(
        np.int32)
    types = (np.arange(16)[None] >= 8).astype(np.int32).repeat(3, 0)
    jout = jnet(jmx.nd.array(tokens, dtype="int32"),
                jmx.nd.array(types, dtype="int32"))
    jnet.save_parameters(str(tmp_path / "j.params"))
    tnet.load_parameters(str(tmp_path / "j.params"))
    tout = tnet(tmx.nd.array(tokens, dtype="int32"),
                tmx.nd.array(types, dtype="int32"))
    for t, j, what in zip(tout, jout, ("sequence", "pooled")):
        _close(t, j, what=what)
    tnet.save_parameters(str(tmp_path / "t.params"))
    jback = jbert.BERTModel(prefix="bert_", **BERT_CFG)
    jback.load_parameters(str(tmp_path / "t.params"))
    _close(jback(jmx.nd.array(tokens, dtype="int32"),
                 jmx.nd.array(types, dtype="int32"))[1], tout[1])
    pre = tbert.BERTForPretraining(prefix="pre_", device="cpu", **BERT_CFG)
    jpre = jbert.BERTForPretraining(prefix="pre_", **BERT_CFG)
    assert list(pre.collect_params()) == list(jpre.collect_params())


def test_bert_export_raises_in_both_packages(tmp_path):
    """Neither package can trace BERT (the reference reads
    ``inputs.shape``); the port says so instead of writing a graph."""
    jnet = jbert.BERTModel(**BERT_CFG)
    jnet.collect_params().initialize()
    with pytest.raises(AttributeError, match="shape"):
        jnet.export(str(tmp_path / "j"))
    tnet = tbert.BERTModel(device="cpu", **BERT_CFG)
    with pytest.raises(MXNetError, match="no symbolic form"):
        tnet.export(str(tmp_path / "t"))
    assert not os.path.exists(tmp_path / "t-symbol.json")
