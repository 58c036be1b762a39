"""Port parity: AMP (``mx.contrib.amp`` / ``mx.amp``) against mxnet_tpu's,
on CPU tensors.

Each case of ``tests/test_amp.py`` runs in both packages on the same
seeded numpy inputs and weights; then the dtype that reaches every listed
op of a 2-layer BERT (units 64, 2 heads, seq 16) under
``amp.init("float16")`` and ``"bfloat16"``, through eager Gluon,
``hybridize()`` and ``convert_model`` + ``Module`` (its encoder
classifier), against the JAX package's; and the ``loss_scale`` sequence of
a thumbnail fused ResNet-50 v1 over 4 Gluon steps under ``scale_loss``.

Tolerances, each against the reference's value:

- fp32 values: 1e-5 of the tensor's largest |value| (the same arithmetic,
  summed in other orders);
- bf16 values: 2^-7 of the largest |value| (one bf16 ulp at the top
  binade: each package rounds to bf16 after fp32 sums taken in other
  orders); fp16 values 2^-10 likewise;
- loss scales, skip decisions and dtypes: exact.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.contrib.amp.amp as jamp_mod
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.contrib import amp as jamp
from mxnet_tpu.gluon.model_zoo.language import BERTForPretraining as JaxBert
from mxnet_tpu.gluon.model_zoo.language.transformer import \
    TransformerEncoder as JEncoder
from mxnet_tpu.symbol.symbol import NameManager as JNames

import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.contrib.amp.amp as tamp_mod
from mxnet_tpu_torch import amp as tamp_top
from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch.contrib import amp as tamp
from mxnet_tpu_torch.convert import bert_state_dict_from_mxnet
from mxnet_tpu_torch.gluon.model_zoo.language import BERTForPretraining
from mxnet_tpu_torch.gluon.model_zoo.language.transformer import \
    TransformerEncoder as TEncoder
from mxnet_tpu_torch.symbol.symbol import NameManager as TNames

REL = {"float32": 1e-5, "bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
BERT = dict(units=64, hidden_size=128, num_layers=2, num_heads=2,
            max_length=16, dropout=0.0)
VOCAB, SEQ, BATCH = 100, 16, 2
# the listed ops whose input dtypes the probe compares (flash_attention is
# in no list: it takes what the FullyConnected before it made)
PROBED = (tamp.lists.LOW_PRECISION_OPS | tamp.lists.FP32_OPS
          | {"flash_attention"})
PACKAGES = {"jax": (jmx, jgluon, jamp, jautograd),
            "port": (tmx, tgluon, tamp, tautograd)}


@pytest.fixture(autouse=True)
def _cpu_and_amp_off():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)
    jamp.deinit()
    tamp.deinit()


def _np(x):
    if isinstance(x, np.ndarray):
        return x.astype(np.float32)
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return x.astype("float32").asnumpy()


def _dt(x):
    return str(x.dtype).replace("torch.", "")


def _close(got, ref, dtype="float32", what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    bound = REL[dtype] * float(np.abs(ref).max(initial=0.0)) + 1e-7
    err = float(np.abs(got - ref).max(initial=0.0))
    assert err <= bound, f"{what}: max err {err} > {bound}"


def _copy_params(jnet, tnet):
    """The JAX block's values into the port's, parameter by parameter in
    registration order."""
    for jp, tp in zip(jnet.collect_params().values(),
                      tnet.collect_params().values()):
        tp.set_data(tmx.nd.array(jp.data().asnumpy()))


def _weight(net):
    return next(p for n, p in net.collect_params().items()
                if n.endswith("weight"))


# --------------------------------------------------------------------------
# the cases of tests/test_amp.py
# --------------------------------------------------------------------------
def test_convert_block_dtypes():
    """Norm parameters stay fp32, the rest bf16; the bf16 forward agrees."""
    nets, outs = {}, {}
    x = np.random.RandomState(0).rand(2, 3, 8, 8).astype(np.float32)
    for side, (mx, gluon, amp, _) in PACKAGES.items():
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Conv2D(8, 3, padding=1), gluon.nn.BatchNorm(),
                gluon.nn.Activation("relu"), gluon.nn.Dense(4))
        net.initialize()
        net(mx.nd.array(x))
        nets[side] = net
    _copy_params(nets["jax"], nets["port"])
    for side, (mx, gluon, amp, _) in PACKAGES.items():
        amp.convert_block(nets[side], "bfloat16")
        dtypes = {n.split("_", 1)[1]: _dt(p.data())
                  for n, p in nets[side].collect_params().items()}
        for name, dt in dtypes.items():
            want = ("float32" if name.endswith(
                ("gamma", "beta", "running_mean", "running_var"))
                else "bfloat16")
            assert dt == want, (side, name, dt)
        outs[side] = nets[side](mx.nd.array(x).astype("bfloat16"))
    assert _dt(outs["port"]) == _dt(outs["jax"])
    assert np.isfinite(_np(outs["port"])).all()
    _close(outs["port"], outs["jax"], "bfloat16", "forward")


@pytest.mark.parametrize("target", ["bfloat16", "float16"])
def test_autocast_op_lists(target):
    """dot to the target, softmax back to fp32, broadcast_add to the
    widest; fp32 again after deinit."""
    rng = np.random.RandomState(1)
    a, b = (rng.randn(4, 4).astype(np.float32) for _ in range(2))
    res = {}
    for side, (mx, _, amp, _) in PACKAGES.items():
        amp.init(target)
        try:
            out = mx.nd.dot(mx.nd.array(a), mx.nd.array(b))
            s = mx.nd.softmax(out)
            w = mx.nd.broadcast_add(out, s)
            res[side] = (out, s, w)
        finally:
            amp.deinit()
        assert _dt(mx.nd.dot(mx.nd.array(a), mx.nd.array(b))) == "float32"
    for name, got, ref in zip(("dot", "softmax", "broadcast_add"),
                              res["port"], res["jax"]):
        assert _dt(got) == _dt(ref), name
        _close(got, ref, target, name)
    assert [_dt(t) for t in res["port"]] == [target, "float32", "float32"]


def test_loss_scaler_dynamics():
    seqs = {}
    for side, (_, _, amp, _) in PACKAGES.items():
        sc = amp.LossScaler(init_scale=1024.0, growth_interval=2)
        seq = []
        for skip in (False, False, True, False, True, True, False, False):
            sc.update_scale(skip=skip)
            seq.append(sc.loss_scale)
        seqs[side] = seq
        defaults = (amp.LossScaler(target_dtype="bfloat16"),
                    amp.LossScaler(target_dtype="float16"))
        assert [(d.loss_scale, d.dynamic) for d in defaults] == [
            (1.0, False), (2.0 ** 15, True)]
    assert seqs["port"] == seqs["jax"]
    assert seqs["port"][:3] == [1024.0, 2048.0, 1024.0]


def test_scale_loss_and_overflow_skip():
    rng = np.random.RandomState(2)
    x = rng.rand(3, 5).astype(np.float32)
    nets = {}
    for side, (mx, gluon, _, _) in PACKAGES.items():
        nets[side] = gluon.nn.Dense(2)
        nets[side].initialize()
        nets[side](mx.nd.array(x))
    _copy_params(nets["jax"], nets["port"])
    for side, (mx, gluon, amp, autograd) in PACKAGES.items():
        net = nets[side]
        with autograd.record():
            loss = net(mx.nd.array(x)).sum()
        loss.backward()
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1}, kvstore=None)
        trainer._amp_loss_scaler = amp.LossScaler(init_scale=4.0,
                                                  growth_interval=100)
        with amp.scale_loss(loss, trainer) as scaled:
            _close(scaled, loss * 4.0, what=f"{side} scaled")
        w = _weight(net)
        before = w.data().asnumpy().copy()
        w.grad()[:] = mx.nd.full(w.grad().shape, np.inf)
        trainer.step(1)
        np.testing.assert_array_equal(w.data().asnumpy(), before)
        assert trainer._amp_loss_scaler.loss_scale == 2.0
        assert trainer._scale == 1.0  # the folded 1/4 was undone
        # a finite step after the skip updates, at the halved scale
        with autograd.record():
            loss = net(mx.nd.array(x)).sum()
        with amp.scale_loss(loss, trainer) as scaled:
            scaled.backward()
        trainer.step(1)
    _close(_weight(nets["port"]).data(), _weight(nets["jax"]).data(),
           what="after the finite step")


def _fc_binds(mx):
    rng = np.random.RandomState(0)
    return {"data": mx.nd.array(rng.randn(4, 8).astype("float32")),
            "fc1_weight": mx.nd.array(rng.randn(3, 8).astype("float32")),
            "fc1_bias": mx.nd.zeros((3,))}


@pytest.mark.parametrize("policy, want", [
    ({}, "bfloat16"), ({"fp32_ops": ["FullyConnected"]}, "float32"),
    ({"excluded_sym_names": ["fc1"]}, "float32")])
def test_convert_symbol_policy_executed(policy, want):
    """The policy convert_symbol records decides the executed precision:
    FC low by default, fp32 when fp32_ops names it or its node is
    excluded; the unconverted symbol stays fp32."""
    outs = {}
    for side, (mx, _, amp, _) in PACKAGES.items():
        net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=3,
                                    name="fc1")
        csym = amp.convert_symbol(net, target_dtype="bfloat16", **policy)
        out = csym.bind(mx.cpu(), _fc_binds(mx)).forward()
        outs[side] = out[0] if isinstance(out, list) else out
        plain = net.bind(mx.cpu(), _fc_binds(mx)).forward()
        assert _dt(plain[0] if isinstance(plain, list) else plain) == \
            "float32"
    assert _dt(outs["port"]) == _dt(outs["jax"]) == want
    _close(outs["port"], outs["jax"], want)


def test_convert_symbol_explicit_lp_beats_default_fp32_list():
    rng = np.random.RandomState(3)
    x = rng.randn(4, 8).astype("float32")
    outs = {}
    for side, (mx, _, amp, _) in PACKAGES.items():
        assert "LayerNorm" in amp.lists.FP32_OPS
        net = mx.sym.LayerNorm(mx.sym.Variable("data"), mx.sym.Variable("g"),
                               mx.sym.Variable("b"), name="ln1")
        binds = {"data": mx.nd.array(x), "g": mx.nd.ones((8,)),
                 "b": mx.nd.zeros((8,))}
        csym = amp.convert_symbol(net, target_dtype="bfloat16",
                                  target_dtype_ops=["LayerNorm"])
        out = csym.bind(mx.cpu(), binds).forward()
        outs[side] = out[0] if isinstance(out, list) else out
    assert _dt(outs["port"]) == _dt(outs["jax"]) == "bfloat16"
    _close(outs["port"], outs["jax"], "bfloat16")


def test_scale_loss_backward_through_autocast_promotion():
    """The bf16 head promoted by scale_loss's fp32 multiply; then a
    backward after deinit still replays the recorded casts."""
    rng = np.random.RandomState(4)
    nets, nets2 = {}, {}
    for side, (mx, gluon, _, _) in PACKAGES.items():
        nets[side] = gluon.nn.Dense(4, in_units=8)
        nets[side].initialize()
        nets2[side] = gluon.nn.Dense(2, in_units=4)
        nets2[side].initialize()
    _copy_params(nets["jax"], nets["port"])
    _copy_params(nets2["jax"], nets2["port"])
    x = rng.rand(2, 8).astype(np.float32)
    updates = {}
    for side, (mx, gluon, amp, autograd) in PACKAGES.items():
        amp.init("bfloat16")
        try:
            tr = gluon.Trainer(nets[side].collect_params(), "sgd",
                               {"learning_rate": 0.1})
            amp.init_trainer(tr)
            before = _weight(nets[side]).data().asnumpy().copy()
            with autograd.record():
                loss = nets[side](mx.nd.array(x)).sum()
            with amp.scale_loss(loss, tr) as sl:
                sl.backward()
            tr.step(2)
            updates[side] = _weight(nets[side]).data().asnumpy() - before
            assert np.abs(updates[side]).max() > 0
        finally:
            amp.deinit()
        amp.init("bfloat16")
        try:
            with autograd.record():
                l2 = nets2[side](mx.nd.ones((1, 4))).sum()
        finally:
            amp.deinit()
        l2.backward()
        assert float(mx.nd.abs(_weight(nets2[side]).grad()).sum()
                     .asnumpy()) > 0
    # the fp32 weight moves by lr times a gradient taken in bf16
    _close(updates["port"], updates["jax"], "bfloat16",
           "update of the bf16 step")
    _close(_weight(nets2["port"]).grad(), _weight(nets2["jax"]).grad(),
           "bfloat16", "gradient after deinit")


def test_custom_grad_op_under_amp_replays_casts():
    rng = np.random.RandomState(5)
    x = rng.randn(4, 3).astype("float32")
    lbl = np.array([0, 1, 2, 0], "float32")
    grads = {}
    for side, (mx, _, amp, autograd) in PACKAGES.items():
        amp.init("bfloat16")
        try:
            xa = mx.nd.array(x)
            xa.attach_grad()
            with autograd.record():
                out = mx.nd.SoftmaxOutput(xa, mx.nd.array(lbl))
            out.backward()
            grads[side] = xa.grad
        finally:
            amp.deinit()
        g = grads[side].asnumpy()
        assert np.isfinite(g).all() and np.abs(g).sum() > 0
    _close(grads["port"], grads["jax"], what="SoftmaxOutput gradient")


def test_mx_amp_alias_and_list_getters():
    assert tamp_top.init is tamp.init and tamp_top.scale_loss is \
        tamp.scale_loss
    for fn in ("list_fp16_ops", "list_fp32_ops", "list_conditional_fp32_ops"):
        assert getattr(tamp, fn)() == getattr(jamp, fn)(), fn
    # the registries differ in size; every op of the port's in neither
    # list is in the port's answer
    rest = set(tamp.list_fp16_fp32_ops())
    assert rest and not rest & (set(tamp.list_fp16_ops())
                                | set(tamp.list_fp32_ops()))


def test_convert_model_crosses_through_numpy():
    """(sym, arg_params, aux_params): floats cast, an excluded node's
    parameters and (by default) the aux ones kept fp32, in both
    packages; the converted symbol runs at the policy."""
    rng = np.random.RandomState(6)
    args = {"fc1_weight": rng.randn(3, 8).astype("float32"),
            "fc1_bias": np.zeros(3, "float32"),
            "fc2_weight": rng.randn(2, 3).astype("float32"),
            "fc2_bias": np.zeros(2, "float32")}
    aux = {"bn_moving_mean": np.zeros(2, "float32")}
    res = {}
    for side, (mx, _, amp, _) in PACKAGES.items():
        fc1 = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=3,
                                    name="fc1")
        sym = mx.sym.FullyConnected(fc1, num_hidden=2, name="fc2")
        csym, a, x = amp.convert_model(
            sym, {k: mx.nd.array(v) for k, v in args.items()},
            {k: mx.nd.array(v) for k, v in aux.items()},
            target_dtype="float16", excluded_sym_names=["fc2"])
        assert {k: _dt(v) for k, v in a.items()} == {
            "fc1_weight": "float16", "fc1_bias": "float16",
            "fc2_weight": "float32", "fc2_bias": "float32"}, side
        assert _dt(x["bn_moving_mean"]) == "float32"
        binds = {"data": mx.nd.array(rng.randn(4, 8).astype("float32")
                                     if side == "jax" else res["x"]),
                 **{k: v for k, v in a.items()}}
        if side == "jax":
            res["x"] = binds["data"].asnumpy()
        out = csym.bind(mx.cpu(), binds).forward()
        res[side] = out[0] if isinstance(out, list) else out
    assert _dt(res["port"]) == _dt(res["jax"]) == "float32"
    _close(res["port"], res["jax"], "float16", "converted model")


# --------------------------------------------------------------------------
# the dtype that reaches each listed op: a 2-layer BERT
# --------------------------------------------------------------------------
def _recording(mod, log):
    """Wrap ``mod.autocast_arrays`` to log (op, the float dtypes it
    hands the op); returns the original."""
    orig = mod.autocast_arrays

    def wrap(op, raws, snap=None):
        out = orig(op, raws) if snap is None else orig(op, raws, snap)
        if op in PROBED:
            log.append((op, tuple(_dt(a) for a in _flat(out)
                                  if "float" in _dt(a))))
        return out
    mod.autocast_arrays = wrap
    return orig


def _flat(xs):
    for a in xs:
        if isinstance(a, (list, tuple)):
            yield from _flat(a)
        elif hasattr(a, "dtype") and hasattr(a, "shape"):
            yield a


def _bert_pair():
    jnet = JaxBert(vocab_size=VOCAB, **BERT)
    jnet.collect_params().initialize()
    tnet = BERTForPretraining(vocab_size=VOCAB, device="cpu", **BERT)
    bert_state_dict_from_mxnet(
        {k: p.data().asnumpy() for k, p in jnet.collect_params().items()},
        tnet)
    return jnet, tnet


def _encoder_classifier(side):
    """A 2-layer BERT encoder classifier's symbol, traced from ``side``'s
    blocks with fresh node counters."""
    mx, gluon = PACKAGES[side][:2]
    Encoder, names = {"jax": (JEncoder, JNames),
                      "port": (TEncoder, TNames)}[side]
    dev = {"device": "cpu"} if side == "port" else {}
    units = BERT["units"]

    class EncoderClassifier(gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.embed = gluon.nn.Embedding(VOCAB, units,
                                                prefix="embed_", **dev)
                self.ln = gluon.nn.LayerNorm(epsilon=1e-12, in_channels=units,
                                             prefix="ln_", **dev)
                self.encoder = Encoder(BERT["num_layers"], units,
                                       BERT["hidden_size"],
                                       BERT["num_heads"], dropout=0.0,
                                       prefix="enc_", **dev)
                self.head = gluon.nn.Dense(2, in_units=units, prefix="head_",
                                           **dev)

        def hybrid_forward(self, F, x):
            h = self.encoder(self.ln(self.embed(x)))
            return self.head(F.reshape(F.slice_axis(h, axis=1, begin=0,
                                                    end=1),
                                       shape=(-1, units)))

    names.reset()
    net = EncoderClassifier(prefix="cls_")
    return mx.sym.SoftmaxOutput(net(mx.sym.var("data")),
                                mx.sym.var("softmax_label"), name="softmax")


def _module_run(side, target, tokens, labels, params):
    mx = PACKAGES[side][0]
    amp = PACKAGES[side][2]
    sym = _encoder_classifier(side)
    arg_names = [n for n in sym.list_arguments()
                 if n not in ("data", "softmax_label")]
    if params is None:
        rng = np.random.RandomState(7)
        shapes, _, _ = sym.infer_shape(data=tokens.shape)
        params = {n: (rng.randn(*s) * 0.1).astype("float32")
                  for n, s in zip(sym.list_arguments(), shapes)
                  if n in arg_names}
    csym, arg_params, aux_params = amp.convert_model(
        sym, {k: mx.nd.array(v) for k, v in params.items()}, {},
        target_dtype=target)
    mod = mx.module.Module(csym, context=mx.cpu())
    mod.bind(data_shapes=[("data", tokens.shape)],
             label_shapes=[("softmax_label", labels.shape)])
    mod.init_params(arg_params=arg_params, aux_params=aux_params)
    mod.forward(mx.io.DataBatch([mx.nd.array(tokens)],
                                [mx.nd.array(labels)]), is_train=False)
    return mod.get_outputs()[0], params


@pytest.mark.parametrize("path", ["eager", "hybridize", "module"])
@pytest.mark.parametrize("target", ["float16", "bfloat16"])
def test_bert_listed_op_dtypes_match_jax(target, path):
    """Under amp.init(target) every listed op of the model gets the dtypes
    the JAX package gives it, in the same order: FullyConnected, the
    tied decoder's dot and flash_attention the target, LayerNorm fp32;
    the outputs agree at the target's tolerance."""
    rng = np.random.RandomState(8)
    tokens = rng.randint(0, VOCAB, (BATCH, SEQ)).astype(np.int32)
    types = np.zeros((BATCH, SEQ), np.int32)
    labels = rng.randint(0, 2, (BATCH,)).astype(np.float32)
    logs = {"jax": [], "port": []}
    outs = {}
    if path != "module":
        jnet, tnet = _bert_pair()
        nets = {"jax": jnet, "port": tnet}
    params = None
    for side in ("jax", "port"):
        mx, _, amp, _ = PACKAGES[side]
        mod = jamp_mod if side == "jax" else tamp_mod
        orig = _recording(mod, logs[side])
        if path == "module":
            try:
                out, params = _module_run(side, target, tokens, labels,
                                          params)
            finally:
                mod.autocast_arrays = orig
            outs[side] = [out]
            continue
        amp.init(target)
        try:
            net = nets[side]
            if path == "hybridize":
                net.hybridize()
            outs[side] = net(mx.nd.array(tokens), mx.nd.array(types))
        finally:
            amp.deinit()
            mod.autocast_arrays = orig
    assert logs["port"] == logs["jax"], (logs["port"], logs["jax"])
    seen = {op for op, _ in logs["port"]}
    assert "FullyConnected" in seen and "LayerNorm" in seen
    assert "flash_attention" in seen
    for op, dts in logs["port"]:
        want = "float32" if op in tamp.lists.FP32_OPS else target
        assert set(dts) == {want}, (op, dts)
    for got, ref in zip(outs["port"], outs["jax"]):
        assert _dt(got) == _dt(ref)
        _close(got, ref, target if _dt(ref) != "float32" else target,
               f"{path} output")


# --------------------------------------------------------------------------
# dynamic loss scaling on a thumbnail fused ResNet-50 v1
# --------------------------------------------------------------------------
def test_fused_resnet_loss_scale_sequence_matches_jax():
    """ResNetV1(BottleneckV1, [1, 1, 1, 1], [8, 16, 32, 64, 128]) with
    fused 1x1 conv + BN, 10 classes, 32 px, batch 2, under
    amp.init("float16"), init_trainer, scale_loss and Trainer.step (SGD):
    the loss scale after each of 4 steps and which steps skipped equal the
    JAX package's; the fused op gets fp32 inputs in both."""
    import os

    from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
    from mxnet_tpu_torch.convert import resnet_state_dict_from_mxnet
    from mxnet_tpu_torch.gluon.model_zoo.vision import (BottleneckV1,
                                                        ResNetV1)
    from mxnet_tpu_torch.initializer import initialize
    layers, channels = [1, 1, 1, 1], [8, 16, 32, 64, 128]
    old = os.environ.get("MXNET_TPU_FUSE_CONV_BN")
    os.environ["MXNET_TPU_FUSE_CONV_BN"] = "1"
    try:
        jnet = jres.ResNetV1(jres.BottleneckV1, layers, channels, classes=10)
        source = initialize(ResNetV1(BottleneckV1, layers, channels,
                                     classes=10, device="cpu"),
                            torch.Generator().manual_seed(0))
        tnet = ResNetV1(BottleneckV1, layers, channels, classes=10,
                        device="cpu")
    finally:
        if old is None:
            os.environ.pop("MXNET_TPU_FUSE_CONV_BN")
        else:
            os.environ["MXNET_TPU_FUSE_CONV_BN"] = old
    jparams = jnet.collect_params()
    for p, t in zip(jparams.values(), source.state_dict().values()):
        p.shape = tuple(t.shape)
    jparams.initialize(init=jmx.init.Zero())
    for p, t in zip(jparams.values(), source.state_dict().values()):
        p.set_data(jmx.nd.array(t.numpy()))
    resnet_state_dict_from_mxnet(
        {k: p.data().asnumpy() for k, p in jparams.items()}, tnet)
    rng = np.random.RandomState(9)
    batches = [(rng.uniform(size=(2, 3, 32, 32)).astype(np.float32),
                rng.randint(0, 10, size=(2,)).astype(np.float32))
               for _ in range(4)]
    seqs, fused_dtypes = {}, {}
    for side, net in (("jax", jnet), ("port", tnet)):
        mx, gluon, amp, autograd = PACKAGES[side]
        log = []
        mod = jamp_mod if side == "jax" else tamp_mod
        orig = mod.autocast_arrays

        def wrap(op, raws, snap=None, _orig=orig, _log=log):
            out = _orig(op, raws) if snap is None else _orig(op, raws, snap)
            if op == "_contrib_conv1x1_bn_stats":
                _log.append(tuple(_dt(a) for a in _flat(out)))
            return out
        amp.init("float16")
        mod.autocast_arrays = wrap
        try:
            trainer = gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1})
            amp.init_trainer(trainer)
            loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
            seq = []
            for x, y in batches:
                with autograd.record():
                    loss = loss_fn(net(mx.nd.array(x)), mx.nd.array(y))
                with amp.scale_loss(loss, trainer) as scaled:
                    autograd.backward(scaled)
                trainer.step(2)
                seq.append(trainer._amp_loss_scaler.loss_scale)
        finally:
            amp.deinit()
            mod.autocast_arrays = orig
        seqs[side] = seq
        fused_dtypes[side] = set(log)
    assert seqs["port"] == seqs["jax"], seqs
    # the port's Gluon layers call the fused op's function directly, so
    # only the JAX package's invoke logs it; its inputs stay fp32 there
    assert fused_dtypes["jax"] and all(
        set(dts) == {"float32"} for dts in fused_dtypes["jax"]), fused_dtypes


def test_create_graph_under_amp_keeps_the_casts():
    """A second derivative through a bf16 FullyConnected under amp: the
    first gradient (fp32, through the recorded casts) and the second
    one's weight gradient equal the JAX package's."""
    rng = np.random.RandomState(10)
    xv = rng.randn(4, 8).astype(np.float32)
    wv = rng.randn(3, 8).astype(np.float32)
    res = {}
    for side, (mx, _, amp, autograd) in PACKAGES.items():
        amp.init("bfloat16")
        try:
            x, w = mx.nd.array(xv), mx.nd.array(wv)
            x.attach_grad()
            w.attach_grad()
            with autograd.record():
                y = mx.nd.FullyConnected(x, w, no_bias=True, num_hidden=3)
                loss = (y * y).sum()
                gx, _ = autograd.grad(loss, [x, w], create_graph=True)
                z = (gx * gx).sum()
            z.backward()
            res[side] = (y, gx, w.grad)
        finally:
            amp.deinit()
    for name, got, ref in zip(("y", "first gradient", "second order"),
                              res["port"], res["jax"]):
        assert _dt(got) == _dt(ref), name
        _close(got, ref, "bfloat16", name)
    assert _dt(res["port"][0]) == "bfloat16"


def test_custom_op_under_amp_sees_the_cast_dtype():
    """A CustomOp after a bf16 FullyConnected receives bf16, and its
    backward's gradient reaches the fp32 weight through the recorded
    cast, in both packages."""
    rng = np.random.RandomState(11)
    xv = rng.randn(4, 8).astype(np.float32)
    wv = rng.randn(3, 8).astype(np.float32)
    res = {}
    for side, (mx, _, amp, autograd) in PACKAGES.items():
        seen = []

        class Twice(mx.operator.CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                seen.append(_dt(in_data[0]))
                self.assign(out_data[0], req[0], in_data[0] * 2)

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                self.assign(in_grad[0], req[0], out_grad[0] * 2)

        @mx.operator.register(f"amp_twice_{side}")
        class TwiceProp(mx.operator.CustomOpProp):
            def __init__(self):
                super().__init__(need_top_grad=True)

            def create_operator(self, ctx, shapes, dtypes):
                return Twice()

        amp.init("bfloat16")
        try:
            x, w = mx.nd.array(xv), mx.nd.array(wv)
            w.attach_grad()
            with autograd.record():
                y = mx.nd.FullyConnected(x, w, no_bias=True, num_hidden=3)
                out = mx.nd.Custom(y, op_type=f"amp_twice_{side}")
                loss = out.sum()
            loss.backward()
            res[side] = (out, w.grad, seen)
        finally:
            amp.deinit()
    assert res["port"][2] == res["jax"][2] == ["bfloat16"]
    assert _dt(res["port"][0]) == _dt(res["jax"][0])
    _close(res["port"][0], res["jax"][0], "bfloat16", "custom output")
    assert _dt(res["port"][1]) == "float32"
    _close(res["port"][1], res["jax"][1], "bfloat16", "weight gradient")


# --------------------------------------------------------------------------
# ops.F: the one place the Gluon layers' tensor forwards cast
# --------------------------------------------------------------------------
@pytest.mark.parametrize("target", ["float16", "bfloat16"])
def test_op_namespace_casts_as_invoke_does(target):
    """Each function of ``ops.F`` casts its tensor inputs for its
    registered op's name, as ``invoke`` does: the output dtypes equal the
    JAX package's ``mx.nd`` ops' under ``amp.init(target)`` on the same
    fp32 inputs (FullyConnected and dot in the target, LayerNorm and
    log_softmax in fp32, the layer function listed under another name
    too), and nothing changes with AMP off."""
    from mxnet_tpu_torch.ops import F
    rng = np.random.RandomState(11)
    x, w = rng.randn(4, 8).astype(np.float32), rng.randn(3, 8).astype(
        np.float32)
    g, b = np.ones(8, np.float32), np.zeros(8, np.float32)
    t = [torch.from_numpy(a) for a in (x, w, g, b)]
    j = [jmx.nd.array(a) for a in (x, w, g, b)]

    def port():
        return {"FullyConnected": F.fully_connected(t[0], t[1], None),
                "dot": F.dot(t[0], t[1], transpose_b=True),
                "LayerNorm": F.layer_norm(t[0].to(torch.float16), t[2],
                                          t[3]),
                "log_softmax": F.log_softmax(t[0].to(torch.float16), -1)}

    def jax():
        return {"FullyConnected": jmx.nd.FullyConnected(
                    j[0], j[1], num_hidden=3, no_bias=True),
                "dot": jmx.nd.dot(j[0], j[1], transpose_b=True),
                "LayerNorm": jmx.nd.LayerNorm(j[0].astype("float16"), j[2],
                                              j[3])[0],
                "log_softmax": jmx.nd.log_softmax(j[0].astype("float16"))}

    from mxnet_tpu_torch.ops import matrix as ops_matrix
    from mxnet_tpu_torch.ops import nn as ops_nn
    raw = {"FullyConnected": ops_nn.fully_connected(t[0], t[1], None),
           "dot": ops_matrix._dot(t[0], t[1], transpose_b=True),
           "LayerNorm": ops_nn.layer_norm(t[0].to(torch.float16), t[2],
                                          t[3]),
           "log_softmax": ops_nn.log_softmax(t[0].to(torch.float16), -1)}
    for k, v in port().items():  # AMP off: the functions as they are
        assert v.dtype == raw[k].dtype and torch.equal(v, raw[k]), k
    tamp.init(target)
    jamp.init(target)
    got, want = port(), jax()
    assert {k: _dt(v) for k, v in got.items()} == {
        k: _dt(v) for k, v in want.items()}
    assert _dt(got["FullyConnected"]) == target
    for k in got:
        _close(got[k], want[k], _dt(want[k]), k)


def test_op_namespace_refuses_a_name_with_no_op():
    """A layer cannot reach a function past the casts through ``ops.F``:
    a helper that implements no registered op, or an unknown name,
    raises."""
    from mxnet_tpu_torch.ops import F
    for name in ("_no_mesh", "no_such_op"):
        with pytest.raises(AttributeError):
            getattr(F, name)


def test_op_namespace_calls_the_module_function_of_the_moment(monkeypatch):
    """The wrapper looks its module's function up at each call, so a
    patched function is the one that runs."""
    from mxnet_tpu_torch.ops import F
    from mxnet_tpu_torch.ops import nn as ops_nn
    F.layer_norm  # cached before the patch
    calls = []

    def patched(*args, **kwargs):
        calls.append(len(args))
        return args[0]
    monkeypatch.setattr(ops_nn, "layer_norm", patched)
    x = torch.ones(2, 4)
    assert F.layer_norm(x, torch.ones(4), torch.zeros(4)) is x
    assert calls == [3]


def test_gluon_layers_reach_ops_only_through_the_namespace():
    """No module of the port's Gluon package imports an op function from
    ``ops`` other than through ``ops.F`` (two private constants aside),
    so no layer's tensor forward skips the casts."""
    import pathlib
    import re
    root = pathlib.Path(tmx.__file__).parent / "gluon"
    allowed = {"F", "_no_mesh", "_RNN_GATES"}
    found = {}
    for path in root.rglob("*.py"):
        for line in path.read_text().splitlines():
            m = re.match(r"\s*from \.+ops(\.\w+)? import (.+)", line)
            if m:
                names = {n.split(" as ")[0].strip(" ()")
                         for n in m.group(2).split(",")}
                found[str(path.relative_to(root))] = names - allowed
    assert found and not any(found.values()), found
