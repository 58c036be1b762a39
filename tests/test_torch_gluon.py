"""Port parity: Gluon's ``Parameter``/``ParameterDict`` and ``Block``/
``HybridBlock`` against mxnet_tpu's, on the CPU.

Nets are built in both packages under the same explicit ``prefix=``, so
their ``collect_params()`` names agree (the per-process block counters
differ); structural names (``save_parameters``) agree regardless.
Weights go across by name (``convert.params_from_mxnet`` or a file of
``save_parameters``), inputs are seeded numpy arrays.

Tolerance: fp32 outputs, gradients and running statistics within 1e-5 of
each tensor's largest |value| (XLA and PyTorch sum convolutions, products
and batch statistics in other orders); values the test calls exact are
compared bit for bit.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jg
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon as tg
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.convert import params_from_mxnet
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres

REL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's default context is the card; these tests run on the
    CPU (the default is process-wide, so it is restored)."""
    prev = mx.set_default_context(mx.cpu())
    yield
    mx.set_default_context(prev)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x,
                      np.float32)


def _close(got, ref, rel=REL, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    bound = rel * float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= bound, f"{what}: max err {err} > {bound}"


def _copy(jnet, tnet):
    params_from_mxnet({k: p.data().asnumpy()
                       for k, p in jnet.collect_params().items()}, tnet)


def mnist_net(g, prefix="mnist_"):
    """``examples/image_classification/train_mnist.py``'s ``build_net``:
    no input widths, so every layer infers its own."""
    net = g.nn.Sequential(prefix=prefix)
    with net.name_scope():
        net.add(g.nn.Conv2D(32, 3, padding=1, activation="relu"),
                g.nn.MaxPool2D(2),
                g.nn.Conv2D(64, 3, padding=1, activation="relu"),
                g.nn.MaxPool2D(2),
                g.nn.Flatten(),
                g.nn.Dense(128, activation="relu"),
                g.nn.Dense(10))
    return net


def _images(seed, batch=4, shape=(1, 28, 28)):
    rng = np.random.RandomState(seed)
    return rng.rand(batch, *shape).astype(np.float32)


def _resnet(pkg, block, fused, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_FUSE_CONV_BN", str(int(fused)))
    channels = ([8, 8, 16, 32, 64] if block == "BasicBlockV1"
                else [8, 16, 32, 64, 128])
    kw = {"ctx": mx.cpu()} if pkg is tres else {}
    return pkg.ResNetV1(getattr(pkg, block), [1, 1, 1, 1], channels,
                        classes=10, prefix="rn_", **kw)


# ---------------------------------------------------------------------------
# Parameter
# ---------------------------------------------------------------------------
def test_deferred_init_matches_jax():
    """``Dense(8)`` learns its input width at the first forward: before,
    ``data()`` raises; after, the weight is [8, 5], the module's tensor
    too, on the context ``initialize`` named."""
    jd, td = jg.nn.Dense(8, prefix="d_"), tg.nn.Dense(8, prefix="d_")
    jd.initialize()
    td.initialize(ctx=mx.cpu())
    with pytest.raises(Exception):
        jd.collect_params()["d_weight"].data()
    with pytest.raises(tg.DeferredInitializationError):
        td.collect_params()["d_weight"].data()
    assert isinstance(td.weight, torch.nn.parameter.UninitializedParameter)
    x = np.ones((2, 5), np.float32)
    assert jd(jnd.array(x)).shape == td(tnd.array(x)).shape == (2, 8)
    assert (jd.collect_params()["d_weight"].shape
            == td.collect_params()["d_weight"].shape == (8, 5))
    assert tuple(td.weight.shape) == (8, 5) and td.weight.device.type == "cpu"
    assert td.collect_params()["d_weight"].data()._data is td.weight


def test_uninitialized_parameter_raises_like_jax():
    """A known shape is still no data before ``initialize()``."""
    for g in (jg, tg):
        weight = next(iter(g.nn.Dense(3, in_units=2).collect_params()
                           .values()))
        with pytest.raises(RuntimeError, match="initialize"):
            weight.data()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_shape_merge_and_its_error(pkg):
    g = jg if pkg == "jax" else tg
    params = g.ParameterDict("p_")
    w = params.get("w", shape=(0, 5), allow_deferred_init=True)
    assert params.get("w", shape=(3, 0)) is w
    assert w.shape == (3, 5)
    with pytest.raises(AssertionError, match="shape mismatch"):
        w.shape = (4, 5)
    with pytest.raises(AssertionError, match="shape mismatch"):
        w.shape = (3, 5, 1)
    assert list(params.keys()) == ["p_w"]


def test_grad_req_setter_matches_jax():
    """'null' drops the gradient (and torch's requires_grad), 'add'
    accumulates over two backwards, and a non-differentiable parameter
    stays 'null'."""
    rng = np.random.RandomState(1)
    x = rng.randn(3, 2).astype(np.float32)
    nets = [jg.nn.Dense(4, in_units=2, prefix="g_"),
            tg.nn.Dense(4, in_units=2, prefix="g_")]
    for net in nets:
        net.initialize()
    _copy(*nets)
    grads = []
    for net, g, ag, nd in zip(nets, (jg, tg), (jag, tag), (jnd, tnd)):
        w, b = net.collect_params().values()
        b.grad_req = "null"
        with pytest.raises(RuntimeError):
            b.grad()
        w.grad_req = "add"
        for _ in range(2):
            with ag.record():
                loss = (net(nd.array(x)) ** 2).sum()
            loss.backward()
        grads.append(w.grad())
        bn = g.nn.BatchNorm(in_channels=2)
        mean = bn.collect_params()[bn.prefix + "running_mean"]
        mean.grad_req = "write"
        assert mean.grad_req == "null"
    assert not nets[1].bias.requires_grad and nets[1].weight.requires_grad
    _close(grads[1], grads[0], what="accumulated dweight")


def test_set_data_and_zero_grad_write_in_place():
    """``set_data`` writes the module's tensor in place (same storage,
    the same NDArray from ``data()``); ``zero_grad`` zeroes the
    gradient."""
    net = tg.nn.Dense(3, in_units=2, prefix="s_")
    net.initialize()
    w = net.collect_params()["s_weight"]
    arr, ptr = w.data(), net.weight.data_ptr()
    value = np.arange(6, dtype=np.float32).reshape(3, 2)
    w.set_data(value)
    assert net.weight.data_ptr() == ptr and w.data() is arr
    np.testing.assert_array_equal(net.weight.detach().numpy(), value)
    w.data()[:] = 2.0
    assert (net.weight == 2.0).all() and w.data() is arr
    with tag.record():
        loss = net(tnd.ones((1, 2))).sum()
    loss.backward()
    assert (w.grad().asnumpy() == 1.0).all()
    w.zero_grad()
    assert not w.grad().asnumpy().any()


def test_lr_mult_and_wd_mult_match_jax():
    """One SGD step with the weight's lr_mult 0.5 and the bias's wd_mult
    0 (wd 0.1): every parameter as the reference's."""
    rng = np.random.RandomState(2)
    x, y = rng.randn(4, 3).astype(np.float32), rng.randn(4, 2).astype(
        np.float32)
    nets = [jg.nn.Dense(2, in_units=3, prefix="m_"),
            tg.nn.Dense(2, in_units=3, prefix="m_")]
    for net in nets:
        net.initialize()
    _copy(*nets)
    out = []
    for net, g, ag, nd in zip(nets, (jg, tg), (jag, tag), (jnd, tnd)):
        params = net.collect_params()
        params["m_weight"].lr_mult = 0.5
        params["m_bias"].wd_mult = 0.0
        trainer = g.Trainer(params, "sgd", {"learning_rate": 0.5, "wd": 0.1})
        with ag.record():
            loss = g.loss.L2Loss()(net(nd.array(x)), nd.array(y))
        loss.backward()
        trainer.step(4)
        out.append([p.data().asnumpy() for p in params.values()])
    for got, ref in zip(out[1], out[0]):
        _close(got, ref)


def test_parameter_dict_files_and_constants(tmp_path):
    """``ParameterDict.save`` of the reference loads into the port's
    (``restore_prefix``), and a ``Constant`` is a buffer that takes no
    gradient, in both packages."""
    jparams = jg.ParameterDict("a_")
    jparams.get("w", shape=(2, 3))
    jparams.get("b", shape=(3,), init="ones")
    jparams.initialize()
    jparams.save(str(tmp_path / "p.params"), strip_prefix="a_")
    tparams = tg.ParameterDict("z_")
    tparams.get("w", shape=(2, 3))
    tparams.get("b", shape=(3,))
    tparams.initialize()
    tparams.load(str(tmp_path / "p.params"), restore_prefix="z_")
    for got, ref in zip(tparams.values(), jparams.values()):
        np.testing.assert_array_equal(got.data().asnumpy(),
                                      ref.data().asnumpy())
    value = np.arange(4, dtype=np.float32).reshape(2, 2)
    for g in (jg, tg):
        class Scaled(g.HybridBlock):
            def __init__(self, **kwargs):
                super().__init__(**kwargs)
                with self.name_scope():
                    self.c = self.params.get_constant("c", value)

            def hybrid_forward(self, F, x, c):
                return x * c

        block = Scaled(prefix="k_")
        block.initialize()
        const = block.collect_params()["k_c"]
        assert const.grad_req == "null"
        np.testing.assert_array_equal(const.data().asnumpy(), value)
    assert "c" in dict(block.named_buffers())


INITS = {
    "zero": lambda I: I.Zero(),
    "one": lambda I: I.One(),
    "constant": lambda I: I.Constant(0.5),
    "uniform": lambda I: I.Uniform(0.1),
    "normal": lambda I: I.Normal(0.2),
    "xavier": lambda I: I.Xavier(),
    "xavier_gaussian_in": lambda I: I.Xavier("gaussian", "in", 2),
    "msra": lambda I: I.MSRAPrelu(),
    "by_name": lambda I: I.create("xavier", magnitude=2),
    "mixed": lambda I: I.Mixed([".*bias", ".*"], [I.One(), I.Uniform(0.3)]),
}
NAMES = ("w_weight", "w_bias", "bn_gamma", "bn_beta", "bn_running_mean",
         "bn_running_var", "x_other")


@pytest.mark.parametrize("case", sorted(INITS))
def test_initializer_rules_match_jax(case):
    """Each name takes the rule the reference picks: where the reference
    writes a constant the port writes the same one; where it draws, the
    port draws from the same law (bounds and scale; the streams differ)."""
    from mxnet_tpu import initializer as JI
    shape = (64, 32, 3, 3)
    fan = {"uniform": 0.1, "normal": 0.2,
           "xavier": (3.0 / ((32 * 9 + 64 * 9) / 2)) ** 0.5,
           "xavier_gaussian_in": (2.0 / (32 * 9)) ** 0.5,
           "msra": ((2.0 / (1 + 0.25 ** 2)) / ((32 * 9 + 64 * 9) / 2)) ** 0.5,
           "by_name": (2.0 / ((32 * 9 + 64 * 9) / 2)) ** 0.5,
           "mixed": 0.3}
    gaussian = case in ("normal", "xavier_gaussian_in", "msra")
    for name in NAMES:
        jarr, tarr = jnd.zeros(shape), tnd.zeros(shape)
        INITS[case](JI)(JI.InitDesc(name), jarr)
        INITS[case](mx.init)(mx.init.InitDesc(name), tarr)
        ref, got = jarr.asnumpy(), tarr.asnumpy()
        if np.unique(ref).size == 1:
            np.testing.assert_array_equal(got, ref, err_msg=name)
            continue
        scale = fan[case]
        if gaussian:
            assert abs(got.std() / scale - 1) < 0.05, (name, got.std())
        else:
            assert np.abs(got).max() <= scale
            assert np.abs(got).max() > 0.99 * scale, name
        assert abs(got.mean()) < 0.05 * scale, name


def test_random_seed_restarts_the_draws():
    """``mx.random.seed`` restarts the stream ``initialize`` draws from."""
    def draw(seed):
        mx.random.seed(seed)
        net = tg.nn.Dense(8, in_units=8)
        net.initialize(mx.init.Xavier())
        return net.weight.detach().clone()
    assert torch.equal(draw(3), draw(3))
    assert not torch.equal(draw(3), draw(4))


POOLS = {
    "max_ceil": lambda nn: nn.MaxPool2D(3, 2, 1, ceil_mode=True),
    "avg": lambda nn: nn.AvgPool2D(3, 2, 1),
    "avg_excl_pad": lambda nn: nn.AvgPool2D(3, 2, 1,
                                            count_include_pad=False),
    "avg_ceil": lambda nn: nn.AvgPool2D(2, 2, ceil_mode=True),
    "global_avg": lambda nn: nn.GlobalAvgPool2D(),
}


@pytest.mark.parametrize("case", sorted(POOLS))
def test_pooling_layers_match_jax(case):
    x = np.random.RandomState(8).randn(2, 3, 7, 9).astype(np.float32)
    _close(POOLS[case](tg.nn)(tnd.array(x)), POOLS[case](jg.nn)(jnd.array(x)),
           what=case)


@pytest.mark.parametrize("loss", ["L1Loss", "L2Loss"])
def test_regression_losses_match_jax(loss):
    """Per-sample losses with a weight and a sample weight."""
    rng = np.random.RandomState(9)
    pred = rng.randn(5, 4).astype(np.float32)
    label = rng.randn(5, 4).astype(np.float32)
    sw = rng.rand(5, 1).astype(np.float32)
    ref = getattr(jg.loss, loss)(weight=0.7)(jnd.array(pred),
                                             jnd.array(label), jnd.array(sw))
    got = getattr(tg.loss, loss)(weight=0.7)(tnd.array(pred),
                                             tnd.array(label), tnd.array(sw))
    assert got.shape == (5,)
    _close(got, ref, what=loss)


# ---------------------------------------------------------------------------
# collect_params and names
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["mnist", "basic", "bottleneck",
                                  "bottleneck_fused"])
def test_collect_params_names_match_jax(case, monkeypatch):
    """Prefixed keys, structural names, and ``select`` regexes, for the
    same nets built in both packages."""
    if case == "mnist":
        nets = [mnist_net(jg), mnist_net(tg)]
        for net, nd in zip(nets, (jnd, tnd)):
            net.initialize()
            net(nd.array(_images(0)))
    else:
        block = "BasicBlockV1" if case == "basic" else "BottleneckV1"
        fused = case.endswith("fused")
        nets = [_resnet(jres, block, fused, monkeypatch),
                _resnet(tres, block, fused, monkeypatch)]
    jnet, tnet = nets
    assert list(tnet.collect_params()) == list(jnet.collect_params())
    assert list(tnet._collect_params_with_prefix()) == list(
        jnet._collect_params_with_prefix())
    for select in (".*weight", ".*_stage2_.*", ".*(gamma|beta)$",
                   "mnist_dense"):
        assert list(tnet.collect_params(select)) == list(
            jnet.collect_params(select)), select
    # the module's own names pair with the structural ones, in order
    assert list(tnet.state_dict()) == list(tnet._collect_params_with_prefix())
    grad_null = [k for k, p in tnet.collect_params().items()
                 if p.grad_req == "null"]
    assert grad_null == [k for k, p in jnet.collect_params().items()
                         if p.grad_req == "null"]
    assert {k.rsplit(".", 1)[-1] for k, _ in tnet.named_buffers()} <= {
        "running_mean", "running_var"}


def test_prefixes_and_name_scopes():
    """A block made inside ``name_scope()`` takes its parent's prefix; an
    empty prefix shares its parent's scope."""
    for g in (jg, tg):
        outer = g.nn.HybridSequential(prefix="outer_")
        with outer.name_scope():
            inner = g.nn.HybridSequential(prefix="")
            with inner.name_scope():
                dense = g.nn.Dense(2, in_units=2)
            inner.add(dense)
            outer.add(inner)
            outer.add(g.nn.Dense(2, in_units=2))
        assert dense.prefix == "outer_dense0_"
        assert list(outer.collect_params()) == [
            "outer_dense0_weight", "outer_dense0_bias",
            "outer_dense1_weight", "outer_dense1_bias"]
        assert dense.name == "outer_dense0"


# ---------------------------------------------------------------------------
# weights across packages
# ---------------------------------------------------------------------------
def test_save_load_parameters_across_packages(tmp_path):
    """The reference's ``save_parameters`` -> the port's
    ``load_parameters`` (the port net still deferred: the file gives the
    shapes), and back: the same forward."""
    x = _images(3)
    jnet = mnist_net(jg)
    jnet.initialize()
    ref = jnet(jnd.array(x))
    jnet.save_parameters(str(tmp_path / "ref.params"))
    tnet = mnist_net(tg, prefix="other_")
    tnet.initialize(ctx=mx.cpu())
    tnet.load_parameters(str(tmp_path / "ref.params"), ctx=mx.cpu())
    _close(tnet(tnd.array(x)), ref, what="port from reference file")
    tnet.save_parameters(str(tmp_path / "port.params"))
    back = mnist_net(jg, prefix="back_")
    back.initialize()
    back.load_parameters(str(tmp_path / "port.params"))
    _close(back(jnd.array(x)), ref, what="reference from port file")


def test_params_from_mxnet_and_its_errors():
    jnet, tnet = mnist_net(jg), mnist_net(tg)
    jnet.initialize()
    tnet.initialize(ctx=mx.cpu())
    x = _images(4)
    ref = jnet(jnd.array(x))
    params = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    params_from_mxnet(params, tnet)  # deferred: shapes from the arrays
    _close(tnet(tnd.array(x)), ref)
    names = list(params)
    with pytest.raises(MXNetError, match="missing"):
        params_from_mxnet({n: params[n] for n in names[1:]}, tnet)
    with pytest.raises(MXNetError, match="no place"):
        params_from_mxnet(dict(params, mnist_extra_weight=params[names[0]]),
                          tnet)
    with pytest.raises(MXNetError, match="shape"):
        params_from_mxnet(dict(params, **{names[0]: params[names[0]][:1]}),
                          tnet)


# ---------------------------------------------------------------------------
# user blocks
# ---------------------------------------------------------------------------
def _affine_class(g):
    class Affine(g.HybridBlock):
        """A user's HybridBlock: ``hybrid_forward(F, x, weight, bias)``."""

        def __init__(self, units, in_units, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.weight = self.params.get("weight",
                                              shape=(units, in_units))
                self.bias = self.params.get("bias", shape=(units,),
                                            init="zeros")

        def hybrid_forward(self, F, x, weight, bias):
            return F.relu(F.dot(x, weight, transpose_b=True) + bias)
    return Affine


def test_user_hybrid_block_matches_jax():
    """``F`` is ``mx.nd`` and the parameters arrive as NDArrays: the
    forward and the weight's gradient as the reference's, whether the
    block is called with NDArrays or, inside a port container, with
    tensors under torch autograd."""
    rng = np.random.RandomState(5)
    x = rng.randn(6, 4).astype(np.float32)
    jnet = _affine_class(jg)(3, 4, prefix="aff_")
    tnet = _affine_class(tg)(3, 4, prefix="aff_")
    jnet.initialize()
    tnet.initialize()
    _copy(jnet, tnet)
    outs = []
    for net, ag, nd in ((jnet, jag, jnd), (tnet, tag, tnd)):
        with ag.record():
            out = net(nd.array(x))
            (out * out).sum().backward()
        outs.append((out, net.collect_params()["aff_weight"].grad()))
    _close(outs[1][0], outs[0][0], what="out")
    _close(outs[1][1], outs[0][1], what="dweight")
    seq = tg.nn.HybridSequential()
    seq.add(tnet)
    tx = torch.from_numpy(x)
    tout = seq(tx)
    assert isinstance(tout, torch.Tensor)
    (tout * tout).sum().backward()
    _close(tnet.weight.grad, outs[0][1], what="dweight, torch autograd")


def test_user_block_forward_takes_ndarrays():
    """A ``Block`` whose forward a user wrote in ``mx.nd`` gets NDArrays,
    called either way."""
    class Net(tg.Block):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.dense = tg.nn.Dense(2, in_units=3)

        def forward(self, x):
            assert isinstance(x, mx.NDArray)
            return tnd.relu(self.dense(x)) * 2

    net = Net()
    net.initialize()
    x = np.ones((2, 3), np.float32)
    out = net(tnd.array(x))
    assert isinstance(out, mx.NDArray)
    tout = net(torch.from_numpy(x))
    assert isinstance(tout, torch.Tensor)
    np.testing.assert_array_equal(tout.detach().numpy(), out.asnumpy())


def test_hooks_hybridize_and_input_signature():
    """Hooks see NDArrays under the Gluon boundary and ``detach()``
    removes them; ``hybridize`` leaves the output as it was; the input
    signature is the last NDArray call's."""
    net = tg.nn.Dense(2, in_units=3)
    net.initialize()
    seen = []
    pre = net.register_forward_pre_hook(
        lambda b, args: seen.append(type(args[0]).__name__))
    post = net.register_forward_hook(
        lambda b, args, out: seen.append(type(out).__name__))
    x = tnd.ones((4, 3))
    eager = net(x).asnumpy()
    assert seen == ["NDArray", "NDArray"]
    pre.detach()
    post.detach()
    net.hybridize()
    np.testing.assert_array_equal(net(x).asnumpy(), eager)
    assert seen == ["NDArray", "NDArray"]
    assert net.input_signature() == (((4, 3), "float32"),)


# ---------------------------------------------------------------------------
# training mode and shared storage
# ---------------------------------------------------------------------------
def _bn_net(g):
    net = g.nn.HybridSequential(prefix="bn_")
    with net.name_scope():
        net.add(g.nn.Conv2D(4, 3, in_channels=2), g.nn.BatchNorm())
    return net


def test_training_mode_follows_autograd_like_jax():
    """``net(x)`` outside ``record()`` uses the moving statistics and
    leaves them; inside it uses the batch's and updates the moving ones;
    ``record(train_mode=False)`` records with the moving ones."""
    rng = np.random.RandomState(6)
    x = (rng.randn(3, 2, 6, 6) * 2 + 1).astype(np.float32)
    jnet, tnet = _bn_net(jg), _bn_net(tg)
    jnet.initialize()
    tnet.initialize()
    jnet(jnd.array(x))
    tnet(tnd.array(x))
    _copy(jnet, tnet)
    stats = ("bn_batchnorm0_running_mean", "bn_batchnorm0_running_var")

    def run(net, ag, nd, mode):
        before = [net.collect_params()[s].data().asnumpy() for s in stats]
        if mode == "predict":
            out = net(nd.array(x))
        else:
            with ag.record(train_mode=mode == "train"):
                out = net(nd.array(x))
        after = [net.collect_params()[s].data().asnumpy() for s in stats]
        return out, before, after

    for mode in ("predict", "train", "record_predict"):
        (jo, jb, ja), (to, tb, ta) = (run(jnet, jag, jnd, mode),
                                      run(tnet, tag, tnd, mode))
        _close(to, jo, what=f"{mode} out")
        moved = mode == "train"
        for b, a, ra in zip(tb, ta, ja):
            assert (not np.array_equal(a, b)) == moved, mode
            _close(a, ra, what=f"{mode} running stats")
    assert all(m.training for m in tnet.modules())  # torch's mode restored


def test_trainer_step_keeps_module_and_parameters_together():
    """After ``trainer.step`` the module path (``net(tensor)``) and the
    Gluon path (``net(ndarray)``) compute the same output, and every
    Gluon parameter's array is the module's tensor."""
    x = _images(7)
    net = mnist_net(tg)
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    y = tnd.array(np.arange(4) % 10)
    trainer = tg.Trainer(net.collect_params(), "sgd",
                         {"learning_rate": 0.1, "momentum": 0.9})
    net(tnd.array(x))  # the first forward gives the widths
    before = {k: v.clone() for k, v in net.state_dict().items()}
    for _ in range(2):
        with tag.record():
            loss = tg.loss.SoftmaxCrossEntropyLoss()(net(tnd.array(x)), y)
        loss.backward()
        trainer.step(4)
    state = net.state_dict()
    for (key, p), (name, t) in zip(
            net._collect_params_with_prefix().items(), state.items()):
        assert key == name
        assert p.data()._data.data_ptr() == t.data_ptr()
        np.testing.assert_array_equal(p.data().asnumpy(), t.numpy())
        assert not torch.equal(t, before[key]), key
    with torch.no_grad():
        module_out = net.eval()(torch.from_numpy(x))
    np.testing.assert_array_equal(module_out.numpy(),
                                  net(tnd.array(x)).asnumpy())


# ---------------------------------------------------------------------------
# the card by default
# ---------------------------------------------------------------------------
def test_entry_points_default_to_the_card():
    """Without a card, initialize() with no context, the model zoo with
    no device, and an iterator with no context raise, while a dist
    kvstore is taken (in one process, and with optimizer-state sharding
    but no mesh to shard over, it engages no store)."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusals of a machine without a card")
    mx.set_default_context(None)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tg.nn.Dense(2, in_units=2).initialize()
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tres.resnet18_v1()
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mx.io.NDArrayIter(np.zeros((4, 2), np.float32), batch_size=2)
    net = tg.nn.Dense(2, in_units=2, device="cpu")
    for shard in (True, None):
        trainer = tg.Trainer(net.collect_params(), "sgd", kvstore="dist_sync",
                             optimizer_state_sharding=shard)
        trainer.allreduce_grads()
        assert trainer._kvstore is None
