"""Port parity: the registry ops and Gluon layers of the vision zoo's slice
(1- and 3-D convolution and pooling, the transposed convolutions,
sum/Lp/'full' pooling, ``pad``, the ``LeakyReLU`` family, InstanceNorm,
GroupNorm, SyncBatchNorm, ReflectionPad2D and the contrib layers) against
the JAX package, on the CPU.

Each case builds the layer in both packages under the same ``prefix=``,
runs the JAX one first (which resolves its deferred shapes), carries its
weights over with ``convert.params_from_mxnet``, then compares the
forward, the input's and every parameter's gradient under a seeded
random head gradient, and, for the norms, the moving statistics after a
training-mode forward.  The symbolic form is compared through ``export``:
the symbol JSON must equal the JAX package's, and the port's
``SymbolBlock.imports`` must reproduce the block.

Tolerances: fp32 outputs within 1e-4 of the reference's largest |value|,
gradients within 1e-3 of theirs, moving statistics within 1e-5 (each plus
1e-7 for references at 0); NaNs where the reference has them.  Random
draws (rrelu's slopes) are never compared; they are held to their
bounds.
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.contrib import nn as jcnn
from mxnet_tpu.symbol.symbol import NameManager as JNames

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.convert import params_from_mxnet
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.block import SymbolBlock
from mxnet_tpu_torch.gluon.contrib import nn as tcnn
from mxnet_tpu_torch.symbol.symbol import NameManager as TNames

OUT_REL, GRAD_REL, STAT_REL, ABS = 1e-4, 1e-3, 1e-5, 1e-7


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)


def _close(got, ref, rel, what=""):
    """Within ``rel`` of ``ref``'s largest finite |value|; a NaN (a
    window wholly in the padding averages 0 / 0) only where ``ref`` has
    one."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    nan = np.isnan(ref)
    assert np.array_equal(np.isnan(got), nan), f"{what}: NaNs differ"
    got, ref = got[~nan], ref[~nan]
    bound = rel * float(np.abs(ref).max(initial=0.0)) + ABS
    err = float(np.abs(got - ref).max(initial=0.0))
    assert err <= bound, f"{what}: max err {err} > {bound}"


def _pair(make):
    """``make(nn, contrib_nn)`` in both packages, ``prefix='l_'``."""
    return make(jnn, jcnn), make(tnn, tcnn)


def _forward_backward(pkg, block, xs, train, head_seed=7):
    """Output, input gradients and parameter gradients of ``block`` on
    ``xs`` under ``record(train_mode=train)`` and a seeded head
    gradient."""
    arrays = [pkg.nd.array(x) for x in xs]
    for a in arrays:
        a.attach_grad()
    with pkg.autograd.record(train_mode=train):
        out = block(*arrays)
    head = np.random.RandomState(head_seed).randn(*out.shape).astype(
        np.float32)
    out.backward(pkg.nd.array(head))
    grads = {k: p.grad().asnumpy() for k, p in
             block.collect_params().items() if p.grad_req != "null"}
    return out.asnumpy(), [a.grad.asnumpy() for a in arrays], grads


def _check_pair(jblock, tblock, xs, train=True):
    """Forward, gradients and moving statistics of the two blocks."""
    jblock.collect_params().initialize(jmx.init.Xavier())
    jmx.nd.waitall()
    jout = jblock(*[jmx.nd.array(x) for x in xs])  # resolves deferred
    del jout
    tblock.collect_params().initialize(ctx=tmx.cpu())
    params_from_mxnet({k: p.data().asnumpy()
                       for k, p in jblock.collect_params().items()}, tblock)
    assert sorted(jblock.collect_params()) == sorted(tblock.collect_params())
    jo, jgx, jgp = _forward_backward(jmx, jblock, xs, train)
    to, tgx, tgp = _forward_backward(tmx, tblock, xs, train)
    _close(to, jo, OUT_REL, "output")
    for i, (a, b) in enumerate(zip(tgx, jgx)):
        _close(a, b, GRAD_REL, f"input {i} gradient")
    assert sorted(tgp) == sorted(jgp)
    for k in jgp:
        _close(tgp[k], jgp[k], GRAD_REL, f"{k} gradient")
    for k, p in jblock.collect_params().items():
        if k.endswith(("running_mean", "running_var")):
            _close(tblock.collect_params()[k].data(), p.data(), STAT_REL, k)
    return to


def _export_pair(jblock, tblock, xs, tmp_path, json_equal=True):
    """Both blocks' exports (after an NDArray call each, for the input
    signature): the symbol JSON equal, and the port's import equal to
    the port's block."""
    jblock(*[jmx.nd.array(x) for x in xs])
    ref = tblock(*[tmx.nd.array(x) for x in xs])
    TNames.reset()
    tblock.export(str(tmp_path / "t"))
    with open(tmp_path / "t-symbol.json") as f:
        tgraph = json.load(f)
    if json_equal:
        JNames.reset()
        jblock.export(str(tmp_path / "j"))
        with open(tmp_path / "j-symbol.json") as f:
            assert tgraph == json.load(f)
    imported = SymbolBlock.imports(str(tmp_path / "t-symbol.json"), ["data"],
                                   str(tmp_path / "t-0000.params"),
                                   ctx=tmx.cpu())
    _close(imported(tmx.nd.array(xs[0])), ref, OUT_REL, "imported")
    return tgraph


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ------------------------------------------------------------ conv layers
CONVS = {
    "conv1d": (lambda nn, c: nn.Conv1D(4, 3, strides=2, padding=1,
                                       prefix="l_"), (2, 3, 11)),
    "conv1d_dilated_grouped": (lambda nn, c: nn.Conv1D(
        6, 3, dilation=2, groups=3, activation="relu", prefix="l_"),
        (2, 3, 12)),
    "conv3d": (lambda nn, c: nn.Conv3D(4, (2, 3, 3), padding=(0, 1, 1),
                                       prefix="l_"), (2, 3, 4, 6, 6)),
    "conv1d_transpose": (lambda nn, c: nn.Conv1DTranspose(
        3, 3, strides=2, padding=1, output_padding=1, prefix="l_"),
        (2, 4, 7)),
    "conv2d_transpose": (lambda nn, c: nn.Conv2DTranspose(
        4, 3, strides=2, padding=1, output_padding=1, prefix="l_"),
        (2, 3, 5, 5)),
    "conv2d_transpose_grouped": (lambda nn, c: nn.Conv2DTranspose(
        4, (3, 2), strides=(1, 2), groups=2, use_bias=False,
        activation="tanh", prefix="l_"), (2, 4, 5, 5)),
    "conv3d_transpose": (lambda nn, c: nn.Conv3DTranspose(
        2, 3, strides=2, dilation=(1, 2, 1), prefix="l_"), (1, 3, 3, 4, 4)),
}


@pytest.mark.parametrize("case", sorted(CONVS))
def test_conv_layers_match_jax(case, tmp_path):
    make, shape = CONVS[case]
    x = _x(*shape)
    jb, tb = _pair(make)
    _check_pair(jb, tb, [x])
    _export_pair(jb, tb, [x], tmp_path)


def test_conv_deferred_width_and_layout_refusal():
    """A convolution without ``in_channels`` learns it at the first
    forward ([in, out / groups, k] for a transposed one); a layout other
    than channels-first raises."""
    t = tnn.Conv2DTranspose(6, 3, groups=2, prefix="l_")
    t.initialize(ctx=tmx.cpu())
    t(tmx.nd.array(_x(1, 4, 5, 5)))
    assert tuple(t.weight.shape) == (4, 3, 3, 3)
    with pytest.raises(MXNetError, match="NCHW"):
        tnn.Conv2D(4, 3, layout="NHWC")


# --------------------------------------------------------------- pooling
POOLS = {
    "max1d_ceil": (lambda nn, c: nn.MaxPool1D(3, 2, ceil_mode=True),
                   (2, 3, 10)),
    "max3d": (lambda nn, c: nn.MaxPool3D(2), (2, 3, 4, 6, 6)),
    "max3d_pad_ceil": (lambda nn, c: nn.MaxPool3D(3, 2, 1, ceil_mode=True),
                       (1, 2, 6, 7, 8)),
    "avg1d_pad": (lambda nn, c: nn.AvgPool1D(3, 1, 1), (2, 3, 9)),
    "avg1d_nopad_count": (lambda nn, c: nn.AvgPool1D(
        3, 2, 1, count_include_pad=False), (2, 3, 9)),
    "avg3d_full_excl": (lambda nn, c: nn.AvgPool3D(
        2, padding=1, ceil_mode=True, count_include_pad=False),
        (1, 2, 5, 5, 5)),
    "avg2d_wide_pad": (lambda nn, c: nn.AvgPool2D(2, 1, 2), (2, 3, 5, 5)),
    "global_max1d": (lambda nn, c: nn.GlobalMaxPool1D(), (2, 3, 9)),
    "global_max2d": (lambda nn, c: nn.GlobalMaxPool2D(), (2, 3, 5, 6)),
    "global_max3d": (lambda nn, c: nn.GlobalMaxPool3D(), (2, 3, 3, 4, 5)),
    "global_avg1d": (lambda nn, c: nn.GlobalAvgPool1D(), (2, 3, 9)),
    "global_avg3d": (lambda nn, c: nn.GlobalAvgPool3D(), (2, 3, 3, 4, 5)),
    "reflection_pad2d": (lambda nn, c: nn.ReflectionPad2D(2), (2, 3, 5, 6)),
}


@pytest.mark.parametrize("case", sorted(POOLS))
def test_pooling_and_pad_layers_match_jax(case, tmp_path):
    make, shape = POOLS[case]
    x = _x(*shape)
    jb, tb = _pair(make)
    _check_pair(jb, tb, [x])
    _export_pair(jb, tb, [x], tmp_path)


POOL_OPS = [
    dict(kernel=(3, 3), pool_type="sum", stride=(2, 2)),
    dict(kernel=(3, 3), pool_type="sum", stride=(2, 2), pad=(1, 1),
         pooling_convention="full"),
    dict(kernel=(2,), pool_type="sum", stride=(1,)),
    dict(kernel=(3, 3), pool_type="lp", p_value=2, stride=(2, 2),
         pad=(1, 1)),
    dict(kernel=(2, 2, 2), pool_type="lp", p_value=3, stride=(1, 1, 1)),
    dict(kernel=(3, 3), pool_type="max", stride=(2, 2), pad=(2, 2)),
    dict(kernel=(1, 1), pool_type="lp", global_pool=True, p_value=2),
    dict(kernel=(1,), pool_type="sum", global_pool=True),
]


@pytest.mark.parametrize("kw", POOL_OPS, ids=lambda kw: "_".join(
    f"{k}{v}" for k, v in kw.items()).replace(" ", ""))
def test_pooling_op_types_match_jax(kw):
    """The ``Pooling`` op's sum and Lp types, global and windowed, and a
    max pool padded past half its window (padded with -inf first)."""
    shape = {1: (2, 3, 9), 2: (2, 3, 9, 8), 3: (1, 2, 5, 6, 4)}[
        len(kw["kernel"])]
    x = _x(*shape)
    outs = []
    for pkg in (jmx, tmx):
        a = pkg.nd.array(x)
        a.attach_grad()
        with pkg.autograd.record():
            out = pkg.nd.Pooling(a, **kw)
        out.backward(pkg.nd.array(_x(*out.shape, seed=3)))
        outs.append((out.asnumpy(), a.grad.asnumpy()))
    _close(outs[1][0], outs[0][0], OUT_REL, "pool")
    _close(outs[1][1], outs[0][1], GRAD_REL, "pool gradient")


@pytest.mark.parametrize("mode", ["constant", "edge", "reflect"])
@pytest.mark.parametrize("width", [(0, 0, 0, 0, 2, 1, 1, 3),
                                   (1, 0, 0, 2, 0, 0, 3, 1)],
                         ids=["spatial", "batch_and_channels"])
def test_pad_op_matches_jax(mode, width):
    x = _x(2, 3, 5, 4)
    outs = []
    for pkg in (jmx, tmx):
        a = pkg.nd.array(x)
        a.attach_grad()
        with pkg.autograd.record():
            out = pkg.nd.pad(a, mode=mode, pad_width=width,
                             constant_value=1.5)
        out.backward(pkg.nd.array(_x(*out.shape, seed=4)))
        outs.append((out.asnumpy(), a.grad.asnumpy()))
    _close(outs[1][0], outs[0][0], OUT_REL, "pad")
    _close(outs[1][1], outs[0][1], GRAD_REL, "pad gradient")


DECONV_OPS = [
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 1), num_filter=4),
    dict(kernel=(3, 3), dilate=(2, 2), num_filter=4),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), num_filter=6,
         num_group=3),
    dict(kernel=(4,), stride=(3,), pad=(2,), adj=(2,), num_filter=2),
]


@pytest.mark.parametrize("kw", DECONV_OPS, ids=["adj", "dilate", "groups",
                                                "1d"])
def test_deconvolution_op_matches_jax(kw):
    nd = len(kw["kernel"])
    g = kw.get("num_group", 1)
    x = _x(*((2, 3) + (6,) * nd))
    w = _x(*((3, kw["num_filter"] // g) + kw["kernel"]), seed=1)
    outs = []
    for pkg in (jmx, tmx):
        a, b = pkg.nd.array(x), pkg.nd.array(w)
        a.attach_grad()
        b.attach_grad()
        with pkg.autograd.record():
            out = pkg.nd.Deconvolution(a, b, no_bias=True, **kw)
        out.backward(pkg.nd.array(_x(*out.shape, seed=5)))
        outs.append((out.asnumpy(), a.grad.asnumpy(), b.grad.asnumpy()))
    for got, ref, what in zip(outs[1], outs[0], ("out", "dx", "dw")):
        _close(got, ref, OUT_REL if what == "out" else GRAD_REL, what)


def test_deconvolution_refuses_adj_torch_cannot_take():
    with pytest.raises(MXNetError, match="adj"):
        tmx.nd.Deconvolution(tmx.nd.array(_x(1, 2, 4, 4)),
                             tmx.nd.array(_x(2, 2, 3, 3)), kernel=(3, 3),
                             adj=(1, 1), num_filter=2, no_bias=True)


def test_convolution_infers_deconv_weight_shapes():
    """``Symbol.infer_shape`` fills a transposed convolution's weight
    ``[in, out / groups, *kernel]`` and bias from the data shape."""
    sym = tmx.sym.Deconvolution(tmx.sym.var("data"),
                                tmx.sym.var("dc_weight"),
                                tmx.sym.var("dc_bias"), kernel=(3, 3),
                                num_filter=6, num_group=2, no_bias=False,
                                name="dc")
    args, _, _ = sym.infer_shape(data=(1, 4, 5, 5))
    shapes = dict(zip(sym.list_arguments(), args))
    assert shapes["dc_weight"] == (4, 3, 3, 3)
    assert shapes["dc_bias"] == (6,)


# ----------------------------------------------------------- activations
ACTS = {
    "leaky_relu": lambda nn, c: nn.LeakyReLU(0.1, prefix="l_"),
    "prelu": lambda nn, c: nn.PReLU(prefix="l_"),
    "elu": lambda nn, c: nn.ELU(0.5, prefix="l_"),
    "selu": lambda nn, c: nn.SELU(prefix="l_"),
    "gelu": lambda nn, c: nn.GELU(prefix="l_"),
    "swish": lambda nn, c: nn.Swish(1.5, prefix="l_"),
}


@pytest.mark.parametrize("case", sorted(ACTS))
def test_activation_layers_match_jax(case, tmp_path):
    x = _x(2, 3, 4, 5)
    jb, tb = _pair(ACTS[case])
    _check_pair(jb, tb, [x])
    _export_pair(jb, tb, [x], tmp_path)


def test_rrelu_draws_slopes_in_training_from_the_device_stream():
    """rrelu outside training takes the midpoint slope, as the JAX op; in
    training each negative element's slope is uniform in [lower, upper)
    from the device's stream (two calls draw different slopes).  The
    draws are never compared with the JAX package's."""
    x = -np.abs(_x(4, 256)) - 0.5
    kw = dict(act_type="rrelu", lower_bound=0.1, upper_bound=0.3)
    _close(tmx.nd.LeakyReLU(tmx.nd.array(x), **kw),
           jmx.nd.LeakyReLU(jmx.nd.array(x), **kw), OUT_REL, "eval")
    with tmx.autograd.record():
        a = tmx.nd.LeakyReLU(tmx.nd.array(x), **kw).asnumpy()
        b = tmx.nd.LeakyReLU(tmx.nd.array(x), **kw).asnumpy()
    for out in (a, b):
        slope = out / x
        assert slope.min() >= 0.1 and slope.max() < 0.3
    assert not np.array_equal(a, b)


# ----------------------------------------------------------------- norms
NORMS = {
    "instance_norm": (lambda nn, c: nn.InstanceNorm(scale=True,
                                                    prefix="l_"),
                      (2, 3, 5, 5)),
    "instance_norm_fixed_gamma": (lambda nn, c: nn.InstanceNorm(
        epsilon=1e-3, prefix="l_"), (2, 3, 7)),
    "group_norm": (lambda nn, c: nn.GroupNorm(num_groups=2, prefix="l_"),
                   (2, 6, 4, 4)),
    "group_norm_3d": (lambda nn, c: nn.GroupNorm(num_groups=3,
                                                 center=False, prefix="l_"),
                      (2, 6, 3, 4, 2)),
}


@pytest.mark.parametrize("case", sorted(NORMS))
def test_norm_layers_match_jax(case, tmp_path):
    make, shape = NORMS[case]
    x = _x(*shape) * 3.0 + 1.0
    jb, tb = _pair(make)
    _check_pair(jb, tb, [x])
    _export_pair(jb, tb, [x], tmp_path)


@pytest.mark.parametrize("scale", [True, False], ids=["scale", "fix_gamma"])
def test_sync_batch_norm_is_local_batch_norm_like_jax(scale, tmp_path):
    """Without ``axis_name`` SyncBatchNorm is BatchNorm on one device (the
    unclamped one-pass variance): output, gradients and moving statistics
    after two training-mode calls as the JAX layer's; its export imports
    back to the same eval output."""
    x = _x(4, 3, 5, 5) * 2.0 + 0.5
    jb, tb = _pair(lambda nn, c: c.SyncBatchNorm(scale=scale, momentum=0.8,
                                                 prefix="l_"))
    _check_pair(jb, tb, [x])
    _check_pair(jb, tb, [x * 0.5])
    assert tcnn.SyncBatchNorm is tnn.SyncBatchNorm
    _export_pair(jb, tb, [x], tmp_path, json_equal=False)


def test_sync_batch_norm_axis_name_outside_a_body_raises():
    """With ``axis_name`` and neither a shard_map body nor a mesh with
    that axis the moments have nothing to average over: it raises, as
    ``lax.pmean`` does with an unbound axis (the reduction itself is in
    ``test_torch_sync_batch_norm.py``)."""
    layer = tnn.SyncBatchNorm(axis_name="dp", in_channels=3)
    layer.initialize(ctx=tmx.cpu())
    with pytest.raises(MXNetError, match="unbound axis"):
        layer(torch.ones(2, 3, 2, 2))
    with pytest.raises(MXNetError, match="unbound axis"):
        tmx.nd._contrib_SyncBatchNorm(
            *[tmx.nd.ones(s) for s in ((2, 3, 2, 2), (3,), (3,), (3,),
                                       (3,))], axis_name="dp")


# --------------------------------------------------------------- contrib
def _branches(nn, c, cls, axis):
    net = cls(axis=axis, prefix="l_")
    with net.name_scope():
        net.add(nn.Conv2D(4, 1))
        net.add(c.Identity())
        net.add(nn.Conv2D(2, 3, padding=1, activation="relu"))
    return net


@pytest.mark.parametrize("cls", ["HybridConcurrent", "Concurrent"])
def test_concurrent_layers_match_jax(cls, tmp_path):
    x = _x(2, 3, 5, 5)
    jb, tb = _pair(lambda nn, c: _branches(nn, c, getattr(c, cls), 1))
    out = _check_pair(jb, tb, [x])
    assert out.shape == (2, 9, 5, 5)
    if cls == "HybridConcurrent":
        _export_pair(jb, tb, [x], tmp_path)


@pytest.mark.parametrize("ndim,factor,shape", [
    (1, 3, (2, 6, 5)), (2, (2, 3), (2, 12, 3, 4)), (3, 2, (1, 16, 2, 3, 2))])
def test_pixel_shuffle_matches_jax(ndim, factor, shape):
    x = _x(*shape)
    jb, tb = _pair(lambda nn, c: getattr(c, f"PixelShuffle{ndim}D")(factor))
    _check_pair(jb, tb, [x])


def test_identity_passes_its_input_through():
    x = tmx.nd.array(_x(2, 3))
    assert np.array_equal(tcnn.Identity()(x).asnumpy(), x.asnumpy())
