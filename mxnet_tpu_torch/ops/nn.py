"""Neural-network operators, as plain functions on tensors.

Counterparts of the ops in ``mxnet_tpu/ops/nn.py`` and
``mxnet_tpu/ops/matrix.py`` that the training slices and the vision zoo
run: BatchNorm (with the one-pass or centred variance), SyncBatchNorm on
one device, LayerNorm, InstanceNorm, GroupNorm, 1-, 2- and 3-D
Convolution and Deconvolution, max/avg/sum/Lp Pooling, FullyConnected,
Embedding, Dropout, the ``Activation`` and ``LeakyReLU`` activations,
CTC, ``log_softmax``, ``pick``, ``im2col`` and the fused RNN (:func:`rnn`:
LSTM, GRU, tanh and relu, multi-layer, bidirectional, one cuDNN call per
layer and direction on the card).  Layouts are the JAX
package's: NCHW activations (a 2-D convolution runs channels_last inside
under ``MXNET_TPU_CONV_LAYOUT=NHWC``), ``[out, in, kh, kw]`` conv weights
and ``[units, in_units]`` dense weights.  The JAX package leaves its
convolutions and matrix products to XLA, so here they go to
``torch.nn.functional``.  Where jnp promotes mixed dtypes (an fp32
activation against a bf16 weight under amp) these ops promote too.

The second half registers them as registry ops under the JAX package's
names and params (``FullyConnected``, ``Convolution``, ``Pooling``,
``Activation``, ``BatchNorm``, ``LayerNorm``, ``Embedding``, ``Dropout``,
``softmax``, ``log_softmax``, ``SoftmaxOutput``, ``Deconvolution``,
``LeakyReLU``, ``InstanceNorm``, ``GroupNorm``, ``_contrib_SyncBatchNorm``,
``CTCLoss``, ``softmin``, ``SoftmaxActivation``, ``LRN``,
``softmax_cross_entropy``, ``masked_softmax``, ``masked_log_softmax``,
``ROIPooling``, ``im2col``, ``RNN`` and their aliases), so
``mx.nd`` and ``mx.sym`` reach them and an exported graph runs through
them.  Each op parses the stringified attrs a loaded symbol JSON may carry
(``"True"``, ``"(3, 3)"``) and calls the function above.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError, attr_truthy, dtype_torch, env
from .embedding import embedding_lookup
from .registry import get as _get_op
from .registry import register

__all__ = ["batch_norm", "layer_norm", "convolution", "deconvolution",
           "pooling", "fully_connected", "embedding", "dropout",
           "activation", "relu", "leaky_relu", "instance_norm", "group_norm",
           "sync_batch_norm", "ctc_loss", "softmax", "log_softmax", "pick",
           "im2col", "rnn", "rnn_param_shapes", "conv_nhwc"]


def _moments_of(x32, red, keepdim=False):
    """Mean and biased variance of ``x32`` over the dims ``red``: one pass,
    ``max(E[x^2] - E[x]^2, 0)``, under ``MXNET_TPU_FAST_VARIANCE=1`` (the
    default), else the centred ``E[(x - mean)^2]``."""
    mean = x32.mean(dim=red, keepdim=True)
    if env.MXNET_TPU_FAST_VARIANCE:
        mean2 = x32.square().mean(dim=red, keepdim=True)
        var = torch.maximum(mean2 - mean.square(), mean.new_zeros(()))
    else:
        var = (x32 - mean).square().mean(dim=red, keepdim=True)
    if not keepdim:
        mean, var = mean.squeeze(red), var.squeeze(red)
    return mean, var


def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               fix_gamma=True, axis=1, training=True):
    """``(out, mean, var)``: normalise ``data`` over every dim but ``axis``.

    In training the statistics are the batch's, in fp32, and the variance
    is biased; otherwise they are the moving ones.  ``inv`` and the affine
    are applied in ``data``'s dtype, and ``mean``/``var`` come back in the
    moving statistics' dtype, as in the JAX package.  The caller owns the
    moving-statistics update."""
    red = tuple(i for i in range(data.dim()) if i != axis)
    bshape = [1] * data.dim()
    bshape[axis] = data.shape[axis]
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if training:
        mean, var = _moments_of(data.float(), red)
    else:
        mean, var = moving_mean, moving_var
    inv = torch.rsqrt(var.float() + eps).to(data.dtype)
    out = ((data - mean.reshape(bshape).to(data.dtype)) * inv.reshape(bshape)
           * g.reshape(bshape).to(data.dtype)
           + beta.reshape(bshape).to(data.dtype))
    return out, mean.to(moving_mean.dtype), var.to(moving_var.dtype)


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    """Normalise over ``axis`` with fp32 moments, round
    ``(x - mean)·rsqrt(var + eps)`` to ``data``'s dtype, then apply
    ``gamma``/``beta`` with torch's promotion (fp32 for a bf16 ``data``
    and fp32 ``gamma``, as jnp gives)."""
    return _layer_norm(data, gamma, beta, axis, eps)[0]


def _layer_norm(data, gamma, beta, axis, eps):
    """:func:`layer_norm` and its fp32 mean and variance (``axis``
    squeezed out)."""
    x32 = data.float()
    ax = axis % data.dim()
    mean, var = _moments_of(x32, (ax,), keepdim=True)
    bshape = [1] * data.dim()
    bshape[ax] = data.shape[ax]
    out = (((x32 - mean) * torch.rsqrt(var + eps)).to(data.dtype)
           * gamma.reshape(bshape) + beta.reshape(bshape))
    return out, mean.squeeze(ax), var.squeeze(ax)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def convolution(data, weight, bias=None, stride=(1, 1), pad=(0, 0),
                dilate=(1, 1), num_group=1):
    """1-, 2- or 3-D convolution (by the weight's rank): ``NC[D]H[W]``
    data and ``[out, in / num_group, *kernel]`` weight.  Under
    ``MXNET_TPU_CONV_LAYOUT=NHWC`` a 2-D convolution takes its data
    channels_last (a copy, unless it is already), which makes torch run
    the channels_last kernels and return a channels_last tensor of the
    same NCHW shape, so a chain of convolutions stays channels_last."""
    if weight.dim() == 4 and conv_nhwc():
        data = data.contiguous(memory_format=torch.channels_last)
    return _CONV[weight.dim() - 2](data, weight, bias, tuple(stride),
                                   tuple(pad), tuple(dilate), num_group)


def conv_nhwc() -> bool:
    """True when 2-D convolutions run channels-last
    (``MXNET_TPU_CONV_LAYOUT=NHWC``)."""
    return env.MXNET_TPU_CONV_LAYOUT.strip().upper() == "NHWC"


def deconvolution(data, weight, bias=None, stride=(1, 1), pad=(0, 0),
                  dilate=(1, 1), adj=(0, 0), num_group=1):
    """The transposed convolution of :func:`convolution`, weight
    ``[in, out / num_group, *kernel]``: output size ``(in − 1)·stride +
    (kernel − 1)·dilate + 1 − 2·pad + adj``.  The JAX package writes it as
    an input-dilated convolution with the flipped kernel, the high edge
    padded by ``adj`` more; torch's ``output_padding`` is that ``adj``,
    which torch takes below ``stride`` or ``dilate`` only."""
    nd = weight.dim() - 2
    if any(a >= max(s, d) for a, s, d in zip(adj, stride, dilate)):
        raise MXNetError(f"Deconvolution: adj {tuple(adj)} must stay below "
                         f"stride {tuple(stride)} or dilate {tuple(dilate)}")
    return _DECONV[nd](data, weight, bias, tuple(stride), tuple(pad),
                       tuple(adj), num_group, tuple(dilate))


def _edges(pads):
    """``F.pad``'s edge list (last dim first) from ``(lo, hi)`` per
    spatial dim."""
    return tuple(e for lo, hi in reversed(pads) for e in (lo, hi))


def _sum_pool(x, kernel, stride):
    """The sum over each window (no padding): an average pool with
    divisor 1 (a 1-D pool runs as 2-D, which takes ``divisor_override``)."""
    if len(kernel) == 1:
        return F.avg_pool2d(x.unsqueeze(2), (1,) + kernel, (1,) + stride,
                            divisor_override=1).squeeze(2)
    pool = F.avg_pool2d if len(kernel) == 2 else F.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def pooling(data, kernel=(1, 1), pool_type="max", global_pool=False,
            stride=None, pad=(0, 0), ceil_mode=False, count_include_pad=True,
            p_value=2):
    """Max, average, sum or Lp (``p_value``) pooling over 1-, 2- or 3-D
    ``kernel`` windows of ``NC...`` data, ``stride`` defaulting to
    ``kernel``; the 'valid' convention, or with ``ceil_mode`` the 'full'
    one, whose last window the JAX package pads on the high edge (max pads
    with -inf, the others with zeros; an average divides by the window's
    size, or with ``count_include_pad`` False by its count of real
    elements).  ``global_pool`` reduces every spatial dim.  Where torch's
    own padding is the JAX package's (valid, pad at most half the window)
    max and average pool with it; otherwise the input is padded first."""
    if pool_type not in ("max", "avg", "sum", "lp"):
        raise MXNetError(f"pooling: unknown pool_type {pool_type!r}")
    nd = data.dim() - 2
    if global_pool:
        dims = tuple(range(2, data.dim()))
        if pool_type == "max":
            return data.amax(dim=dims, keepdim=True)
        if pool_type == "avg":
            return data.mean(dim=dims, keepdim=True)
        if pool_type == "sum":
            return data.sum(dim=dims, keepdim=True)
        return data.abs().pow(p_value).sum(dim=dims, keepdim=True).pow(
            1.0 / p_value)
    kernel = tuple(kernel)
    stride = tuple(stride) if stride else kernel
    pad = tuple(pad)
    if (not ceil_mode and pool_type in ("max", "avg")
            and all(p <= k // 2 for p, k in zip(pad, kernel))):
        if pool_type == "max":
            return _MAX_POOL[nd](data, kernel, stride, pad)
        return _AVG_POOL[nd](data, kernel, stride, pad,
                             count_include_pad=count_include_pad)
    pads = []
    for i in range(nd):
        hi = pad[i]
        if ceil_mode:
            size = data.shape[2 + i] + 2 * pad[i]
            out = -(-(size - kernel[i]) // stride[i]) + 1
            hi += max((out - 1) * stride[i] + kernel[i] - size, 0)
        pads.append((pad[i], hi))
    edges = _edges(pads)
    if pool_type == "max":
        return _MAX_POOL[nd](F.pad(data, edges, value=float("-inf")),
                             kernel, stride)
    if pool_type == "lp":
        return _sum_pool(F.pad(data.abs().pow(p_value), edges), kernel,
                         stride).pow(1.0 / p_value)
    total = _sum_pool(F.pad(data, edges), kernel, stride)
    if pool_type == "sum":
        return total
    if count_include_pad:
        return total / math.prod(kernel)
    ones = F.pad(torch.ones_like(data[:1, :1]), edges)
    return total / _sum_pool(ones, kernel, stride)


def fully_connected(data, weight, bias=None, flatten=True):
    """``data @ weight.T + bias``; ``flatten`` folds every dim after the
    first into the input units.  Mixed operands meet in their common dtype
    before the product, as ``lax.dot_general`` promotes them."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    dtype = torch.promote_types(x.dtype, weight.dtype)
    if bias is None or bias.dtype == dtype:
        return F.linear(x.to(dtype), weight.to(dtype), bias)
    return F.linear(x.to(dtype), weight.to(dtype)) + bias


def embedding(data, weight):
    """Rows of ``weight`` at the integer ``data`` (any shape); the gradient
    is a dense scatter-add into ``weight``'s shape.

    Out-of-range ids follow the JAX package's ``jnp.take``: an id in
    [-V, 0) counts from the end, and any other id outside [0, V) gives a
    NaN row (a floating table) and adds nothing to the gradient.  No bad
    id reaches ``F.embedding``, where the card would fault.  The backward
    is :func:`.embedding.embedding_backward`, which adds in the same order
    on every run (``csrc/embedding_bwd.cu`` on the card)."""
    out, ok = embedding_lookup(data, weight)
    if not weight.is_floating_point():
        return out
    return torch.where(ok.unsqueeze(-1), out, torch.nan)


def dropout(data, p=0.5, training=True, generator=None, axes=()):
    """Zero each element with probability ``p`` and scale the kept ones by
    ``1/(1 − p)``; the keep mask is Bernoulli(1 − p) from ``generator``
    (a ``torch.Generator`` on ``data``'s device), shared along ``axes``.
    Identity when not training or when ``p`` is 0."""
    if not training or p <= 0.0:
        return data
    if generator is None:
        raise MXNetError("dropout draws its mask from an explicit "
                         "torch.Generator; pass generator=")
    shape = list(data.shape)
    for ax in axes:
        shape[ax] = 1
    keep = 1.0 - p
    mask = torch.empty(shape, device=data.device).bernoulli_(
        keep, generator=generator).bool()
    return torch.where(mask, data / keep, data.new_zeros(()))


def relu(data):
    return torch.relu(data)


_ACTIVATIONS = {"relu": relu, "tanh": torch.tanh, "sigmoid": torch.sigmoid,
                "softrelu": F.softplus, "softsign": F.softsign,
                # jax.nn.gelu(approximate=False): the exact erf form
                "gelu": F.gelu}


def activation(data, act_type="relu"):
    """The ``Activation`` op: ``relu``, ``tanh``, ``sigmoid``,
    ``softrelu``, ``softsign`` or the exact ``gelu``."""
    if act_type not in _ACTIVATIONS:
        raise MXNetError(f"activation {act_type!r} is not ported")
    return _ACTIVATIONS[act_type](data)


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334, training=False,
               generator=None):
    """The ``LeakyReLU`` op's activations: ``leaky`` (``slope·x`` below
    0), ``prelu`` (the learned ``gamma``, one per channel of axis 1 when
    it is 1-D), ``elu`` (``slope·(eˣ − 1)``), ``selu``, the exact ``gelu``
    and ``rrelu``, whose slope in training is uniform in ``[lower_bound,
    upper_bound)`` per element from ``generator`` (a ``torch.Generator``
    on ``data``'s device) and otherwise their midpoint."""
    neg = data >= 0
    if act_type == "leaky":
        return torch.where(neg, data, slope * data)
    if act_type == "prelu":
        g = (gamma.reshape((1, -1) + (1,) * (data.dim() - 2))
             if gamma.dim() == 1 else gamma)
        return torch.where(neg, data, g * data)
    if act_type == "elu":
        return torch.where(neg, data, slope * torch.expm1(data))
    if act_type == "selu":
        return _SELU_SCALE * torch.where(neg, data,
                                         _SELU_ALPHA * torch.expm1(data))
    if act_type == "gelu":
        return F.gelu(data)
    if act_type == "rrelu":
        if training:
            if generator is None:
                raise MXNetError("rrelu draws its slopes from an explicit "
                                 "torch.Generator; pass generator=")
            s = torch.empty(data.shape, device=data.device).uniform_(
                lower_bound, upper_bound, generator=generator)
            return torch.where(neg, data, s.to(data.dtype) * data)
        return torch.where(neg, data, (lower_bound + upper_bound) / 2.0
                           * data)
    raise MXNetError(f"LeakyReLU: unknown act_type {act_type!r}")


def _channel_shape(data):
    return (1, -1) + (1,) * (data.dim() - 2)


def instance_norm(data, gamma, beta, eps=1e-3):
    """Normalise each sample's channel over its spatial dims with fp32
    moments, round to ``data``'s dtype, then ``gamma``/``beta`` per
    channel."""
    x32 = data.float()
    mean, var = _moments_of(x32, tuple(range(2, data.dim())), keepdim=True)
    out = ((x32 - mean) * torch.rsqrt(var + eps)).to(data.dtype)
    return (out * gamma.reshape(_channel_shape(data))
            + beta.reshape(_channel_shape(data)))


def group_norm(data, gamma, beta, num_groups=1, eps=1e-5):
    """Normalise each sample over the channels of each of ``num_groups``
    groups and the spatial dims (fp32 moments), then ``gamma``/``beta``
    per channel."""
    n, c = data.shape[:2]
    x = data.reshape((n, num_groups, c // num_groups)
                     + tuple(data.shape[2:])).float()
    mean, var = _moments_of(x, tuple(range(2, x.dim())), keepdim=True)
    out = ((x - mean) * torch.rsqrt(var + eps)).reshape(data.shape).to(
        data.dtype)
    return (out * gamma.reshape(_channel_shape(data))
            + beta.reshape(_channel_shape(data)))


def sync_batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                    fix_gamma=True, training=True, axis_name=None):
    """``(out, mean, var)`` of ``_contrib_SyncBatchNorm``: BatchNorm over
    axis 1 whose batch variance is ``E[x²] − E[x]²`` unclamped, whatever
    ``MXNET_TPU_FAST_VARIANCE`` says, as the JAX op computes it.

    With ``axis_name`` the per-position moments (``E[x]`` and ``E[x²]``)
    are averaged over that mesh axis with
    :func:`~mxnet_tpu_torch.parallel.pmean`, as the JAX op's ``lax.pmean``:
    inside a ``shard_map`` body every argument is the positions' list and
    so are the results; outside one, under an entered mesh with that
    axis, the op splits the batch over the axis itself (a meshed
    ``CompiledTrainStep``'s forward) and returns whole tensors.  With
    neither it raises, as ``lax.pmean`` does with an unbound axis."""
    if axis_name in (None, "", "None"):
        return _sync_bn_local(data, gamma, beta, moving_mean, moving_var,
                              eps, fix_gamma, training)
    from ..parallel import collectives as C

    def body(xs, gs, bs, mms, mvs):
        if not training:
            outs = [_sync_bn_local(*a, eps, fix_gamma, False)
                    for a in zip(xs, gs, bs, mms, mvs)]
            return tuple(list(o) for o in zip(*outs))
        red = tuple(i for i in range(xs[0].dim()) if i != 1)
        means = C.pmean([x.float().mean(dim=red) for x in xs], axis_name)
        sqs = C.pmean([x.float().square().mean(dim=red) for x in xs],
                      axis_name)
        outs, ms, vs = [], [], []
        for x, g, b, mm, mv, m, sq in zip(xs, gs, bs, mms, mvs, means, sqs):
            var = sq - m.square()
            out, _, _ = batch_norm(x, g, b, m, var, eps, fix_gamma, 1, False)
            outs.append(out)
            ms.append(m.to(mm.dtype))
            vs.append(var.to(mv.dtype))
        return outs, ms, vs

    if isinstance(data, (list, tuple)):
        return body(list(data), *(
            list(a) if isinstance(a, (list, tuple)) else [a] * len(data)
            for a in (gamma, beta, moving_mean, moving_var)))
    from ..parallel.mesh import PartitionSpec as P, current_mesh
    mesh = current_mesh()
    if mesh is None or axis_name not in mesh.axis_names:
        raise MXNetError(
            f"SyncBatchNorm: unbound axis name {axis_name!r}: call it inside "
            "a shard_map body or under a mesh with that axis")
    return C.shard_map(body, mesh, (P(axis_name), P(), P(), P(), P()),
                       (P(axis_name), P(), P()))(
        data, gamma, beta, moving_mean, moving_var)


def _sync_bn_local(data, gamma, beta, moving_mean, moving_var, eps,
                   fix_gamma, training):
    """:func:`sync_batch_norm` on one device (no axis)."""
    if training:
        red = tuple(i for i in range(data.dim()) if i != 1)
        x32 = data.float()
        mean = x32.mean(dim=red)
        var = x32.square().mean(dim=red) - mean.square()
    else:
        mean, var = moving_mean, moving_var
    # normalising with given statistics is batch_norm outside training
    out, _, _ = batch_norm(data, gamma, beta, mean, var, eps, fix_gamma, 1,
                           False)
    return out, mean.to(moving_mean.dtype), var.to(moving_var.dtype)


def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             blank_label="first"):
    """Per-sequence CTC negative log-likelihood of ``data`` (``[T, N,
    C]`` activations, softmax over C) against ``label`` (``[N, L]``), the
    blank class 0, as the JAX package's ``optax.ctc_loss`` takes it.
    Without ``label_lengths`` a label ends at its first id ≤ 0 for
    ``blank_label='first'`` and is all L ids otherwise; without
    ``data_lengths`` every sequence is T steps."""
    t, n, _ = data.shape
    labels = label.long()
    if label_lengths is not None:
        lab_len = label_lengths.long()
    elif blank_label == "first":
        lab_len = (labels > 0).long().sum(dim=1)
    else:
        lab_len = torch.full((n,), labels.shape[1], dtype=torch.long,
                             device=data.device)
    in_len = (torch.full((n,), t, dtype=torch.long, device=data.device)
              if data_lengths is None else data_lengths.long())
    logp = torch.log_softmax(data.float(), dim=-1)
    return F.ctc_loss(logp, labels.clamp_min(0), in_len, lab_len, blank=0,
                      reduction="none").to(data.dtype)


def log_softmax(data, axis=-1):
    return torch.log_softmax(data, dim=axis)


def softmax(data, axis=-1, length=None):
    """Softmax over ``axis``; with ``length`` (one count per position of
    the other axes) the positions at or past it get probability 0."""
    if length is None:
        return torch.softmax(data, dim=axis)
    ax = axis % data.dim()
    pos = torch.arange(data.shape[ax], device=data.device).reshape(
        (-1,) + (1,) * (data.dim() - 1 - ax))
    mask = pos < length.unsqueeze(ax)
    p = torch.softmax(data.masked_fill(~mask, float("-inf")), dim=ax)
    return p.masked_fill(~mask, 0.0)


def pick(data, index, axis=-1, keepdims=False):
    """``data`` at ``index`` along ``axis``; indices arrive as floats or
    ints and are clipped into range (the JAX package's default mode)."""
    idx = index.long().clamp(0, data.shape[axis] - 1)
    picked = torch.gather(data, axis, idx.unsqueeze(axis))
    return picked if keepdims else picked.squeeze(axis)


# ---------------------------------------------------------------------------
# the registry ops (mxnet_tpu/ops/nn.py's names, params and outputs)
# ---------------------------------------------------------------------------
def _ints(v, n, default):
    """A tuple of ``n`` ints from an attr (empty -> ``default``)."""
    v = tuple(v) if isinstance(v, (tuple, list)) else (
        (v,) * n if v not in (None, "") else ())
    return tuple(int(e) for e in v) if v else (default,) * n


@register("FullyConnected", nin=None, aliases=["fully_connected"])
def _fully_connected_op(args, num_hidden=0, no_bias=False, flatten=True):
    data, weight, bias = (*args, None)[:3] if attr_truthy(no_bias) else args
    return fully_connected(data, weight, bias, attr_truthy(flatten))


@register("Convolution", nin=None, aliases=["convolution"])
def _convolution_op(args, kernel=(), stride=(), dilate=(), pad=(),
                    num_filter=0, num_group=1, no_bias=False, workspace=1024,
                    cudnn_tune=None, cudnn_off=False, layout=None):
    data, weight, bias = (*args, None)[:3] if attr_truthy(no_bias) else args
    nd = len(kernel)
    if nd not in _CONV:
        raise MXNetError(f"Convolution: {nd}-D kernels do not exist; 1-, "
                         "2- and 3-D do")
    return convolution(data, weight, bias, _ints(stride, nd, 1),
                       _ints(pad, nd, 0), _ints(dilate, nd, 1),
                       int(num_group))


@register("Deconvolution", nin=None, aliases=["deconvolution"])
def _deconvolution_op(args, kernel=(), stride=(), dilate=(), pad=(), adj=(),
                      target_shape=(), num_filter=0, num_group=1,
                      no_bias=True, workspace=1024, cudnn_tune=None,
                      cudnn_off=False, layout=None):
    data, weight, bias = (*args, None)[:3] if attr_truthy(no_bias) else args
    nd = len(kernel)
    return deconvolution(data, weight, bias, _ints(stride, nd, 1),
                         _ints(pad, nd, 0), _ints(dilate, nd, 1),
                         _ints(adj, nd, 0), int(num_group))


@register("Pooling", nin=1, aliases=["pooling"])
def _pooling_op(data, kernel=(), pool_type="max", global_pool=False,
                cudnn_off=False, pooling_convention="valid", stride=(),
                pad=(), p_value=2, count_include_pad=True, layout=None):
    # the JAX package's defaults: stride 1 (not the kernel) and pad 0
    nd = len(kernel) or data.dim() - 2
    return pooling(data, _ints(kernel, nd, 1), pool_type,
                   attr_truthy(global_pool), stride=_ints(stride, nd, 1),
                   pad=_ints(pad, nd, 0),
                   ceil_mode=pooling_convention == "full",
                   count_include_pad=attr_truthy(count_include_pad),
                   p_value=float(p_value))


@register("LeakyReLU", nin=None)
def _leaky_relu_op(args, act_type="leaky", slope=0.25, lower_bound=0.125,
                   upper_bound=0.334, generator=None, _training=False):
    data, gamma = (args[0], args[1] if len(args) > 1 else None) if \
        isinstance(args, (list, tuple)) else (args, None)
    return leaky_relu(data, gamma, act_type, float(slope),
                      float(lower_bound), float(upper_bound), _training,
                      generator)


@register("InstanceNorm", nin=3)
def _instance_norm_op(data, gamma, beta, eps=1e-3):
    return instance_norm(data, gamma, beta, float(eps))


@register("GroupNorm", nin=3)
def _group_norm_op(data, gamma, beta, num_groups=1, eps=1e-5):
    return group_norm(data, gamma, beta, int(num_groups), float(eps))


@register("_contrib_SyncBatchNorm", nin=5, nout=3, aliases=["SyncBatchNorm"])
def _sync_batch_norm_op(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                        momentum=0.9, fix_gamma=True, use_global_stats=False,
                        output_mean_var=False, ndev=1, key=None,
                        axis_name=None, _training=True):
    """``(out, mean, var)`` (see :func:`sync_batch_norm`); ``key`` and
    ``ndev`` are accepted for the reference's signature."""
    return sync_batch_norm(data, gamma, beta, moving_mean, moving_var,
                           float(eps), attr_truthy(fix_gamma),
                           _training and not attr_truthy(use_global_stats),
                           axis_name=axis_name)


@register("CTCLoss", nin=None, aliases=["ctc_loss"])
def _ctc_loss_op(args, use_data_lengths=False, use_label_lengths=False,
                 blank_label="first"):
    use_data, use_label = (attr_truthy(use_data_lengths),
                           attr_truthy(use_label_lengths))
    data, label = args[0], args[1]
    data_lengths = args[2] if use_data else None
    label_lengths = (args[3] if use_data else args[2]) if use_label else None
    return ctc_loss(data, label, data_lengths, label_lengths, blank_label)


@register("Activation", nin=1, aliases=["activation"])
def _activation_op(data, act_type="relu"):
    return activation(data, act_type)


@register("BatchNorm", nin=5, nout=3,
          aliases=["batch_norm", "BatchNorm_v1"])
def _batch_norm_op(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                   momentum=0.9, fix_gamma=True, use_global_stats=False,
                   output_mean_var=False, axis=1, cudnn_off=False,
                   min_calib_range=None, max_calib_range=None,
                   _training=True):
    """``(out, mean, var)``: the batch's statistics in training, the moving
    ones otherwise (the moving-statistics update is the caller's: the
    Gluon layer, or the symbolic evaluator)."""
    return batch_norm(data, gamma, beta, moving_mean, moving_var,
                      float(eps), attr_truthy(fix_gamma), int(axis),
                      _training and not attr_truthy(use_global_stats))


@register("LayerNorm", nin=3, nout=3)
def _layer_norm_op(data, gamma, beta, axis=-1, eps=1e-5,
                   output_mean_var=False):
    return _layer_norm(data, gamma, beta, int(axis), float(eps))


@register("Embedding", nin=2)
def _embedding_op(data, weight, input_dim=0, output_dim=0, dtype="float32",
                  sparse_grad=False):
    if attr_truthy(sparse_grad):
        raise MXNetError("Embedding: sparse gradients are not ported")
    return embedding(data, weight)


@register("Dropout", nin=1)
def _dropout_op(data, p=0.5, mode="training", axes=(), cudnn_off=False,
                generator=None, _training=True):
    training = _training or mode == "always"
    return dropout(data, float(p), training, generator, tuple(axes))


def _softmax_cast_in(data, dtype):
    """The JAX package's dtype rule: a wider ``dtype`` casts the input
    before the exp and sum; a narrower one casts the output."""
    if dtype is None:
        return data, None
    dt = dtype_torch(dtype)
    if dt.itemsize > data.dtype.itemsize:
        return data.to(dt), None
    return data, dt


@register("softmax", nin=None)
def _softmax_op(args, axis=-1, temperature=None, dtype=None,
                use_length=False, length=None):
    if isinstance(args, (list, tuple)):
        data = args[0]
        length = args[1] if len(args) > 1 else length
    else:
        data = args
    data, cast_out = _softmax_cast_in(data, dtype)
    x = data / float(temperature) if temperature else data
    out = softmax(x, int(axis),
                  length if attr_truthy(use_length) else None)
    return out.to(cast_out) if cast_out is not None else out


@register("log_softmax", nin=1)
def _log_softmax_op(data, axis=-1, temperature=None, dtype=None):
    data, cast_out = _softmax_cast_in(data, dtype)
    x = data / float(temperature) if temperature else data
    out = log_softmax(x, int(axis))
    return out.to(cast_out) if cast_out is not None else out


def _softmax_output_grad(params, inputs, outputs, out_grads):
    """The head's gradient, whatever the output gradient: ``(prob -
    label)·grad_scale``, with ``ignore_label`` rows masked and the
    ``batch``/``valid`` normalisations (mxnet_tpu/ops/nn.py:501)."""
    data, label = inputs
    prob = outputs[0]
    ignore_label = float(params.get("ignore_label", -1))
    use_ignore = attr_truthy(params.get("use_ignore", False))
    normalization = params.get("normalization", "null")
    class_axis = 1 if attr_truthy(params.get("multi_output", False)) else -1
    if label.dim() == prob.dim():  # one-hot labels
        grad = prob - label
    else:
        # clamped first: an ignored row may carry any label (-1 by
        # default), and its row is masked below
        oh = F.one_hot(label.long().clamp(0, prob.shape[class_axis] - 1),
                       prob.shape[class_axis]).to(prob.dtype)
        if class_axis == 1:
            oh = oh.movedim(-1, 1)
        grad = prob - oh
        if use_ignore:
            keep = (label != ignore_label).to(prob.dtype)
            grad = grad * keep.unsqueeze(class_axis)
    scale = float(params.get("grad_scale", 1.0))
    if normalization == "batch":
        scale = scale / prob.shape[0]
    elif normalization == "valid" and use_ignore:
        scale = scale / max(int((label != ignore_label).sum()), 1)
    return grad * scale, None


@register("SoftmaxOutput", nin=2, grad=_softmax_output_grad,
          aliases=["Softmax"])
def _softmax_output_op(data, label, grad_scale=1.0, ignore_label=-1.0,
                       multi_output=False, use_ignore=False,
                       preserve_shape=False, normalization="null",
                       out_grad=False, smooth_alpha=0.0):
    """Softmax forward; its gradient is the loss's (see
    :func:`_softmax_output_grad`)."""
    return softmax(data, 1 if attr_truthy(multi_output) else -1)


def _regression_grad(kind):
    """``(pred - label)·grad_scale / batch`` (its sign for ``mae``)
    whatever the output gradient (mxnet_tpu/ops/nn.py:535)."""
    def grad(params, inputs, outputs, out_grads):
        data, label = inputs
        pred = outputs[0]
        scale = float(params.get("grad_scale", 1.0)) / max(1, data.shape[0])
        d = pred - label.reshape(pred.shape)
        if kind == "mae":
            d = torch.sign(d)
        return d * scale, None
    return grad


@register("LinearRegressionOutput", nin=2, grad=_regression_grad("mse"))
def _linear_regression_output(data, label, grad_scale=1.0):
    return data


@register("MAERegressionOutput", nin=2, grad=_regression_grad("mae"))
def _mae_regression_output(data, label, grad_scale=1.0):
    return data


@register("LogisticRegressionOutput", nin=2, grad=_regression_grad("mse"))
def _logistic_regression_output(data, label, grad_scale=1.0):
    return torch.sigmoid(data)


# -- shape inference for Symbol.infer_shape: an op's variable inputs
#    (weight, bias, statistics) from its data input
#    (mxnet_tpu/ops/nn.py:735-830)
def _fc_infer(shapes, params):
    data = shapes[0]
    if data is None:
        return None
    nh = int(params.get("num_hidden", 0))
    in_units = (math.prod(data[1:]) if attr_truthy(params.get("flatten", True))
                else data[-1])
    out = list(shapes)
    out[1] = out[1] or (nh, in_units)
    if len(out) > 2:
        out[2] = out[2] or (nh,)
    return out


def _conv_infer(shapes, params):
    data = shapes[0]
    if data is None:
        return None
    kernel = tuple(params.get("kernel", ()))
    nf = int(params.get("num_filter", 0))
    g = int(params.get("num_group", 1))
    out = list(shapes)
    out[1] = out[1] or (nf, data[1] // g) + kernel
    if len(out) > 2:
        out[2] = out[2] or (nf,)
    return out


def _deconv_infer(shapes, params):
    data = shapes[0]
    if data is None:
        return None
    kernel = tuple(params.get("kernel", ()))
    nf = int(params.get("num_filter", 0))
    g = int(params.get("num_group", 1))
    out = list(shapes)
    out[1] = out[1] or (data[1], nf // g) + kernel
    if len(out) > 2:
        out[2] = out[2] or (nf,)
    return out


def _norm_infer_axis(default_axis):
    def infer(shapes, params):
        data = shapes[0]
        if data is None:
            return None
        c = data[int(params.get("axis", default_axis))]
        return [data] + [(s or (c,)) for s in shapes[1:]]
    return infer


def _embedding_infer(shapes, params):
    out = list(shapes)
    out[1] = out[1] or (int(params.get("input_dim", 0)),
                        int(params.get("output_dim", 0)))
    return out


def _softmax_output_infer(shapes, params):
    data = shapes[0]
    if data is None:
        return None
    out = list(shapes)
    if out[1] is None:  # class-index labels drop the class axis
        if attr_truthy(params.get("multi_output", False)):
            out[1] = (data[0],) + tuple(data[2:])
        else:
            out[1] = tuple(data[:-1])
    return out


_get_op("FullyConnected").infer_shapes = _fc_infer
_get_op("Convolution").infer_shapes = _conv_infer
_get_op("Deconvolution").infer_shapes = _deconv_infer
_get_op("BatchNorm").infer_shapes = _norm_infer_axis(1)
_get_op("_contrib_SyncBatchNorm").infer_shapes = _norm_infer_axis(1)
_get_op("LayerNorm").infer_shapes = _norm_infer_axis(-1)
_get_op("InstanceNorm").infer_shapes = _norm_infer_axis(1)
_get_op("GroupNorm").infer_shapes = _norm_infer_axis(1)
_get_op("Embedding").infer_shapes = _embedding_infer
_get_op("SoftmaxOutput").infer_shapes = _softmax_output_infer


def _regression_infer(shapes, params):
    data = shapes[0]
    if data is None:
        return None
    out = list(shapes)
    out[1] = out[1] or tuple(data)
    return out


for _name in ("LinearRegressionOutput", "LogisticRegressionOutput",
              "MAERegressionOutput"):
    _get_op(_name).infer_shapes = _regression_infer


# ---------------------------------------------------------------------------
# the rest of mxnet_tpu/ops/nn.py: softmin, SoftmaxActivation, LRN,
# softmax_cross_entropy, masked_softmax, masked_log_softmax, ROIPooling,
# im2col
# ---------------------------------------------------------------------------
@register("softmin", nin=1)
def _softmin_op(data, axis=-1, temperature=None, dtype=None):
    data, cast_out = _softmax_cast_in(data, dtype)
    x = -data / float(temperature) if temperature else -data
    out = softmax(x, int(axis))
    return out.to(cast_out) if cast_out is not None else out


@register("SoftmaxActivation", nin=1)
def _softmax_activation_op(data, mode="instance"):
    """Softmax over the channels (``mode='channel'``, axis 1) or over all
    of each instance's values."""
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1).reshape(
        data.shape)


@register("LRN", nin=1)
def _lrn_op(data, nsize=5, alpha=1e-4, beta=0.75, knorm=2.0):
    """Local response normalisation across ``nsize`` neighbouring channels
    of NCHW data: ``x / (knorm + alpha / nsize · Σ x²)^beta``."""
    nsize = int(nsize)
    half = nsize // 2
    sq = F.pad(data.square(), (0, 0, 0, 0, half, half))
    acc = sum(sq[:, i:i + data.shape[1]] for i in range(nsize))
    return data / torch.pow(float(knorm) + float(alpha) / nsize * acc,
                            float(beta))


@register("softmax_cross_entropy", nin=2)
def _softmax_cross_entropy_op(data, label):
    """The summed cross entropy of ``softmax(data)`` against class-index
    ``label``s (a scalar)."""
    logp = torch.log_softmax(data, dim=-1)
    return -logp.gather(-1, label.long().unsqueeze(-1)).sum()


@register("masked_softmax", nin=2)
def _masked_softmax_op(data, mask, axis=-1, temperature=1.0,
                       normalize=True):
    """Softmax over the positions where ``mask`` is true, in fp32; masked
    positions are exactly 0 (a row with none true is all 0)."""
    ax = int(axis)
    m = mask.to(torch.bool)
    x = torch.where(m, data.float() / float(temperature), -1e30)
    p = torch.where(m, torch.exp(x - x.amax(dim=ax, keepdim=True)), 0.0)
    return (p / p.sum(dim=ax, keepdim=True).clamp_min(1e-30)).to(data.dtype)


@register("masked_log_softmax", nin=2)
def _masked_log_softmax_op(data, mask, axis=-1, temperature=1.0):
    """The log of :func:`_masked_softmax_op`; masked positions are -inf."""
    ax = int(axis)
    m = mask.to(torch.bool)
    x = torch.where(m, data.float() / float(temperature), -1e30)
    top = x.amax(dim=ax, keepdim=True)
    lse = torch.log(torch.exp(x - top).sum(dim=ax, keepdim=True)) + top
    return torch.where(m, (x - lse).to(data.dtype), float("-inf"))


@register("ROIPooling", nin=2, differentiable=False)
def _roi_pooling_op(data, rois, pooled_size=(1, 1), spatial_scale=1.0):
    """Max over each of ``pooled_size`` bins of each region ``[batch, x1,
    y1, x2, y2]`` (scaled by ``spatial_scale``, truncated to ints) of NCHW
    ``data``; an empty bin is -inf (the JAX package's form)."""
    ph, pw = (int(v) for v in pooled_size)
    b = rois[:, 0].to(torch.int64)
    x1, y1, x2, y2 = (rois[:, 1:] * float(spatial_scale)).to(
        torch.int32).to(torch.int64).unbind(1)
    img = data[b]                                     # [R, C, H, W]
    H, W = img.shape[2], img.shape[3]

    def bins(lo, hi, n, size):
        extent = torch.clamp(hi - lo + 1, min=1)[:, None]
        i = torch.arange(n, device=data.device)[None, :]
        start = lo[:, None] + (i * extent) // n
        end = torch.maximum(lo[:, None] + ((i + 1) * extent + n - 1) // n,
                            start + 1)
        pos = torch.arange(size, device=data.device)
        return (pos >= start[..., None]) & (pos < end[..., None])

    ymask, xmask = bins(y1, y2, ph, H), bins(x1, x2, pw, W)
    out = img.new_empty(img.shape[:2] + (ph, pw))
    for i in range(ph):
        for j in range(pw):
            m = ymask[:, i, :, None] & xmask[:, j, None, :]   # [R, H, W]
            out[:, :, i, j] = torch.where(m[:, None], img,
                                          float("-inf")).amax(dim=(2, 3))
    return out


def im2col(data, kernel, stride, dilate, pad):
    """Patches of ``[N, C, *spatial]`` data as ``[N, C·prod(kernel), L]``
    columns, channel-major then kernel position (the order of
    ``lax.conv_general_dilated_patches``), over the ``L`` output
    positions."""
    nd = len(kernel)
    x = F.pad(data, [p for p in reversed(pad) for _ in range(2)])
    for d in range(nd):
        span = dilate[d] * (kernel[d] - 1) + 1
        x = x.unfold(2 + d, span, stride[d])[..., ::dilate[d]]
    n, c = x.shape[:2]
    outs = x.shape[2:2 + nd]
    x = x.permute(0, 1, *range(2 + nd, 2 + 2 * nd), *range(2, 2 + nd))
    return x.reshape(n, c * math.prod(kernel), math.prod(outs))


@register("im2col", nin=1)
def _im2col_op(data, kernel=(), stride=(), dilate=(), pad=()):
    nd = len(kernel)
    return im2col(data, _ints(kernel, nd, 1), _ints(stride, nd, 1),
                  _ints(dilate, nd, 1), _ints(pad, nd, 0))


# ---------------------------------------------------------------------------
# the fused RNN op (mxnet_tpu/ops/nn.py:596-702): LSTM, GRU, rnn_tanh and
# rnn_relu, multi-layer, bidirectional, over one flat parameter vector
# ---------------------------------------------------------------------------
_RNN_GATES = {"lstm": 4, "gru": 3, "rnn_tanh": 1, "rnn_relu": 1}
_CUDNN_RNN_MODE = {"rnn_relu": 0, "rnn_tanh": 1, "lstm": 2, "gru": 3}


def rnn_param_shapes(mode, input_size, state_size, num_layers, dirs):
    """The shapes in the flat vector, in its order: per layer, per
    direction, ``wx [g·H, in]``, ``wh [g·H, H]``, ``bx [g·H]``, ``bh
    [g·H]`` (g gates: 4 LSTM i f g o, 3 GRU r z n, 1 vanilla)."""
    gh = _RNN_GATES[mode] * state_size
    shapes = []
    for layer in range(num_layers):
        ins = input_size if layer == 0 else state_size * dirs
        shapes += [(gh, ins), (gh, state_size), (gh,), (gh,)] * dirs
    return shapes


def _rnn_one_way(mode, x, h, c, buf, weights, keep_graph):
    """One layer in one direction over ``x`` ([T, N, I]) from ``h`` (and
    ``c``) [1, N, H]: ``(y, h_T, c_T)``.  On the card one cuDNN call
    takes ``buf``, the direction's ``[wx, wh, bx, bh]`` slice of the flat
    vector, as its weight space (that order is cuDNN's for one layer and
    one direction), so no weight is copied; ``weights``, views of the
    same slice, carry the gradient.  On the CPU torch's RNN kernels run."""
    if x.is_cuda:
        y, hy, cy, _, _ = torch._cudnn_rnn(
            x, weights, 4, buf.detach(), h, c, _CUDNN_RNN_MODE[mode],
            h.shape[-1], 0, 1, False, 0.0, keep_graph, False, [], None)
        return y, hy, cy
    if mode == "lstm":
        return torch._VF.lstm(x, (h, c), weights, True, 1, 0.0, keep_graph,
                              False, False)
    y, hy = getattr(torch._VF, mode)(x, h, weights, True, 1, 0.0,
                                     keep_graph, False, False)
    return y, hy, None


def rnn(data, params, h0, c0=None, state_size=0, num_layers=1, mode="lstm",
        bidirectional=False, p=0.0, training=True, generator=None):
    """The fused RNN: ``(out [T, N, D·H], h [L·D, N, H])``, and ``c`` for
    LSTM, from time-major ``data`` ([T, N, I]), the flat ``params``
    (:func:`rnn_param_shapes`) and the initial states ``h0`` (``c0``)
    ``[L·D, N, H]``.  Each layer and direction is one call; the reverse
    direction runs on the time-reversed sequence.  In training, ``p``
    drops each layer's output but the last's, with masks from
    ``generator`` (the device's ``mx.random`` stream for the registry
    op), so a CUDA graph that registers the stream draws fresh masks on
    every replay."""
    dirs = 2 if bidirectional else 1
    steps, batch, width = data.shape
    H, L = int(state_size), int(num_layers)
    if data.device.type == "meta":
        outs = [data.new_empty((steps, batch, dirs * H)),
                data.new_empty((L * dirs, batch, H))]
        return tuple(outs + [outs[1].clone()] * (mode == "lstm"))
    shapes = rnn_param_shapes(mode, width, H, L, dirs)
    sizes = [math.prod(s) for s in shapes]
    rest = params.numel() - sum(sizes)
    if rest < 0:
        raise MXNetError(f"RNN: {params.numel()} parameters for a "
                         f"{mode} of {sum(sizes)}")
    pieces = params.split(sizes + [rest] * (rest > 0))
    weights = [w.view(s) for w, s in zip(pieces, shapes)]
    keep_graph = torch.is_grad_enabled()
    xs, hs, cs, off = data, [], [], 0
    for layer in range(L):
        ys = []
        for d in range(dirs):
            k = layer * dirs + d
            n = sum(sizes[4 * k:4 * k + 4])
            x = torch.flip(xs, (0,)) if d else xs
            y, hT, cT = _rnn_one_way(
                mode, x, h0[k:k + 1], None if c0 is None else c0[k:k + 1],
                params[off:off + n], weights[4 * k:4 * k + 4], keep_graph)
            off += n
            ys.append(torch.flip(y, (0,)) if d else y)
            hs.append(hT)
            cs.append(cT)
        xs = ys[0] if dirs == 1 else torch.cat(ys, dim=-1)
        if p > 0.0 and training and layer < L - 1:
            xs = dropout(xs, p, True, generator)
    outs = (xs, torch.cat(hs))
    return outs + (torch.cat(cs),) if mode == "lstm" else outs


@register("RNN", nin=None, nout=-1)
def _rnn_op(args, state_size=0, num_layers=1, mode="lstm",
            bidirectional=False, p=0.0, state_outputs=True,
            projection_size=None, use_sequence_length=False,
            lstm_state_clip_min=None, lstm_state_clip_max=None,
            lstm_state_clip_nan=False, generator=None, _training=True):
    """``args = [data, params, state, (state_cell)]``; see :func:`rnn`.
    ``projection_size`` and the ``lstm_state_clip_*`` params are accepted
    and ignored, as in the JAX package."""
    data, params, h0 = args[:3]
    c0 = args[3] if mode == "lstm" and len(args) > 3 else None
    return rnn(data, params, h0, c0, int(state_size), int(num_layers), mode,
               attr_truthy(bidirectional), float(p), _training, generator)
