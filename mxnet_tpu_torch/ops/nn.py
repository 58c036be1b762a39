"""Neural-network operators of the training slices, as plain functions on
tensors.

Counterparts of the ops in ``mxnet_tpu/ops/nn.py`` and
``mxnet_tpu/ops/matrix.py`` that the ResNet-50 v1 and BERT steps run:
BatchNorm (with the one-pass or centred variance), LayerNorm,
Convolution, Pooling, FullyConnected, Embedding, Dropout, the relu, tanh
and gelu activations, ``log_softmax`` and ``pick``.  Layouts are the JAX
package's: NCHW activations, ``[out, in, kh, kw]`` conv weights and
``[units, in_units]`` dense weights.  The JAX package leaves its
convolutions and matrix products to XLA, so here they go to
``torch.nn.functional``.  Where jnp promotes mixed dtypes (an fp32
activation against a bf16 weight under amp) these ops promote too.

The second half registers them as registry ops under the JAX package's
names and params (``FullyConnected``, ``Convolution``, ``Pooling``,
``Activation``, ``BatchNorm``, ``LayerNorm``, ``Embedding``, ``Dropout``,
``softmax``, ``log_softmax``, ``SoftmaxOutput`` and their aliases), so
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

__all__ = ["batch_norm", "layer_norm", "convolution", "pooling",
           "fully_connected", "embedding", "dropout", "activation", "relu",
           "softmax", "log_softmax", "pick"]


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


def convolution(data, weight, bias=None, stride=(1, 1), pad=(0, 0),
                dilate=(1, 1), num_group=1):
    """2-D convolution, NCHW data and ``[out, in / num_group, kh, kw]``
    weight."""
    return F.conv2d(data, weight, bias, tuple(stride), tuple(pad),
                    tuple(dilate), num_group)


def pooling(data, kernel=(1, 1), pool_type="max", global_pool=False,
            stride=None, pad=(0, 0), ceil_mode=False, count_include_pad=True):
    """NCHW max or average pooling over ``kernel`` windows, ``stride``
    defaulting to ``kernel``; the 'valid' convention, or with
    ``ceil_mode`` the 'full' one, whose last window the JAX package pads
    on the high edge (max pads with -inf, average with zeros that
    ``count_include_pad`` counts).  ``global_pool`` reduces all of H, W."""
    if pool_type not in ("max", "avg"):
        raise MXNetError(f"pooling: {pool_type} pooling is not ported")
    if global_pool:
        if pool_type == "avg":
            return data.mean(dim=(2, 3), keepdim=True)
        return data.amax(dim=(2, 3), keepdim=True)
    kernel = tuple(kernel)
    stride = tuple(stride) if stride else kernel
    pad = tuple(pad)
    if ceil_mode:
        hi = []
        for i in range(2):
            size = data.shape[2 + i] + 2 * pad[i]
            out = -(-(size - kernel[i]) // stride[i]) + 1
            hi.append(pad[i] + max((out - 1) * stride[i] + kernel[i] - size,
                                   0))
        edges = (pad[1], hi[1], pad[0], hi[0])
        fill = float("-inf") if pool_type == "max" else 0.0
        padded = F.pad(data, edges, value=fill)
        if pool_type == "max":
            return F.max_pool2d(padded, kernel, stride)
        total = F.avg_pool2d(padded, kernel, stride)
        if count_include_pad:
            return total
        ones = F.pad(torch.ones_like(data[:1, :1]), edges)
        return total / F.avg_pool2d(ones, kernel, stride)
    if pool_type == "max":
        return F.max_pool2d(data, kernel, stride, pad)
    return F.avg_pool2d(data, kernel, stride, pad,
                        count_include_pad=count_include_pad)


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
    if len(kernel) != 2:
        raise MXNetError(f"Convolution: {len(kernel)}-D kernels are not "
                         "ported; 2-D (NCHW) is")
    return convolution(data, weight, bias, _ints(stride, 2, 1),
                       _ints(pad, 2, 0), _ints(dilate, 2, 1), int(num_group))


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
                   count_include_pad=attr_truthy(count_include_pad))


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
_get_op("BatchNorm").infer_shapes = _norm_infer_axis(1)
_get_op("LayerNorm").infer_shapes = _norm_infer_axis(-1)
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
