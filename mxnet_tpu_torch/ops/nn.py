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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError, env

__all__ = ["batch_norm", "layer_norm", "convolution", "pooling",
           "fully_connected", "embedding", "dropout", "activation", "relu",
           "log_softmax", "pick"]


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
    x32 = data.float()
    ax = axis % data.dim()
    mean, var = _moments_of(x32, (ax,), keepdim=True)
    bshape = [1] * data.dim()
    bshape[ax] = data.shape[ax]
    return (((x32 - mean) * torch.rsqrt(var + eps)).to(data.dtype)
            * gamma.reshape(bshape) + beta.reshape(bshape))


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
    is a dense scatter-add into ``weight``'s shape."""
    return F.embedding(data.long(), weight)


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


_ACTIVATIONS = {"relu": relu, "tanh": torch.tanh,
                # jax.nn.gelu(approximate=False): the exact erf form
                "gelu": F.gelu}


def activation(data, act_type="relu"):
    """The ``Activation`` op: ``relu``, ``tanh`` or the exact ``gelu``."""
    if act_type not in _ACTIVATIONS:
        raise MXNetError(f"activation {act_type!r} is not ported")
    return _ACTIVATIONS[act_type](data)


def log_softmax(data, axis=-1):
    return torch.log_softmax(data, dim=axis)


def pick(data, index, axis=-1, keepdims=False):
    """``data`` at ``index`` along ``axis``; indices arrive as floats or
    ints and are clipped into range (the JAX package's default mode)."""
    idx = index.long().clamp(0, data.shape[axis] - 1)
    picked = torch.gather(data, axis, idx.unsqueeze(axis))
    return picked if keepdims else picked.squeeze(axis)
