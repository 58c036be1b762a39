"""Neural-network operators of the training slice, as plain functions on
tensors.

Counterparts of the ops in ``mxnet_tpu/ops/nn.py`` and
``mxnet_tpu/ops/matrix.py`` that the ResNet-50 v1 step runs: BatchNorm
(with the one-pass or centred variance), Convolution, Pooling,
FullyConnected, the ReLU activation, ``log_softmax`` and ``pick``.  Layouts
are the JAX package's: NCHW activations, ``[out, in, kh, kw]`` conv
weights and ``[units, in_units]`` dense weights.  The JAX package leaves
its convolutions and matrix products to XLA, so here they go to
``torch.nn.functional``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError, env

__all__ = ["batch_norm", "convolution", "pooling", "fully_connected",
           "activation", "relu", "log_softmax", "pick"]


def _moments_of(x32, red):
    """Mean and biased variance of ``x32`` over the dims ``red``: one pass,
    ``max(E[x^2] - E[x]^2, 0)``, under ``MXNET_TPU_FAST_VARIANCE=1`` (the
    default), else the centred ``E[(x - mean)^2]``."""
    mean = x32.mean(dim=red)
    if env.MXNET_TPU_FAST_VARIANCE:
        mean2 = x32.square().mean(dim=red)
        var = torch.maximum(mean2 - mean.square(), mean.new_zeros(()))
    else:
        mk = mean.reshape([1 if i in red else n
                           for i, n in enumerate(x32.shape)])
        var = (x32 - mk).square().mean(dim=red)
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


def convolution(data, weight, bias=None, stride=(1, 1), pad=(0, 0)):
    """2-D convolution, NCHW data and ``[out, in, kh, kw]`` weight."""
    return F.conv2d(data, weight, bias, tuple(stride), tuple(pad))


def pooling(data, kernel=(1, 1), pool_type="max", global_pool=False,
            stride=None, pad=(0, 0)):
    """NCHW pooling: max over ``kernel`` windows (the 'valid' convention,
    ``stride`` defaulting to ``kernel``), or the global average.  The
    slice ports these two."""
    if global_pool and pool_type == "avg":
        return data.mean(dim=(2, 3), keepdim=True)
    if not global_pool and pool_type == "max":
        return F.max_pool2d(data, tuple(kernel),
                            tuple(stride) if stride else tuple(kernel),
                            tuple(pad))
    raise MXNetError(f"pooling: {'global ' if global_pool else ''}"
                     f"{pool_type} pooling is not ported")


def fully_connected(data, weight, bias=None, flatten=True):
    """``data @ weight.T + bias``; ``flatten`` folds every dim after the
    first into the input units."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    return F.linear(x, weight, bias)


def relu(data):
    return torch.relu(data)


def activation(data, act_type="relu"):
    """The ``Activation`` op; the slice ports ``relu``."""
    if act_type != "relu":
        raise MXNetError(f"activation {act_type!r} is not ported")
    return relu(data)


def log_softmax(data, axis=-1):
    return torch.log_softmax(data, dim=axis)


def pick(data, index, axis=-1, keepdims=False):
    """``data`` at ``index`` along ``axis``; indices arrive as floats or
    ints and are clipped into range (the JAX package's default mode)."""
    idx = index.long().clamp(0, data.shape[axis] - 1)
    picked = torch.gather(data, axis, idx.unsqueeze(axis))
    return picked if keepdims else picked.squeeze(axis)
