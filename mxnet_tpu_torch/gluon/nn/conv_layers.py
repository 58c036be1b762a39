"""Convolution and pooling layers of the training slice: ``Conv2D``,
``MaxPool2D`` and ``GlobalAvgPool2D`` (counterparts of
``mxnet_tpu/gluon/nn/conv_layers.py``), NCHW.

The port has no deferred initialisation: ``Conv2D`` takes ``in_channels``.
"""
from __future__ import annotations

import torch
from torch import nn

from ...base import MXNetError
from ...context import resolve_device
from ...initializer import Zero
from ...ops import nn as F

__all__ = ["Conv2D", "MaxPool2D", "GlobalAvgPool2D"]


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class Conv2D(nn.Module):
    """2-D convolution, weight ``[channels, in_channels, kh, kw]``, bias on
    by default.  The weight draws from the default ``Uniform(0.07)``, the
    bias starts at zero.  Dilation and groups wait for a slice that needs
    them."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 use_bias=True, in_channels=0, device=None):
        super().__init__()
        if in_channels <= 0:
            raise MXNetError("Conv2D: the port has no deferred init; pass "
                             "in_channels")
        dev = resolve_device(device)
        self._kwargs = dict(stride=_pair(strides), pad=_pair(padding))
        self.weight = nn.Parameter(torch.empty(
            (channels, in_channels) + _pair(kernel_size), device=dev))
        self.bias = (nn.Parameter(torch.zeros(channels, device=dev))
                     if use_bias else None)
        self.initializers = {"weight": None, "bias": Zero()}

    def forward(self, x):
        return F.convolution(x, self.weight, self.bias, **self._kwargs)


class MaxPool2D(nn.Module):
    """Max pooling, the 'valid' convention; ``strides`` defaults to the
    pool size."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0):
        super().__init__()
        self._kwargs = dict(kernel=_pair(pool_size),
                            stride=None if strides is None else _pair(strides),
                            pad=_pair(padding))

    def forward(self, x):
        return F.pooling(x, pool_type="max", **self._kwargs)


class GlobalAvgPool2D(nn.Module):
    """Mean over H and W: ``[B, C, H, W]`` -> ``[B, C, 1, 1]``."""

    def forward(self, x):
        return F.pooling(x, pool_type="avg", global_pool=True)
