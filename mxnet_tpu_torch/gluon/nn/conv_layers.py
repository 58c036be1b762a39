"""Convolution and pooling layers: ``Conv2D``, ``MaxPool2D``,
``AvgPool2D`` and ``GlobalAvgPool2D`` (counterparts of
``mxnet_tpu/gluon/nn/conv_layers.py``), NCHW.

``Conv2D`` with ``in_channels=0`` infers its input width at the first
forward (deferred init).  Each layer's ``forward`` computes on tensors;
its ``hybrid_forward`` is the JAX layer's (``Convolution`` / ``Pooling``
with the JAX layer's params), the symbolic form that ``export`` traces.
"""
from __future__ import annotations

from ...base import MXNetError
from ...ops import nn as F
from ..block import HybridBlock

__all__ = ["Conv2D", "MaxPool2D", "AvgPool2D", "GlobalAvgPool2D"]


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _nchw(layout):
    if layout != "NCHW":
        raise MXNetError(f"layout {layout!r} is not ported; NCHW is")


class Conv2D(HybridBlock):
    """2-D convolution, weight ``[channels, in_channels / groups, kh, kw]``,
    bias on by default, then the ``activation`` when one is named.  The
    weight draws from the initializer given to ``initialize`` (default
    ``Uniform(0.07)``), the bias starts at zero."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, device=None,
                 **kwargs):
        super().__init__(device=device, **kwargs)
        _nchw(layout)
        self._channels = channels
        self._kernel = _pair(kernel_size)
        self._groups = groups
        self._act_type = activation
        self._kwargs = dict(stride=_pair(strides), pad=_pair(padding),
                            dilate=_pair(dilation), num_group=groups)
        self._sym_kwargs = {
            "kernel": self._kernel, "stride": _pair(strides),
            "dilate": _pair(dilation), "pad": _pair(padding),
            "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias}
        wshape = (channels, in_channels // groups if in_channels else 0
                  ) + self._kernel
        with self.name_scope():
            self.weight = self.params.get("weight", shape=wshape,
                                          init=weight_initializer,
                                          allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get("bias", shape=(channels,),
                                            init=bias_initializer,
                                            allow_deferred_init=True)
            else:
                self.bias = None

    def _shape_hint(self, x, *args):
        self._reg_params["weight"].shape = (
            self._channels, x.shape[1] // self._groups) + self._kernel

    def forward(self, x):
        out = F.convolution(x, self.weight, self.bias, **self._kwargs)
        return F.activation(out, self._act_type) if self._act_type else out

    def hybrid_forward(self, F, x, weight=None, bias=None):
        if bias is None:
            out = F.Convolution(x, weight, **self._sym_kwargs)
        else:
            out = F.Convolution(x, weight, bias, **self._sym_kwargs)
        if self._act_type:
            out = F.Activation(out, act_type=self._act_type)
        return out

    def extra_repr(self):
        return (f"{self._channels}, kernel_size={self._kernel}, "
                f"stride={self._kwargs['stride']}")


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout="NCHW", count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        _nchw(layout)
        self._kwargs = dict(kernel=_pair(pool_size),
                            stride=None if strides is None else _pair(strides),
                            pad=_pair(padding), global_pool=global_pool,
                            pool_type=pool_type, ceil_mode=ceil_mode,
                            count_include_pad=count_include_pad is not False)
        self._sym_kwargs = {
            "kernel": _pair(pool_size),
            "stride": _pair(pool_size if strides is None else strides),
            "pad": _pair(padding), "global_pool": global_pool,
            "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if count_include_pad is not None:
            self._sym_kwargs["count_include_pad"] = count_include_pad

    def forward(self, x):
        return F.pooling(x, **self._kwargs)

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._sym_kwargs)

    def extra_repr(self):
        return (f"size={self._kwargs['kernel']}, "
                f"stride={self._kwargs['stride']}")


class MaxPool2D(_Pooling):
    """Max pooling, the 'valid' convention (``ceil_mode`` the 'full' one);
    ``strides`` defaults to the pool size."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "max", layout, **kwargs)


class AvgPool2D(_Pooling):
    """Average pooling; ``count_include_pad`` counts the padding in the
    divisor."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "avg", layout, count_include_pad, **kwargs)


class GlobalAvgPool2D(_Pooling):
    """Mean over H and W: ``[B, C, H, W]`` -> ``[B, C, 1, 1]``."""

    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), False, True, "avg", layout,
                         **kwargs)
