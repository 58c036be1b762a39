"""Convolution and pooling layers (counterparts of
``mxnet_tpu/gluon/nn/conv_layers.py``): ``Conv1D/2D/3D``, their
transposes ``Conv1DTranspose/2D/3D``, ``MaxPool1D/2D/3D``,
``AvgPool1D/2D/3D``, ``GlobalMaxPool1D/2D/3D``, ``GlobalAvgPool1D/2D/3D``
and ``ReflectionPad2D``, channels first (``NCW``, ``NCHW``, ``NCDHW``).

A convolution with ``in_channels=0`` infers its input width at the first
forward (deferred init).  Each layer's ``forward`` computes on tensors;
its ``hybrid_forward`` is the JAX layer's (``Convolution``,
``Deconvolution``, ``Pooling`` or ``pad`` with the JAX layer's params),
the symbolic form that ``export`` traces.
"""
from __future__ import annotations

from ...base import MXNetError
from ...ops import F
from ..block import HybridBlock

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]

_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}


def _tuple(v, n):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


def _channels_first(layout, nd):
    if layout != _LAYOUTS[nd]:
        raise MXNetError(f"layout {layout!r} is not ported; "
                         f"{_LAYOUTS[nd]} is")


class _Conv(HybridBlock):
    """A convolution (``Convolution``) or a transposed one
    (``Deconvolution``, weight ``[in_channels, channels / groups,
    *kernel]``, ``adj`` its output padding), bias on by default, then the
    ``activation`` when one is named.  The weight draws from the
    initializer given to ``initialize`` (default ``Uniform(0.07)``), the
    bias starts at zero."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 device=None, **kwargs):
        super().__init__(device=device, **kwargs)
        nd = len(kernel_size)
        _channels_first(layout, nd)
        self._channels = channels
        self._kernel = tuple(kernel_size)
        self._groups = groups
        self._op_name = op_name
        self._act_type = activation
        self._kwargs = dict(stride=tuple(strides), pad=tuple(padding),
                            dilate=tuple(dilation), num_group=groups)
        self._sym_kwargs = {
            "kernel": self._kernel, "stride": tuple(strides),
            "dilate": tuple(dilation), "pad": tuple(padding),
            "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias}
        if adj is not None:
            self._kwargs["adj"] = self._sym_kwargs["adj"] = tuple(adj)
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=self._weight_shape(in_channels),
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get("bias", shape=(channels,),
                                            init=bias_initializer,
                                            allow_deferred_init=True)
            else:
                self.bias = None

    def _weight_shape(self, in_channels):
        if self._op_name == "Convolution":
            return (self._channels, in_channels // self._groups
                    if in_channels else 0) + self._kernel
        return (in_channels, self._channels // self._groups) + self._kernel

    def _shape_hint(self, x, *args):
        self._reg_params["weight"].shape = self._weight_shape(x.shape[1])

    def forward(self, x):
        op = F.convolution if self._op_name == "Convolution" \
            else F.deconvolution
        out = op(x, self.weight, self.bias, **self._kwargs)
        return F.activation(out, self._act_type) if self._act_type else out

    def hybrid_forward(self, F, x, weight=None, bias=None):
        op = getattr(F, self._op_name)
        if bias is None:
            out = op(x, weight, **self._sym_kwargs)
        else:
            out = op(x, weight, bias, **self._sym_kwargs)
        if self._act_type:
            out = F.Activation(out, act_type=self._act_type)
        return out

    def extra_repr(self):
        return (f"{self._channels}, kernel_size={self._kernel}, "
                f"stride={self._kwargs['stride']}")


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 1), _tuple(strides, 1),
                         _tuple(padding, 1), _tuple(dilation, 1), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 2), _tuple(strides, 2),
                         _tuple(padding, 2), _tuple(dilation, 2), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 3), _tuple(strides, 3),
                         _tuple(padding, 3), _tuple(dilation, 3), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 1), _tuple(strides, 1),
                         _tuple(padding, 1), _tuple(dilation, 1), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_tuple(output_padding, 1), **kwargs)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 2), _tuple(strides, 2),
                         _tuple(padding, 2), _tuple(dilation, 2), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_tuple(output_padding, 2), **kwargs)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 3), _tuple(strides, 3),
                         _tuple(padding, 3), _tuple(dilation, 3), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_tuple(output_padding, 3), **kwargs)


class _Pooling(HybridBlock):
    """Pooling over ``pool_size`` windows, ``strides`` defaulting to the
    pool size; the 'valid' convention, or with ``ceil_mode`` the 'full'
    one; ``count_include_pad`` counts the padding in an average's
    divisor."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        _channels_first(layout, len(pool_size))
        strides = pool_size if strides is None else strides
        self._kwargs = dict(kernel=pool_size, stride=strides, pad=padding,
                            global_pool=global_pool, pool_type=pool_type,
                            ceil_mode=ceil_mode,
                            count_include_pad=count_include_pad is not False)
        self._sym_kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
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


def _window(nd, pool_size, strides, padding):
    return (_tuple(pool_size, nd),
            None if strides is None else _tuple(strides, nd),
            _tuple(padding, nd))


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(*_window(1, pool_size, strides, padding), ceil_mode,
                         False, "max", layout, **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(*_window(2, pool_size, strides, padding), ceil_mode,
                         False, "max", layout, **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(*_window(3, pool_size, strides, padding), ceil_mode,
                         False, "max", layout, **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(*_window(1, pool_size, strides, padding), ceil_mode,
                         False, "avg", layout, count_include_pad, **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(*_window(2, pool_size, strides, padding), ceil_mode,
                         False, "avg", layout, count_include_pad, **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(*_window(3, pool_size, strides, padding), ceil_mode,
                         False, "avg", layout, count_include_pad, **kwargs)


class _GlobalPool(_Pooling):
    """Reduce every spatial dim to 1."""

    _nd, _type = 2, "avg"

    def __init__(self, layout=None, **kwargs):
        nd = self._nd
        super().__init__((1,) * nd, None, (0,) * nd, False, True, self._type,
                         layout or _LAYOUTS[nd], **kwargs)


class GlobalMaxPool1D(_GlobalPool):
    _nd, _type = 1, "max"


class GlobalMaxPool2D(_GlobalPool):
    _nd, _type = 2, "max"


class GlobalMaxPool3D(_GlobalPool):
    _nd, _type = 3, "max"


class GlobalAvgPool1D(_GlobalPool):
    _nd, _type = 1, "avg"


class GlobalAvgPool2D(_GlobalPool):
    """Mean over H and W: ``[B, C, H, W]`` -> ``[B, C, 1, 1]``."""

    _nd, _type = 2, "avg"


class GlobalAvgPool3D(_GlobalPool):
    _nd, _type = 3, "avg"


class ReflectionPad2D(HybridBlock):
    """Mirror ``padding`` rows and columns about the edges of NCHW data
    (an int pads all four sides; else the flat 8-tuple of ``pad``)."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = tuple(padding)

    def forward(self, x):
        return F.pad(x, mode="reflect", pad_width=self._padding)

    def hybrid_forward(self, F, x):
        return F.pad(x, mode="reflect", pad_width=self._padding)
