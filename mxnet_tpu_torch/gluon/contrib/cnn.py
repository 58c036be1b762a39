"""gluon.contrib.cnn (counterpart of ``mxnet_tpu/gluon/contrib/cnn.py``,
reference ``python/mxnet/gluon/contrib/cnn/conv_layers.py``): deformable
convolution blocks, each an offset-predicting convolution feeding the
deformable convolution op (``ops/deformable.py``).  Their one
``hybrid_forward`` serves NDArray, tensor and Symbol calls."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["DeformableConvolution", "ModulatedDeformableConvolution"]


def _pair(x):
    return (x, x) if isinstance(x, int) else tuple(x)


class DeformableConvolution(HybridBlock):
    """Deformable convolution v1: a convolution predicts each output
    location's ``(dy, dx)`` offsets (zero-initialised, so the layer starts
    as a plain convolution), which bend the sampling grid of the main one
    (``_contrib_DeformableConvolution``).  Parameter names and shapes are
    the JAX layer's."""

    _mask_factor = 0  # v1: offsets only

    def __init__(self, channels, kernel_size=(3, 3), strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1,
                 num_deformable_group=1, use_bias=True, in_channels=0,
                 activation=None, weight_initializer=None,
                 bias_initializer="zeros",
                 offset_weight_initializer="zeros",
                 offset_bias_initializer="zeros", offset_use_bias=True,
                 **kwargs):
        super().__init__(**kwargs)
        k = _pair(kernel_size)
        self._kwargs = {"kernel": k, "stride": _pair(strides),
                        "pad": _pair(padding), "dilate": _pair(dilation),
                        "num_filter": channels, "num_group": groups,
                        "num_deformable_group": num_deformable_group,
                        "no_bias": not use_bias}
        off_ch = (2 + self._mask_factor) * num_deformable_group * k[0] * k[1]
        self._off_ch = off_ch
        self._act = activation
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(channels, in_channels // groups
                                 if in_channels else 0) + k,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get("bias", shape=(channels,),
                                            init=bias_initializer,
                                            allow_deferred_init=True)
            self.offset_weight = self.params.get(
                "offset_weight", shape=(off_ch, in_channels
                                        if in_channels else 0) + k,
                init=offset_weight_initializer, allow_deferred_init=True)
            if offset_use_bias:
                self.offset_bias = self.params.get(
                    "offset_bias", shape=(off_ch,),
                    init=offset_bias_initializer, allow_deferred_init=True)

    def _shape_hint(self, x, *args):
        c = x.shape[1]
        k = tuple(self._kwargs["kernel"])
        self._reg_params["weight"].shape = (
            self._kwargs["num_filter"], c // self._kwargs["num_group"]) + k
        self._reg_params["offset_weight"].shape = (self._off_ch, c) + k

    def _op(self, F, x, offset_out, weight, bias):
        args = [x, offset_out, weight] + ([bias] if bias is not None else [])
        return F._contrib_DeformableConvolution(*args, **self._kwargs)

    def hybrid_forward(self, F, x, weight=None, bias=None, offset_weight=None,
                       offset_bias=None):
        off = F.Convolution(
            x, offset_weight, *([offset_bias] if offset_bias is not None
                                else []),
            kernel=self._kwargs["kernel"], stride=self._kwargs["stride"],
            pad=self._kwargs["pad"], dilate=self._kwargs["dilate"],
            num_filter=self._off_ch, no_bias=offset_bias is None)
        out = self._op(F, x, off, weight, bias)
        if self._act:
            out = F.Activation(out, act_type=self._act)
        return out


class ModulatedDeformableConvolution(DeformableConvolution):
    """Deformable convolution v2: the offset convolution also predicts a
    modulation mask per sample point, through a sigmoid
    (``_contrib_ModulatedDeformableConvolution``)."""

    _mask_factor = 1

    def _op(self, F, x, offset_out, weight, bias):
        k = self._kwargs["kernel"]
        n_off = 2 * self._kwargs["num_deformable_group"] * k[0] * k[1]
        offsets = F.slice_axis(offset_out, axis=1, begin=0, end=n_off)
        mask = F.sigmoid(F.slice_axis(offset_out, axis=1, begin=n_off,
                                      end=None))
        args = [x, offsets, mask, weight] + ([bias] if bias is not None
                                             else [])
        return F._contrib_ModulatedDeformableConvolution(*args,
                                                         **self._kwargs)
