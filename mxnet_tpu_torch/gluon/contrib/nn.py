"""``FusedConv1x1BN``: a 1x1 convolution + BatchNorm (+ ReLU) through the
CUDA matmul-with-statistics kernel.

Counterpart of ``mxnet_tpu/gluon/contrib/nn.py:FusedConv1x1BN``, a
:class:`~mxnet_tpu_torch.gluon.block.HybridBlock` with the reference's
parameters (``weight`` Xavier, ``gamma``, ``beta``, and the moving
statistics with ``grad_req='null'``) and a deferred input width
(``in_channels=0``).  In training one pass of the kernel
(``ops/fused_conv_bn.py``) computes the conv output and the per-channel
batch statistics, so BatchNorm never rereads the output for them.  In
evaluation BN folds into the conv weight and a plain matrix product runs.
NCHW in and out, like ``Conv2D`` + ``BatchNorm``; there is no conv bias
(BN cancels it).  Training mode is the module's (under the Gluon boundary,
``mx.autograd.is_training()``).

The dtypes follow the JAX package's promotion: with a bf16 weight and
input the conv output is bf16, but the normalise subtracts the fp32 mean,
so the block returns fp32, and a following bf16 ``Conv2D`` refuses the
mixed dtypes, as in the JAX package.

``hybrid_forward`` is the JAX block's, both branches, over the registry's
``_contrib_conv1x1_bn_stats``: the symbolic form ``export`` traces, which
outside training is the folded product with ``with_stats=False``.
"""
from __future__ import annotations

import torch

from ... import autograd
from ...base import env
from ...ops.fused_conv_bn import conv1x1_bn_stats_op
from ..block import HybridBlock
from ..nn.basic_layers import _update_running, cast_keeping_norm_fp32

__all__ = ["FusedConv1x1BN"]


class FusedConv1x1BN(HybridBlock):
    def __init__(self, channels, in_channels=0, strides=1, relu=False,
                 momentum=0.9, epsilon=1e-5, device=None, **kwargs):
        super().__init__(device=device, **kwargs)
        self._channels = channels
        self._strides = strides
        self._relu = relu
        self._momentum = momentum
        self._epsilon = epsilon
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(channels, in_channels, 1, 1),
                init="xavier", allow_deferred_init=True)
            self.gamma = self.params.get("gamma", shape=(channels,),
                                         init="ones",
                                         allow_deferred_init=True)
            self.beta = self.params.get("beta", shape=(channels,),
                                        init="zeros",
                                        allow_deferred_init=True)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(channels,),
                init="zeros", allow_deferred_init=True, differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(channels,),
                init="ones", allow_deferred_init=True, differentiable=False)

    def _shape_hint(self, x, *args):
        self._reg_params["weight"].shape = (self._channels, x.shape[1], 1, 1)

    def cast(self, dtype):
        """Cast to ``dtype``; in bf16/fp16 only the conv weight narrows."""
        return cast_keeping_norm_fp32(self, dtype)

    def forward(self, x):
        nhwc = x.permute(0, 2, 3, 1)
        if self.training:
            y, s1, s2 = conv1x1_bn_stats_op(nhwc, self.weight,
                                            stride=self._strides)
            n, h, w, _ = y.shape
            m_rows = n * h * w
            mean = s1 / m_rows
            if env.MXNET_TPU_FAST_VARIANCE:
                # one pass: E[y^2] - mean^2, clamped so rsqrt cannot NaN
                var = torch.maximum(s2 / m_rows - mean * mean,
                                    mean.new_zeros(()))
            else:
                # centred second pass over y; the kernel's sum still
                # saved the mean pass
                var = ((y - mean.reshape(1, 1, 1, -1)) ** 2).mean(
                    dim=(0, 1, 2))
            inv = (var + self._epsilon) ** -0.5
            out = ((y - mean.reshape(1, 1, 1, -1))
                   * (inv * self.gamma).reshape(1, 1, 1, -1)
                   + self.beta.reshape(1, 1, 1, -1))
            _update_running(self, mean, var)
        else:
            # deploy-time fold: w' = w·gamma·inv, the normalise collapses
            # into an output shift, and no statistics are taken
            inv = (self.running_var + self._epsilon) ** -0.5
            scale = self.gamma * inv
            wf = self.weight * scale.reshape(-1, 1, 1, 1)
            y, _, _ = conv1x1_bn_stats_op(nhwc, wf, stride=self._strides,
                                          with_stats=False)
            out = y + (self.beta - self.running_mean * scale).reshape(
                1, 1, 1, -1)
        if self._relu:
            out = torch.relu(out)
        return out.permute(0, 3, 1, 2)

    def hybrid_forward(self, F, x, weight=None, gamma=None, beta=None,
                       running_mean=None, running_var=None):
        if autograd.is_training():
            y, s1, s2 = F._contrib_conv1x1_bn_stats(
                x.transpose(axes=(0, 2, 3, 1)), weight, stride=self._strides)
            n, h, w, _ = y.shape
            m_rows = n * h * w
            mean = s1 / m_rows
            if env.MXNET_TPU_FAST_VARIANCE:
                var = F.maximum(s2 / m_rows - mean * mean, 0.0)
            else:
                var = F.mean((y - mean.reshape(1, 1, 1, -1)) ** 2,
                             axis=(0, 1, 2))
            inv = (var + self._epsilon) ** -0.5
            out = (y - mean.reshape(1, 1, 1, -1)) * (inv * gamma).reshape(
                1, 1, 1, -1) + beta.reshape(1, 1, 1, -1)
            mom = self._momentum
            running_mean._set_data(mom * running_mean._data
                                   + (1 - mom) * mean._data)
            running_var._set_data(mom * running_var._data
                                  + (1 - mom) * var._data)
        else:
            inv = (running_var + self._epsilon) ** -0.5
            scale = gamma * inv
            wf = weight * scale.reshape(-1, 1, 1, 1)
            y, _, _ = F._contrib_conv1x1_bn_stats(
                x.transpose(axes=(0, 2, 3, 1)), wf, stride=self._strides,
                with_stats=False)
            out = y + (beta - running_mean * scale).reshape(1, 1, 1, -1)
        if self._relu:
            out = F.relu(out)
        return out.transpose(axes=(0, 3, 1, 2))

    def extra_repr(self):
        return (f"{self._channels}, strides={self._strides}, "
                f"relu={self._relu}")
