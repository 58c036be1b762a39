"""Contrib layers (counterparts of ``mxnet_tpu/gluon/contrib/nn.py``):
``Concurrent`` and ``HybridConcurrent`` (one input to every child, the
outputs concatenated along ``axis``), ``Identity``, ``SyncBatchNorm``
(``gluon.nn.SyncBatchNorm``), ``PixelShuffle1D/2D/3D`` and
``FusedConv1x1BN`` and ``MoEFFN``.  ``SparseEmbedding`` waits for
row-sparse data (ROADMAP A15).

``MoEFFN`` is the Mixture-of-Experts FFN over the registry's ``_moe_ffn``
(``ops/moe.py``): a replicated ``router_weight`` ``(units, E)`` and the
stacked experts ``expert_w1`` ``(E, units, hidden)`` and ``expert_w2``
``(E, hidden, units)``, which shard over a mesh's ``ep`` axis; its
forward returns ``(y, aux_loss)``.

``FusedConv1x1BN`` is a 1x1 convolution + BatchNorm (+ ReLU) through the
CUDA matmul-with-statistics kernel, a
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

import math

import torch

from ... import autograd
from ...base import env
from ...ops import F as _ops
from ..block import HybridBlock
from ..nn.basic_layers import (HybridSequential, Sequential, SyncBatchNorm,
                               _update_running, cast_keeping_norm_fp32)

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SyncBatchNorm",
           "PixelShuffle1D", "PixelShuffle2D", "PixelShuffle3D",
           "FusedConv1x1BN", "MoEFFN"]


def _concat(outs, axis):
    """Concatenate tensors, or compose ``concat`` over Symbols."""
    if isinstance(outs[0], torch.Tensor):
        return torch.cat(outs, dim=axis)
    from ... import symbol
    return symbol.concat(*outs, dim=axis)


class Concurrent(Sequential):
    """Every child on the same input, the outputs concatenated along
    ``axis``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x, *args):
        return _concat([block(x) for block in self._modules.values()],
                       self.axis)


class HybridConcurrent(HybridSequential):
    """:class:`Concurrent` with a symbolic form (``concat`` over the
    children's)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x, *args):
        return _concat([block(x) for block in self._modules.values()],
                       self.axis)


class Identity(HybridBlock):
    """Its input, unchanged (a branch of a ``Concurrent``)."""

    def forward(self, x):
        return x

    def hybrid_forward(self, F, x):
        return x


class _PixelShuffle(HybridBlock):
    """Channel blocks of ``factor`` per spatial dim moved into the spatial
    dims: ``[N, C·f₁…fₙ, s₁…sₙ]`` -> ``[N, C, s₁f₁…sₙfₙ]``."""

    _ndim = 2

    def __init__(self, factor, **kwargs):
        super().__init__(**kwargs)
        self._factor = ((factor,) * self._ndim if isinstance(factor, int)
                        else tuple(factor))

    def forward(self, x):
        nd, f = self._ndim, self._factor
        n, c = x.shape[:2]
        spatial = tuple(x.shape[2:])
        cc = c // math.prod(f)
        out = x.reshape((n, cc) + f + spatial)
        # [N, C, f1..fn, s1..sn] -> [N, C, s1, f1, ..., sn, fn]
        order = [0, 1] + [i for d in range(nd) for i in (2 + nd + d, 2 + d)]
        out = out.permute(order)
        return out.reshape((n, cc) + tuple(s * k for s, k in zip(spatial, f)))


class PixelShuffle1D(_PixelShuffle):
    """``[N, C·f, W]`` -> ``[N, C, W·f]``."""

    _ndim = 1


class PixelShuffle2D(_PixelShuffle):
    """``[N, C·fh·fw, H, W]`` -> ``[N, C, H·fh, W·fw]``."""

    _ndim = 2


class PixelShuffle3D(_PixelShuffle):
    """``[N, C·fd·fh·fw, D, H, W]`` -> ``[N, C, D·fd, H·fh, W·fw]``."""

    _ndim = 3


class MoEFFN(HybridBlock):
    """Mixture-of-Experts FFN with top-k routing; ``forward(x) -> (y,
    aux_loss)``, ``aux_loss`` the Switch load-balance term (add
    ``aux_weight * aux_loss`` to the loss).  A token past an expert's
    capacity (``ceil(T / E * capacity_factor)``) is dropped from it.
    ``mesh`` (default: the one entered when it runs) shards the experts
    over its ``ep`` axis."""

    def __init__(self, units, hidden, num_experts, top_k=2,
                 capacity_factor=1.25, weight_initializer=None, mesh=None,
                 dtype="float32", device=None, **kwargs):
        super().__init__(device=device, **kwargs)
        if top_k > num_experts:
            raise ValueError(f"top_k={top_k} exceeds num_experts="
                             f"{num_experts}")
        self._kwargs = {"top_k": int(top_k),
                        "capacity_factor": float(capacity_factor),
                        "num_experts": int(num_experts)}
        self._mesh = mesh
        with self.name_scope():
            # "router", not "gate": the sharding rules column-shard
            # gate_weight (gated FFNs), and the router stays replicated
            self.router_weight = self.params.get(
                "router_weight", shape=(units, num_experts), dtype=dtype,
                init=weight_initializer)
            self.expert_w1 = self.params.get(
                "expert_w1", shape=(num_experts, units, hidden), dtype=dtype,
                init=weight_initializer)
            self.expert_w2 = self.params.get(
                "expert_w2", shape=(num_experts, hidden, units), dtype=dtype,
                init=weight_initializer)

    def forward(self, x):
        return _ops._moe_ffn(x, self.router_weight, self.expert_w1,
                             self.expert_w2, mesh=self._mesh, **self._kwargs)

    def hybrid_forward(self, F, x, router_weight=None, expert_w1=None,
                       expert_w2=None):
        return F._moe_ffn(x, router_weight, expert_w1, expert_w2,
                          **self._kwargs)


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
            y, s1, s2 = _ops.conv1x1_bn_stats_op(nhwc, self.weight,
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
            y, _, _ = _ops.conv1x1_bn_stats_op(
                nhwc, wf, stride=self._strides, with_stats=False)
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
