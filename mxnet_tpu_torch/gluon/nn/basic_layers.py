"""Basic layers of the training slices: ``HybridSequential``, ``Dense``,
``Dropout``, ``BatchNorm``, ``LayerNorm``, ``Embedding`` and ``Flatten``.

Counterparts of ``mxnet_tpu/gluon/nn/basic_layers.py``.  Gluon's
``Parameter``/``HybridBlock`` become ``nn.Parameter``/``nn.Module``, and the
moving statistics, which gluon keeps as parameters with ``grad_req='null'``,
become buffers.  Each module registers its parameters, then its buffers, in
the JAX package's order, so ``state_dict()`` walks the same tensors as
``collect_params()`` (``convert.resnet_state_dict_from_mxnet`` relies on
it).  The port has no deferred initialisation: constructors take the input
width, and :func:`~mxnet_tpu_torch.initializer.initialize` fills the
tensors from each module's ``initializers``.  ``Dropout`` draws its masks
from the ``torch.Generator`` it is given.
"""
from __future__ import annotations

import torch
from torch import nn

from ...base import MXNetError
from ...context import resolve_device
from ...initializer import One, Zero
from ...ops import nn as F

__all__ = ["HybridSequential", "Dense", "Dropout", "BatchNorm", "LayerNorm",
           "Embedding", "Flatten"]

_FP32_NORM = ("gamma", "beta", "running_mean", "running_var")


class HybridSequential(nn.Sequential):
    """``nn.Sequential`` with gluon's ``add``."""

    def add(self, *blocks):
        for block in blocks:
            self.append(block)


class Dense(nn.Module):
    """Fully connected layer, weight ``[units, in_units]``, then the
    ``activation`` when one is named; ``flatten`` folds every input dim
    after the first (``[B, C, 1, 1]`` -> ``[B, C]``).  The weight draws
    from the default ``Uniform(0.07)``, the bias starts at zero."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 in_units=0, device=None):
        super().__init__()
        if in_units <= 0:
            raise MXNetError("Dense: the port has no deferred init; pass "
                             "in_units")
        dev = resolve_device(device)
        self._flatten = flatten
        self._act_type = activation
        self.weight = nn.Parameter(torch.empty(units, in_units, device=dev))
        self.bias = (nn.Parameter(torch.zeros(units, device=dev))
                     if use_bias else None)
        self.initializers = {"weight": None, "bias": Zero()}

    def forward(self, x):
        out = F.fully_connected(x, self.weight, self.bias, self._flatten)
        return F.activation(out, self._act_type) if self._act_type else out


class Dropout(nn.Module):
    """Zeroes each element with probability ``rate`` in training (masks
    shared along ``axes``), drawing from ``generator``, a
    ``torch.Generator`` on the input's device; identity in evaluation.
    The layer holds the generator, so the layers of one model can share
    one stream."""

    def __init__(self, rate, axes=(), generator=None):
        super().__init__()
        self._rate = rate
        self._axes = tuple(axes)
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self._rate, self.training, self.generator,
                         self._axes)

    def extra_repr(self):
        return f"p={self._rate}"


class BatchNorm(nn.Module):
    """Batch normalisation over the channels of NCHW data, with moving
    statistics.

    Training uses the batch's statistics (biased variance, one-pass or
    centred per ``MXNET_TPU_FAST_VARIANCE``) and updates
    ``running = momentum·running + (1 − momentum)·batch``; evaluation uses
    the moving ones.  This is not ``torch.nn.BatchNorm2d``, whose momentum
    has the opposite meaning and whose running variance is unbiased."""

    def __init__(self, momentum=0.9, epsilon=1e-5, in_channels=0,
                 device=None):
        super().__init__()
        if in_channels <= 0:
            raise MXNetError("BatchNorm: the port has no deferred init; pass "
                             "in_channels")
        dev = resolve_device(device)
        self._momentum = momentum
        self._epsilon = epsilon
        self.gamma = nn.Parameter(torch.ones(in_channels, device=dev))
        self.beta = nn.Parameter(torch.zeros(in_channels, device=dev))
        self.register_buffer("running_mean",
                             torch.zeros(in_channels, device=dev))
        self.register_buffer("running_var", torch.ones(in_channels, device=dev))
        self.initializers = {"gamma": One(), "beta": Zero(),
                             "running_mean": Zero(), "running_var": One()}

    def cast(self, dtype):
        return cast_keeping_norm_fp32(self, dtype)

    def forward(self, x):
        out, mean, var = F.batch_norm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            eps=self._epsilon, fix_gamma=False, training=self.training)
        if self.training:
            _update_running(self, mean, var)
        return out


@torch.no_grad()
def _update_running(block, mean, var):
    """``running = m·running + (1 − m)·batch`` for both moving statistics
    of ``block`` (momentum ``block._momentum``)."""
    m = block._momentum
    block.running_mean.copy_(m * block.running_mean + (1 - m) * mean)
    block.running_var.copy_(m * block.running_var + (1 - m) * var)


def cast_keeping_norm_fp32(block, dtype):
    """gluon's ``cast`` for a block that holds norm tensors: its own
    floating tensors go to ``dtype`` (a torch dtype or its name), except
    that ``gamma``, ``beta`` and the moving statistics stay fp32 when
    ``dtype`` is bf16 or fp16."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    low = dtype in (torch.bfloat16, torch.float16)
    for name, t in list(block.named_parameters(recurse=False)) + list(
            block.named_buffers(recurse=False)):
        if t.is_floating_point():
            keep = low and name in _FP32_NORM
            t.data = t.data.to(torch.float32 if keep else dtype)
    return block


class LayerNorm(nn.Module):
    """Layer normalisation over ``axis`` with fp32 moments (see
    :func:`~mxnet_tpu_torch.ops.nn.layer_norm`); ``gamma`` starts at one,
    ``beta`` at zero.  Their names keep them fp32 under
    ``amp.convert_block``."""

    def __init__(self, axis=-1, epsilon=1e-5, in_channels=0, device=None):
        super().__init__()
        if in_channels <= 0:
            raise MXNetError("LayerNorm: the port has no deferred init; pass"
                             " in_channels")
        dev = resolve_device(device)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = nn.Parameter(torch.ones(in_channels, device=dev))
        self.beta = nn.Parameter(torch.zeros(in_channels, device=dev))
        self.initializers = {"gamma": One(), "beta": Zero()}

    def forward(self, x):
        return F.layer_norm(x, self.gamma, self.beta, self._axis,
                            self._epsilon)


class Embedding(nn.Module):
    """Row lookup in a ``[input_dim, output_dim]`` table drawn from the
    default ``Uniform(0.07)``; its gradient is dense."""

    def __init__(self, input_dim, output_dim, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(input_dim, output_dim,
                                               device=dev))
        self.initializers = {"weight": None}

    def forward(self, x):
        return F.embedding(x, self.weight)


class Flatten(nn.Module):
    """``[B, ...]`` -> ``[B, prod(...)]``."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)
