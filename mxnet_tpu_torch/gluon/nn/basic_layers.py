"""Basic layers: ``Sequential``, ``HybridSequential``, ``Dense``,
``Dropout``, ``BatchNorm``, ``SyncBatchNorm``, ``InstanceNorm``,
``LayerNorm``, ``GroupNorm``, ``Embedding``, ``Flatten``, ``Lambda`` and
``HybridLambda``.

Counterparts of ``mxnet_tpu/gluon/nn/basic_layers.py``, on
:class:`~mxnet_tpu_torch.gluon.block.HybridBlock` with the reference's
parameters, names, initializers and deferred shapes (``in_units=0``,
``in_channels=0`` infer the width at the first forward).  Each layer's
``forward`` computes on tensors.  The moving statistics are parameters with
``grad_req='null'`` in ``collect_params()`` and buffers of the module;
each layer registers its tensors in the JAX package's order, so
``state_dict()`` walks the same tensors as ``collect_params()``
(``convert.resnet_state_dict_from_mxnet`` relies on it).  ``Dropout``
draws its masks from the generator it is given; without one it draws from
the device's stream (``mx.random``) under the Gluon boundary and refuses
to train otherwise.  Each layer's ``hybrid_forward`` is the JAX layer's,
in registry ops: the symbolic form that ``export`` traces.
"""
from __future__ import annotations

import torch

from ... import autograd
from ... import ndarray as _ndmod
from ... import random as _random
from ...base import MXNetError
from ...ops import F
from ...ops.nn import _no_mesh
from ..block import Block, HybridBlock, _boundary_ctx

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "SyncBatchNorm", "InstanceNorm", "LayerNorm", "GroupNorm",
           "Embedding", "Flatten", "Lambda", "HybridLambda"]

_FP32_NORM = ("gamma", "beta", "running_mean", "running_var")


class _Stack:
    """``add``, ``len``, indexing and iteration over the children."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x, *args):
        for block in self._modules.values():
            x = block(x)
        return x

    def hybrid_forward(self, F, x, *args):
        return self.forward(x, *args)

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, key):
        layers = list(self._modules.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __iter__(self):
        return iter(self._modules.values())


class Sequential(_Stack, Block):
    """Children applied in turn."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)


class HybridSequential(_Stack, HybridBlock):
    """Children applied in turn (hybridizable in the reference)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)


def _prod(shape):
    n = 1
    for s in shape:
        n *= s
    return n


class Dense(HybridBlock):
    """Fully connected layer, weight ``[units, in_units]``, then the
    ``activation`` when one is named; ``flatten`` folds every input dim
    after the first (``[B, C, 1, 1]`` -> ``[B, C]``).  The weight draws
    from the initializer given to ``initialize`` (default
    ``Uniform(0.07)``), the bias starts at zero."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, device=None,
                 **kwargs):
        super().__init__(device=device, **kwargs)
        self._units = units
        self._flatten = flatten
        self._act_type = activation
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), init=weight_initializer,
                dtype=dtype, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), init=bias_initializer,
                    dtype=dtype, allow_deferred_init=True)
            else:
                self.bias = None

    def _shape_hint(self, x, *args):
        in_units = _prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self._reg_params["weight"].shape = (self._units, in_units)

    def forward(self, x):
        out = F.fully_connected(x, self.weight, self.bias, self._flatten)
        return F.activation(out, self._act_type) if self._act_type else out

    def hybrid_forward(self, F, x, weight=None, bias=None):
        if bias is None:
            out = F.FullyConnected(x, weight, no_bias=True,
                                   num_hidden=self._units,
                                   flatten=self._flatten)
        else:
            out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                                   flatten=self._flatten)
        if self._act_type:
            out = F.Activation(out, act_type=self._act_type)
        return out

    def extra_repr(self):
        return f"{self._units}, {self._act_type or 'linear'}"


class Dropout(HybridBlock):
    """Zeroes each element with probability ``rate`` in training (masks
    shared along ``axes``), drawing from ``generator``, a
    ``torch.Generator`` on the input's device, or, under the Gluon
    boundary without one, from the device's ``mx.random`` stream;
    identity in evaluation.  The layer holds the generator, so the layers
    of one model can share one stream; ``Trainer.snapshot()`` rewinds
    it."""

    def __init__(self, rate, axes=(), generator=None, **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = tuple(axes)
        self.generator = generator
        _random._holders.add(self)

    def forward(self, x):
        gen = self.generator
        if gen is None and self.training and _boundary_ctx() is not None:
            gen = _random.device_generator(x.device)
        return F.dropout(x, self._rate, self.training, gen, self._axes)

    def hybrid_forward(self, F, x):
        if self._rate > 0:
            return F.Dropout(x, p=self._rate, axes=self._axes)
        return F.copy(x)

    def extra_repr(self):
        return f"p={self._rate}"


class BatchNorm(HybridBlock):
    """Batch normalisation over the channels (axis 1) of NCHW data, with
    moving statistics.

    Training uses the batch's statistics (biased variance, one-pass or
    centred per ``MXNET_TPU_FAST_VARIANCE``) and updates
    ``running = momentum·running + (1 − momentum)·batch``; evaluation, and
    ``use_global_stats``, use the moving ones.  This is not
    ``torch.nn.BatchNorm2d``, whose momentum has the opposite meaning and
    whose running variance is unbiased.  ``scale=False`` fixes gamma at 1
    and ``center=False`` leaves beta out of the gradient."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 device=None, **kwargs):
        super().__init__(device=device, **kwargs)
        if axis != 1:
            raise MXNetError("BatchNorm: only axis=1 (NCHW) is ported")
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._center = center
        self._scale = scale
        self._use_global_stats = use_global_stats
        self.in_channels = in_channels
        shape = (in_channels,)
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null", shape=shape,
                init=gamma_initializer, allow_deferred_init=True,
                differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null", shape=shape,
                init=beta_initializer, allow_deferred_init=True,
                differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=shape,
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=shape,
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)

    def _shape_hint(self, x, *args):
        for name in _FP32_NORM:
            self._reg_params[name].shape = (x.shape[self._axis],)

    def cast(self, dtype):
        """Norm tensors stay fp32 when ``dtype`` is bf16 or fp16."""
        return cast_keeping_norm_fp32(self, dtype)

    def forward(self, x):
        training = self.training and not self._use_global_stats
        out, mean, var = F.batch_norm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            eps=self._epsilon, fix_gamma=not self._scale, training=training)
        if training:
            _update_running(self, mean, var)
        return out

    def hybrid_forward(self, F, x, gamma=None, beta=None, running_mean=None,
                       running_var=None):
        # output_mean_var keeps the statistics visible to a symbolic trace
        out, mean, var = F.BatchNorm(
            x, gamma, beta, running_mean, running_var, eps=self._epsilon,
            momentum=self._momentum, fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis,
            output_mean_var=True)
        _update_running_symbolic(self, running_mean, running_var, mean, var)
        return out

    def extra_repr(self):
        return f"axis={self._axis}, momentum={self._momentum}"


class SyncBatchNorm(BatchNorm):
    """Cross-device BatchNorm (``gluon.contrib.nn.SyncBatchNorm`` is the
    same class).  Without ``axis_name`` it is BatchNorm on the one
    device, as the JAX layer is outside ``shard_map``, with the
    ``_contrib_SyncBatchNorm`` op's unclamped one-pass variance; an
    ``axis_name`` (statistics reduced over a mesh axis) raises
    :class:`~mxnet_tpu_torch.MXNetError` (ROADMAP A11b)."""

    def __init__(self, in_channels=0, num_devices=None, axis_name=None,
                 **kwargs):
        _no_mesh(axis_name)
        super().__init__(in_channels=in_channels, **kwargs)
        self._num_devices = num_devices
        self._axis_name = axis_name

    def forward(self, x):
        training = self.training and not self._use_global_stats
        out, mean, var = F.sync_batch_norm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            eps=self._epsilon, fix_gamma=not self._scale, training=training)
        if training:
            _update_running(self, mean, var)
        return out

    def hybrid_forward(self, F, x, gamma=None, beta=None, running_mean=None,
                       running_var=None):
        out, mean, var = F._contrib_SyncBatchNorm(
            x, gamma, beta, running_mean, running_var, eps=self._epsilon,
            momentum=self._momentum, fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats,
            ndev=self._num_devices or 1, axis_name=self._axis_name,
            output_mean_var=True)
        _update_running_symbolic(self, running_mean, running_var, mean, var)
        return out


def _update_running_symbolic(block, running_mean, running_var, mean, var):
    """The moving statistics' update of a norm layer's ``hybrid_forward``
    (NDArrays), in training unless ``use_global_stats``."""
    if autograd.is_training() and not block._use_global_stats:
        m = block._momentum
        running_mean._set_data(m * running_mean._data + (1 - m) * mean._data)
        running_var._set_data(m * running_var._data + (1 - m) * var._data)


@torch.no_grad()
def _update_running(block, mean, var):
    """``running = m·running + (1 − m)·batch`` for both moving statistics
    of ``block`` (momentum ``block._momentum``)."""
    m = block._momentum
    block.running_mean.copy_(m * block.running_mean + (1 - m) * mean)
    block.running_var.copy_(m * block.running_var + (1 - m) * var)


def cast_keeping_norm_fp32(block, dtype):
    """gluon's ``cast`` for a block that holds norm tensors: its own
    parameters go to ``dtype`` (a torch dtype or its name), except that
    ``gamma``, ``beta`` and the moving statistics stay fp32 when ``dtype``
    is bf16 or fp16; returns ``block``."""
    name = str(dtype).split(".")[-1]
    low = name in ("bfloat16", "float16")
    for attr, p in block._reg_params.items():
        p.cast("float32" if low and attr in _FP32_NORM else name)
    return block


class LayerNorm(HybridBlock):
    """Layer normalisation over ``axis`` with fp32 moments (see
    :func:`~mxnet_tpu_torch.ops.nn.layer_norm`); ``gamma`` starts at one,
    ``beta`` at zero.  Their names keep them fp32 under
    ``amp.convert_block``."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, device=None, **kwargs):
        super().__init__(device=device, **kwargs)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def _shape_hint(self, x, *args):
        for name in ("gamma", "beta"):
            self._reg_params[name].shape = (x.shape[self._axis],)

    def forward(self, x):
        return F.layer_norm(x, self.gamma, self.beta, self._axis,
                            self._epsilon)

    def hybrid_forward(self, F, x, gamma=None, beta=None):
        out, _, _ = F.LayerNorm(x, gamma, beta, axis=self._axis,
                                eps=self._epsilon, output_mean_var=True)
        return out


class _AffineNorm(HybridBlock):
    """A normalisation with per-channel ``gamma`` (one) and ``beta``
    (zero) over axis 1; ``scale``/``center`` False take them out of the
    gradient."""

    def __init__(self, epsilon, center, scale, beta_initializer,
                 gamma_initializer, in_channels, device=None, **kwargs):
        super().__init__(device=device, **kwargs)
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def _shape_hint(self, x, *args):
        for name in ("gamma", "beta"):
            self._reg_params[name].shape = (x.shape[1],)


class InstanceNorm(_AffineNorm):
    """Each sample's channel normalised over its spatial dims (fp32
    moments); ``gamma`` is fixed by default (``scale=False``)."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, **kwargs)
        self._axis = axis

    def forward(self, x):
        return F.instance_norm(x, self.gamma, self.beta, self._epsilon)

    def hybrid_forward(self, F, x, gamma=None, beta=None):
        return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)


class GroupNorm(_AffineNorm):
    """Each sample normalised over each of ``num_groups`` channel groups
    and the spatial dims (fp32 moments)."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, **kwargs)
        self._num_groups = num_groups

    def forward(self, x):
        return F.group_norm(x, self.gamma, self.beta, self._num_groups,
                            self._epsilon)

    def hybrid_forward(self, F, x, gamma=None, beta=None):
        return F.GroupNorm(x, gamma, beta, num_groups=self._num_groups,
                           eps=self._epsilon)


class Embedding(HybridBlock):
    """Row lookup in a ``[input_dim, output_dim]`` table drawn from the
    default ``Uniform(0.07)``; its gradient is dense."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, device=None,
                 **kwargs):
        super().__init__(device=device, **kwargs)
        if sparse_grad:
            raise MXNetError("Embedding: sparse gradients are not ported")
        self._input_dim = input_dim
        self._output_dim = output_dim
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim),
                init=weight_initializer, dtype=dtype)

    def forward(self, x):
        return F.embedding(x, self.weight)

    def hybrid_forward(self, F, x, weight=None):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim, sparse_grad=False)

    def extra_repr(self):
        return f"{self._input_dim} -> {self._output_dim}"


class Flatten(HybridBlock):
    """``[B, ...]`` -> ``[B, prod(...)]``."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)

    def hybrid_forward(self, F, x):
        return F.flatten(x)


class Lambda(Block):
    """Wraps a function of NDArrays, or the name of an ``mx.nd`` function."""

    _nd_forward = True

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func_impl = (getattr(_ndmod, function)
                           if isinstance(function, str) else function)

    def forward(self, *args):
        return self._func_impl(*args)


class HybridLambda(HybridBlock):
    """Wraps ``function(F, *args)``, or the name of an ``F`` function."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            name = function

            def impl(F, *args):
                return getattr(F, name)(*args)
            self._func_impl = impl
        else:
            self._func_impl = function

    def hybrid_forward(self, F, *args):
        return self._func_impl(F, *args)
