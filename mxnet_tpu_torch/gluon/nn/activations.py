"""Activation layers (counterparts of
``mxnet_tpu/gluon/nn/activations.py``): ``Activation`` (``relu``,
``tanh``, ``sigmoid``, ``softrelu``, ``softsign`` and the exact ``gelu``),
``LeakyReLU``, ``PReLU``, ``ELU``, ``SELU``, ``GELU`` and ``Swish``.
Each layer's ``forward`` computes on tensors; its ``hybrid_forward`` is
the JAX layer's (``Activation`` or ``LeakyReLU`` with the JAX layer's
params), the symbolic form that ``export`` traces."""
from __future__ import annotations

import torch

from ... import initializer as _init
from ...ops import F
from ..block import HybridBlock

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "GELU",
           "Swish"]


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        super().__init__(**kwargs)
        self._act_type = activation

    def _alias(self):
        # named after the activation once it is set, as in the reference
        return self._act_type if hasattr(self, "_act_type") else "activation"

    def forward(self, x):
        return F.activation(x, self._act_type)

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def extra_repr(self):
        return self._act_type


class _LeakyFamily(HybridBlock):
    """A ``LeakyReLU`` op of fixed ``act_type`` (and ``slope``)."""

    _act = "leaky"

    def __init__(self, slope=0.25, **kwargs):
        super().__init__(**kwargs)
        self._slope = slope

    def forward(self, x):
        return F.leaky_relu(x, act_type=self._act, slope=self._slope)

    def hybrid_forward(self, F, x):
        if self._act in ("leaky", "elu"):
            return F.LeakyReLU(x, act_type=self._act, slope=self._slope)
        return F.LeakyReLU(x, act_type=self._act)


class LeakyReLU(_LeakyFamily):
    """``x`` above 0, ``alpha·x`` below."""

    def __init__(self, alpha, **kwargs):
        super().__init__(alpha, **kwargs)


class ELU(_LeakyFamily):
    """``x`` above 0, ``alpha·(eˣ − 1)`` below."""

    _act = "elu"

    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(alpha, **kwargs)


class SELU(_LeakyFamily):
    """The self-normalising ELU (fixed scale and alpha)."""

    _act = "selu"


class GELU(_LeakyFamily):
    """The exact (erf) GELU."""

    _act = "gelu"


class PReLU(HybridBlock):
    """``x`` above 0, ``alpha·x`` below, with one learned ``alpha`` (shape
    ``(1,)``, 0.25 by default)."""

    def __init__(self, alpha_initializer="constant", device=None, **kwargs):
        super().__init__(device=device, **kwargs)
        init = (_init.Constant(0.25) if alpha_initializer == "constant"
                else alpha_initializer)
        with self.name_scope():
            self.alpha = self.params.get("alpha", shape=(1,), init=init)

    def forward(self, x):
        return F.leaky_relu(x, self.alpha, act_type="prelu")

    def hybrid_forward(self, F, x, alpha=None):
        return F.LeakyReLU(x, alpha, act_type="prelu")


class Swish(HybridBlock):
    """``x·sigmoid(beta·x)``."""

    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def forward(self, x):
        return x * torch.sigmoid(self._beta * x)

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)
