"""``Activation`` (counterpart of ``mxnet_tpu/gluon/nn/activations.py``);
``relu``, ``tanh`` and the exact ``gelu``."""
from __future__ import annotations

from ...ops import nn as F
from ..block import HybridBlock

__all__ = ["Activation"]


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
