"""``Activation`` (counterpart of ``mxnet_tpu/gluon/nn/activations.py``);
``relu``, ``tanh`` and the exact ``gelu``."""
from __future__ import annotations

from torch import nn

from ...ops import nn as F

__all__ = ["Activation"]


class Activation(nn.Module):
    def __init__(self, activation):
        super().__init__()
        self._act_type = activation

    def forward(self, x):
        return F.activation(x, self._act_type)

    def extra_repr(self):
        return self._act_type
