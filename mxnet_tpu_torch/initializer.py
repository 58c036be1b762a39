"""Parameter initializers.

The JAX package's ``collect_params().initialize()`` fills every parameter
that names no initializer of its own from ``Uniform(0.07)``
(``mxnet_tpu/initializer.py``); :func:`initialize` does the same for the
port's modules: every ``nn.Linear`` and ``nn.Embedding`` weight draws from
``Uniform(0.07)``, while parameters that carry their own (RMSNorm's
ones) and constant buffers (the RoPE tables) keep their values.  Draws are
made in float32 and cast to the parameter's dtype, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["Initializer", "Uniform", "Constant", "initialize"]


class Initializer:
    def __call__(self, tensor: torch.Tensor, gen: torch.Generator) -> None:
        raise NotImplementedError


class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale: float):
        self.scale = float(scale)

    def __call__(self, tensor, gen):
        draw = torch.empty(tensor.shape, dtype=torch.float32,
                           device=tensor.device)
        draw.uniform_(-self.scale, self.scale, generator=gen)
        tensor.copy_(draw)


class Constant(Initializer):
    """A scalar or an array broadcast onto the tensor."""

    def __init__(self, value):
        self.value = value

    def __call__(self, tensor, gen=None):
        tensor.copy_(torch.as_tensor(np.asarray(self.value)))


@torch.no_grad()
def initialize(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Fill every ``nn.Linear``/``nn.Embedding`` weight of ``module`` from
    ``Uniform(0.07)`` with the generator ``gen``, in module order; returns
    ``module``."""
    init = Uniform(0.07)
    for sub in module.modules():
        if isinstance(sub, (nn.Linear, nn.Embedding)):
            init(sub.weight, gen)
    return module
