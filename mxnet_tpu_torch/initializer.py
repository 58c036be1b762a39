"""Parameter initializers.

The JAX package's ``collect_params().initialize()`` fills every parameter
from the initializer it names, and those that name none from
``Uniform(0.07)`` (``mxnet_tpu/initializer.py``).  :func:`initialize` does
the same for the port's modules:

- every ``nn.Linear`` and ``nn.Embedding`` weight (the Llama slice) draws
  from ``Uniform(0.07)``;
- a module with an ``initializers`` dict (the vision layers) fills each
  named tensor from its entry, ``None`` meaning ``Uniform(0.07)``: a
  ``Conv2D``/``Dense`` weight that names no initializer, ``Zero`` for
  biases, ``One``/``Zero`` for the BatchNorm tensors, ``Xavier`` for the
  fused 1x1 conv's weight;
- other parameters (RMSNorm's ones) and constant buffers (the RoPE tables)
  keep their values.

Draws are made in float32 and cast to the tensor's dtype, as in the JAX
package.  The streams differ from JAX's threefry, so tests copy weights
across instead of comparing draws.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

__all__ = ["Initializer", "Uniform", "Constant", "Zero", "One", "Xavier",
           "initialize"]


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


class Zero(Constant):
    def __init__(self):
        super().__init__(0.0)


class One(Constant):
    def __init__(self):
        super().__init__(1.0)


class Xavier(Initializer):
    """Glorot uniform, gluon's ``"xavier"``: U(-scale, scale) with
    ``scale = sqrt(3 / ((fan_in + fan_out) / 2))``, the fans
    ``shape[1]·prod(shape[2:])`` and ``shape[0]·prod(shape[2:])``."""

    def __call__(self, tensor, gen):
        shape = tensor.shape
        hw_scale = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        Uniform(math.sqrt(3.0 / ((fan_in + fan_out) / 2.0)))(tensor, gen)


@torch.no_grad()
def initialize(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Fill ``module``'s tensors as the JAX package's ``initialize()``
    does (see the module docstring), with the generator ``gen``, in module
    order; returns ``module``."""
    default = Uniform(0.07)
    for sub in module.modules():
        if isinstance(sub, (nn.Linear, nn.Embedding)):
            default(sub.weight, gen)
        for name, init in getattr(sub, "initializers", {}).items():
            tensor = getattr(sub, name)
            if tensor is not None:
                (init or default)(tensor, gen)
    return module
