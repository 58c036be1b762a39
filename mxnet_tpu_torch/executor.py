"""The training step (counterpart of ``mxnet_tpu/executor.py``).

:class:`CompiledTrainStep` keeps the JAX package's name and contract:
forward in training mode, ``loss_fn(out, y).mean()``, backward, then one
optimizer update per learnable parameter in ``parameters()`` order (the
JAX package's ``collect_params`` order), with the optimizer's
``rescale_grad`` forced to 1.0 for the step (the mean already averages)
and restored after.  BN moving statistics are updated by the forward.
It runs eagerly: the JAX package compiles the step into one XLA program,
and ``torch.compile``, CUDA graphs, meshes, buffer donation, health
watchpoints, the compile cache and gradient buckets come with later
slices.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["CompiledTrainStep"]


class CompiledTrainStep:
    """One training step over ``net`` + ``loss_fn`` + ``optimizer`` (an
    :class:`~mxnet_tpu_torch.optimizer.Optimizer`).  ``batch_size`` is
    informational: gradients are those of the mean loss."""

    def __init__(self, net, loss_fn, optimizer, batch_size: Optional[int] = None):
        self._net = net
        self._loss_fn = loss_fn
        self._opt = optimizer
        self.batch_size = batch_size
        self._learnable = [p for p in net.parameters() if p.requires_grad]
        self._states = [optimizer.create_state(i, p)
                        for i, p in enumerate(self._learnable)]

    def __call__(self, x, y) -> torch.Tensor:
        """Run one step on a batch; updates parameters, optimizer state and
        BN statistics in place and returns the mean loss (a 0-dim tensor on
        the net's device, not synchronised)."""
        net, opt = self._net, self._opt
        was_training = net.training
        net.train()
        try:
            for p in self._learnable:
                p.grad = None
            loss = self._loss_fn(net(x), y).mean()
            loss.backward()
        finally:
            net.train(was_training)
        saved_rescale = opt.rescale_grad
        opt.rescale_grad = 1.0
        try:
            for i, (p, state) in enumerate(zip(self._learnable, self._states)):
                opt.update(i, p.data, p.grad, state)
                p.grad = None
        finally:
            opt.rescale_grad = saved_rescale
        return loss.detach()
