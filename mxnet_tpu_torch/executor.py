"""The training step (counterpart of ``mxnet_tpu/executor.py``).

:class:`CompiledTrainStep` keeps the JAX package's name and contract:
forward in training mode (``net(*x)`` for a tuple ``x``),
``loss_fn(out, y).mean()``, backward, then one optimizer update per
learnable parameter in ``parameters()`` order (the JAX package's
``collect_params`` order), with the optimizer's ``rescale_grad`` forced to
1.0 for the step (the mean already averages) and restored after.  A
parameter the loss does not reach gets a zero gradient and is still
updated, as under ``jax.value_and_grad``.  The step keeps a 1-based step
count and hands it to the optimizer for bias correction (Adam), as the
JAX package's compiled step does.  BN moving statistics are updated by the
forward.  It runs eagerly: the JAX package compiles the step into one XLA
program, and ``torch.compile``, CUDA graphs, meshes, buffer donation,
health watchpoints, the compile cache and gradient buckets come with later
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
        self._num_update = 0

    def __call__(self, x, y) -> torch.Tensor:
        """Run one step on a batch (``x`` a tensor or a tuple of the net's
        inputs); updates parameters, optimizer state and BN statistics in
        place and returns the mean loss (a 0-dim tensor on the net's
        device, not synchronised).  NDArray inputs (a Gluon iterator's
        batches) run on their tensors and give an NDArray loss."""
        from .ndarray.ndarray import NDArray
        if isinstance(y, NDArray):
            # Gluon batches: the step runs on their tensors
            ctx = y.context
            loss = self(tuple(a._data if isinstance(a, NDArray) else a
                              for a in (x if isinstance(x, tuple) else (x,))),
                        y._data)
            return NDArray(loss, ctx)
        net, opt = self._net, self._opt
        xs = x if isinstance(x, tuple) else (x,)
        was_training = net.training
        net.train()
        try:
            for p in self._learnable:
                p.grad = None
            loss = self._loss_fn(net(*xs), y).mean()
            loss.backward()
        finally:
            net.train(was_training)
        self._num_update += 1
        saved_rescale = opt.rescale_grad
        opt.rescale_grad = 1.0
        opt._step = self._num_update
        try:
            for i, (p, state) in enumerate(zip(self._learnable, self._states)):
                grad = p.grad if p.grad is not None else torch.zeros_like(p)
                opt.update(i, p.data, grad, state)
                p.grad = None
        finally:
            opt.rescale_grad = saved_rescale
            opt._step = None
        return loss.detach()
