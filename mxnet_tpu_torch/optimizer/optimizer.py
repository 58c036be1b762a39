"""Optimizers of the training slice: the ``Optimizer`` base and ``SGD``
(counterparts of ``mxnet_tpu/optimizer/optimizer.py``).

``update(index, weight, grad, state)`` changes ``weight`` and ``state`` in
place through ``ops/optimizer_ops.py``.  The learning rate and weight decay
of a parameter are the optimizer's times its ``lr_mult``/``wd_mult``, keyed
by index or by name (``param_idx2name``); with no multipliers set, wd
applies to every parameter, BN gamma and beta included.  bf16 weights
take the plain update with a bf16 momentum, as in the JAX package, whose
multi-precision path is for fp16 only.  That fp16 master-weight path
(``multi_precision``), learning-rate schedules, the update counts they
read and the row-sparse lazy updates wait for later slices.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..ops.optimizer_ops import sgd_mom_update, sgd_update

__all__ = ["Optimizer", "SGD", "create", "register"]


class Optimizer:
    opt_registry: Dict[str, type] = {}

    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name: str, **kwargs) -> "Optimizer":
        if name.lower() not in Optimizer.opt_registry:
            raise ValueError(f"unknown optimizer {name}; known "
                             f"{sorted(Optimizer.opt_registry)}")
        return Optimizer.opt_registry[name.lower()](**kwargs)

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.idx2name = dict(param_idx2name or {})
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}

    def create_state(self, index, weight: torch.Tensor):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Multipliers by index or name; names in ``param_idx2name`` that
        end in neither ``_weight`` nor ``_gamma`` (biases, beta) get 0 unless
        ``args_wd_mult`` says otherwise."""
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not (n.endswith("_weight") or n.endswith("_gamma"))}
        self.wd_mult.update(args_wd_mult)

    def _mult(self, mults, index):
        name = self.idx2name.get(index, index)
        if index in mults:
            return mults[index]
        return mults.get(name, 1.0)

    def _get_lr(self, index):
        return self.lr * self._mult(self.lr_mult, index)

    def _get_wd(self, index):
        return self.wd * self._mult(self.wd_mult, index)


register = Optimizer.register
create = Optimizer.create_optimizer


@register
class SGD(Optimizer):
    """SGD with optional momentum: ``mom = momentum·mom − lr·g``,
    ``w += mom`` (MXNet's rule)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        kw = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                  rescale_grad=self.rescale_grad,
                  clip_gradient=self.clip_gradient)
        if state is not None:
            sgd_mom_update(weight, grad, state, momentum=self.momentum, **kw)
        else:
            sgd_update(weight, grad, **kw)
