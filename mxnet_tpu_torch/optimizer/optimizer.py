"""Optimizers of the training slices: the ``Optimizer`` base, ``SGD`` and
``Adam`` (counterparts of ``mxnet_tpu/optimizer/optimizer.py``).

``update(index, weight, grad, state)`` changes ``weight`` and ``state`` in
place through ``ops/optimizer_ops.py``.  The learning rate and weight decay
of a parameter are the optimizer's times its ``lr_mult``/``wd_mult``, keyed
by index or by name (``param_idx2name``); with no multipliers set, wd
applies to every parameter, BN gamma and beta included.  bf16 weights
take the plain update with a bf16 momentum, as in the JAX package, whose
multi-precision path is for fp16 only; Adam's mean and variance take the
weight's dtype too.  Each ``update`` of an optimizer that needs it counts
per index (``_update_count``, ``num_update``); Adam's bias correction reads
the step count ``_t``, which a training step sets for all its updates.
The fp16 master-weight path (``multi_precision``), learning-rate schedules
and the row-sparse lazy updates wait for later slices.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..ops.optimizer_ops import adam_update, sgd_mom_update, sgd_update

__all__ = ["Optimizer", "SGD", "Adam", "create", "register"]


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
                 clip_gradient=None, learning_rate=0.01, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.idx2name = dict(param_idx2name or {})
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict[Any, int] = {}
        # The 1-based count of the training step under way, set by
        # CompiledTrainStep around its updates; None outside a step.
        self._step = None

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

    def _update_count(self, index):
        """Count one more update of ``index`` (from ``begin_num_update``);
        ``num_update`` is the largest count of any index."""
        self._index_update_count.setdefault(index, self.begin_num_update)
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _t(self, index):
        """Step count for bias correction: the training step's when one is
        under way, else this index's update count."""
        if self._step is not None:
            return self._step
        return self._index_update_count[index]

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


@register
class Adam(Optimizer):
    """Adam: ``lr·sqrt(1 − β2^t)/(1 − β1^t)`` as the step size, mean and
    variance kept in the weight's dtype."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return torch.zeros_like(weight), torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._t(index)
        lr = (self._get_lr(index) * (1.0 - self.beta2 ** t) ** 0.5
              / (1.0 - self.beta1 ** t))
        if self._step is not None:
            # the JAX compiled step traces lr as a float32 array
            lr = torch.tensor(lr, dtype=torch.float32)
        mean, var = state
        adam_update(weight, grad, mean, var, lr=lr, beta1=self.beta1,
                    beta2=self.beta2, epsilon=self.epsilon,
                    wd=self._get_wd(index), rescale_grad=self.rescale_grad,
                    clip_gradient=self.clip_gradient)
