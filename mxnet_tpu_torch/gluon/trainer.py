"""``gluon.Trainer`` (counterpart of ``mxnet_tpu/gluon/trainer.py``,
reference ``python/mxnet/gluon/trainer.py``): applies an optimizer to a
set of :class:`~.parameter.Parameter` s.

``step(batch_size)`` sets the optimizer's ``rescale_grad`` to
``rescale_grad / batch_size`` (the loss's ``backward()`` gave the gradient
of the sum over the batch), reduces the gradients across devices, and
updates every parameter whose ``grad_req`` is not ``'null'`` through an
:class:`~mxnet_tpu_torch.optimizer.Updater`, in place.  One process
drives one card: as in the reference's single-worker case, ``kvstore``
``'device'``, ``'local'`` or ``None`` means no kvstore and no reduction.
A kvstore across cards is not ported, and any other ``kvstore`` raises.
"""
from __future__ import annotations

from typing import Dict, List

from .. import optimizer as opt
from ..base import MXNetError
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

_SINGLE_WORKER = ("device", "local", None)


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("params must be a ParameterDict or a list of "
                             "Parameters")
        self._params: List[Parameter] = []
        self._param2idx: Dict[str, int] = {}
        for i, p in enumerate(params):
            if not isinstance(p, Parameter):
                raise ValueError(f"expected Parameter, got {type(p)}")
            self._param2idx[p.name] = i
            self._params.append(p)
        if kvstore not in _SINGLE_WORKER or compression_params or \
                update_on_kvstore:
            raise MXNetError(
                f"Trainer: kvstore {kvstore!r} (compression, updates on the "
                "kvstore) is not ported; one process trains on one card "
                "with kvstore 'device', 'local' or None")
        self._kvstore = None
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: p for i, p in enumerate(self._params)}
        if isinstance(optimizer, opt.Optimizer):
            if set(optimizer_params) - {"rescale_grad"}:
                raise ValueError("optimizer_params must be None when "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updaters = [opt.get_updater(self._optimizer)]

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce the gradients, then update with them scaled by
        ``1 / batch_size``."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self.update(batch_size, ignore_stale_grad)

    def allreduce_grads(self):
        """Sum the gradients across devices: nothing to do on one card."""

    def update(self, batch_size, ignore_stale_grad=False):
        """Update every parameter from its gradient scaled by
        ``1 / batch_size`` (no reduction)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        updater = self._updaters[0]
        for i, p in enumerate(self._params):
            if p.grad_req == "null" or not p._allocated():
                continue
            updater(i, p.grad(), p.data())

    def save_states(self, fname):
        with open(fname, "wb") as f:
            f.write(self._updaters[0].get_states(dump_optimizer=False))

    def load_states(self, fname):
        with open(fname, "rb") as f:
            states = f.read()
        self._updaters[0].set_states(states)
        self._optimizer = self._updaters[0].optimizer
