"""Optimizers: the ``Optimizer`` base, ``SGD``, ``Adam``, and the Gluon
half, ``Updater`` / ``get_updater`` (counterparts of
``mxnet_tpu/optimizer/optimizer.py``).

``update(index, weight, grad, state)`` changes ``weight`` and ``state`` in
place through ``ops/optimizer_ops.py``; ``weight`` and ``grad`` are
tensors or NDArrays (a parameter's NDArray shares the module's tensor, so
the module sees the update).  The learning rate is the optimizer's, or its
``lr_scheduler``'s at ``num_update``; a parameter's rate and weight decay
are then scaled by its ``Parameter.lr_mult``/``wd_mult`` (``param_dict``,
which ``gluon.Trainer`` fills), else by ``lr_mult``/``wd_mult`` keyed by
index or by name (``param_idx2name``); with no multipliers set, wd applies
to every parameter, BN gamma and beta included.  Each ``update`` counts
per index (``_update_count``, ``num_update``); Adam's bias correction reads
the step count ``_t``, which a training step sets for all its updates.
While a :class:`~mxnet_tpu_torch.executor.CompiledTrainStep` runs its
updates, ``lr`` and ``_step`` are 0-dim fp32 tensors on the parameters'
device (the step writes them before each run, so a replayed CUDA graph
reads this step's values) and ``lr_scheduler`` is ``None``; the update
ops then compute as the JAX compiled step does.
bf16 weights take the plain update with a bf16 momentum, as in the JAX
package; ``multi_precision`` keeps an fp32 master copy of fp16 weights
(``update_multi_precision``).  The row-sparse lazy updates wait for a later
slice.
"""
from __future__ import annotations

import pickle
from typing import Any, Dict

import numpy as np
import torch

from ..ops.optimizer_ops import adam_update, sgd_mom_update, sgd_update

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "get_updater", "create",
           "register"]


def _raw(x):
    """The tensor of an NDArray (a tensor as is)."""
    return x if isinstance(x, torch.Tensor) else x._data


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
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 begin_num_update=0, multi_precision=False, param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.multi_precision = multi_precision
        self.param_dict = dict(param_dict or {})
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.idx2name = dict(param_idx2name or {})
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict[Any, int] = {}
        # The 1-based count of the training step under way, a 0-dim fp32
        # tensor set by CompiledTrainStep around its updates, and the
        # step's step sizes by lr multiplier (a dict); None outside a step.
        self._step = None
        self._step_sizes = None

    def create_state(self, index, weight: torch.Tensor):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def create_state_multi_precision(self, index, weight):
        """With ``multi_precision``, an fp16 weight's state is
        ``(state of its fp32 copy, the fp32 copy)``."""
        w = _raw(weight)
        if self.multi_precision and w.dtype == torch.float16:
            w32 = w.detach().float()
            return self.create_state(index, w32), w32
        return self.create_state(index, w)

    def update_multi_precision(self, index, weight, grad, state):
        """``update``, through the fp32 copy for an fp16 weight under
        ``multi_precision``."""
        w, g = _raw(weight), _raw(grad)
        if self.multi_precision and w.dtype == torch.float16:
            inner, w32 = state
            self.update(index, w32, g.float(), inner)
            with torch.no_grad():
                w.copy_(w32)
        else:
            self.update(index, w, g, state)
        if not isinstance(weight, torch.Tensor):
            weight._version += 1

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler overwrites learning rate")
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

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

    def _mult(self, attr, index):
        name = self.idx2name.get(index, index)
        if name in self.param_dict:
            return getattr(self.param_dict[name], attr)
        mults = getattr(self, attr)
        if index in mults:
            return mults[index]
        return mults.get(name, 1.0)

    def _get_lr(self, index):
        lr = (self.lr_scheduler(self.num_update) if self.lr_scheduler
              else self.lr)
        mult = self._mult("lr_mult", index)
        # no multiply for 1.0 (the JAX package multiplies only by a set
        # multiplier): inside a training step lr is a device tensor
        return lr if mult == 1.0 else lr * mult

    def _get_wd(self, index):
        return self.wd * self._mult("wd_mult", index)

    def __getstate__(self):
        # the Parameters of param_dict belong to the process's modules
        return dict(self.__dict__, param_dict={})


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
        weight, grad = _raw(weight), _raw(grad)
        self._update_count(index)
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
        weight, grad = _raw(weight), _raw(grad)
        self._update_count(index)
        lr = self._step_size(index, self._t(index))
        mean, var = state
        adam_update(weight, grad, mean, var, lr=lr, beta1=self.beta1,
                    beta2=self.beta2, epsilon=self.epsilon,
                    wd=self._get_wd(index), rescale_grad=self.rescale_grad,
                    clip_gradient=self.clip_gradient)


    def _step_size(self, index, t):
        """``lr·sqrt(1 − β2^t)/(1 − β1^t)``, in that order.  Inside a
        training step lr and t are 0-dim fp32 tensors (the JAX compiled
        step traces them as float32 arrays): the arithmetic is then fp32
        on the device, made once per lr multiplier for the step
        (``_step_sizes``; XLA's CSE gives the JAX trace the same)."""
        sizes = getattr(self, "_step_sizes", None)
        mult = self._mult("lr_mult", index)
        if sizes is not None and mult in sizes:
            return sizes[mult]
        size = (self._get_lr(index) * (1.0 - self.beta2 ** t) ** 0.5
                / (1.0 - self.beta1 ** t))
        if sizes is not None:
            sizes[mult] = size
        return size


class Updater:
    """Applies an optimizer to one index at a time, keeping each index's
    state (reference ``get_updater``): ``updater(index, grad, weight)``."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}
        self.states_synced: Dict[Any, bool] = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state_multi_precision(
                index, weight)
            self.states_synced[index] = True
        elif not self.states_synced[index]:
            self.states[index] = _to_device(self.states[index],
                                            _raw(weight).device)
            self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def get_states(self, dump_optimizer=False) -> bytes:
        """The states (and, with ``dump_optimizer``, the optimizer),
        pickled with each tensor as a numpy array."""
        blob = {"states": {k: _serialize(v) for k, v in self.states.items()}}
        if dump_optimizer:
            blob["optimizer"] = self.optimizer
        return pickle.dumps(blob)

    def set_states(self, states: bytes):
        """Restore :meth:`get_states`; each state moves to its weight's
        device at the next update."""
        blob = pickle.loads(states)
        if "optimizer" in blob:
            self.optimizer = blob["optimizer"]
        self.states = {k: _deserialize(v) for k, v in blob["states"].items()}
        self.states_synced = {k: False for k in self.states}


def _serialize(state):
    if isinstance(state, torch.Tensor):
        t = state.detach().cpu()
        if t.dtype == torch.bfloat16:
            return ("bf16", t.view(torch.int16).numpy())
        return ("nd", t.numpy())
    if isinstance(state, tuple):
        return ("tuple", tuple(_serialize(s) for s in state))
    return ("raw", state)


def _deserialize(blob):
    kind, value = blob
    if kind == "nd":
        return torch.from_numpy(np.array(value))
    if kind == "bf16":
        return torch.from_numpy(np.array(value)).view(torch.bfloat16)
    if kind == "tuple":
        return tuple(_deserialize(s) for s in value)
    return value


def _to_device(state, device):
    if isinstance(state, torch.Tensor):
        return state.to(device)
    if isinstance(state, tuple):
        return tuple(_to_device(s, device) for s in state)
    return state


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
