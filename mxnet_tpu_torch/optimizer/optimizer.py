"""Optimizers (counterparts of ``mxnet_tpu/optimizer/optimizer.py``): the
``Optimizer`` base, the 17 registered classes (``SGD``, ``NAG``,
``Signum``, ``FTML``, ``DCASGD``, ``SGLD``, ``Adam``, ``AdamW``,
``AdaGrad``, ``AdaDelta``, ``RMSProp``, ``Ftrl``, ``Adamax``, ``Nadam``,
``LARS``, ``LBSGD``, ``LAMB``), and the Gluon half, ``Updater`` /
``get_updater``.

``update(index, weight, grad, state)`` changes ``weight`` and ``state`` in
place, through ``ops/optimizer_ops.py`` or, where the JAX class computes
on NDArrays itself, through the same arithmetic on tensors; ``weight`` and
``grad`` are tensors or NDArrays (a parameter's NDArray shares the
module's tensor, so the module sees the update).  Each class keeps the
JAX class's defaults, state tuple and treatment of ``clip_gradient``
(passed to the op, where ≤ 0 or None is none, or tested with ``if``).
The learning rate is the optimizer's, or its ``lr_scheduler``'s at
``num_update``; a parameter's rate and weight decay are then scaled by its
``Parameter.lr_mult``/``wd_mult`` (``param_dict``, which
``gluon.Trainer`` fills), else by ``lr_mult``/``wd_mult`` keyed by index
or by name (``param_idx2name``); with no multipliers set, wd applies to
every parameter, BN gamma and beta included.  Each ``update`` counts per
index (``_update_count``, ``num_update``); the bias corrections read the
step count ``_t``, which a training step sets for all its updates.

While a :class:`~mxnet_tpu_torch.executor.CompiledTrainStep` runs its
updates, ``lr`` and ``_step`` are 0-dim fp32 tensors on the parameters'
device (the step writes them before each run, so a replayed CUDA graph
reads this step's values) and ``lr_scheduler`` is ``None``.  Nothing an
update computes then goes through the host: every per-step scalar is made
on the device from those two tensors, once per lr multiplier
(``_per_step``); LARS's trust ratio and LAMB's are ``where``s over device
norms; SGLD draws from the device's stream, which the graph registers;
Nadam's running schedule is a device tensor (``_step_state``) multiplied
in place; LBSGD's warmup is folded into the lr the step writes
(``_lr_at_step``).  So a replay computes what the eager step computes.
Outside a step the classes compute as the JAX package's do, with Python
floats (LARS's trust ratio, and SGLD's noise, come from the device there
too).

bf16 weights take the plain update with bf16 states, as in the JAX
package; ``multi_precision`` keeps an fp32 master copy of fp16 weights
(``update_multi_precision``; SGD and its subclasses through the
``mp_sgd_*`` ops).  The row-sparse lazy updates wait for ROADMAP A15.
"""
from __future__ import annotations

import math
import pickle
from typing import Any, Dict, List

import numpy as np
import torch

from .. import random as _random
from ..base import BFLOAT16, dtype_name, dtype_torch
from ..ops.optimizer_ops import (_ftml, _lamb_corr, _lamb_phase1, _s,
                                 adam_update, adamw_update, ftrl_update,
                                 lamb_update_phase2, mp_sgd_mom_update,
                                 mp_sgd_update, nag_mom_update,
                                 rmsprop_update, rmspropalex_update,
                                 sgd_mom_update, sgd_update, signsgd_update,
                                 signum_update)

__all__ = ["Optimizer", "SGD", "NAG", "Signum", "FTML", "DCASGD", "SGLD",
           "Adam", "AdamW", "AdaGrad", "AdaDelta", "RMSProp", "Ftrl",
           "Adamax", "Nadam", "LARS", "LBSGD", "LAMB", "Updater",
           "get_updater", "create", "register"]


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
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
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
        # step's per-step scalars by (kind, lr multiplier) (a dict); None
        # outside a step.
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

    def _lr_at_step(self, n: int) -> float:
        """The host learning rate of training step ``n`` (1-based), before
        any multiplier: what a training step writes into its ``lr``
        tensor.  The scheduler's at ``n``, else ``lr``."""
        if self.lr_scheduler is not None:
            return float(self.lr_scheduler(n))
        return float(self.lr)

    def _step_state(self, device) -> List[torch.Tensor]:
        """The tensors the updates read and write across the steps of a
        training step besides the states (made on ``device`` at its first
        step, outside any graph); none here."""
        return []

    def _per_step(self, kind, index, make):
        """``make()``: inside a training step once per step and lr
        multiplier (cached in ``_step_sizes``), else at every call."""
        sizes = getattr(self, "_step_sizes", None)
        if sizes is None:
            return make()
        key = (kind, self._mult("lr_mult", index))
        if key not in sizes:
            sizes[key] = make()
        return sizes[key]

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

    def _grad(self, grad):
        """``rescale_grad·grad``, clipped to ±``clip_gradient`` when that
        is set (the JAX classes that compute on NDArrays themselves)."""
        dt = grad.dtype
        g = grad * _s(self.rescale_grad, dt)
        if self.clip_gradient:
            c = _s(self.clip_gradient, dt)
            g = g.clamp(-c, c)
        return g

    def __getstate__(self):
        # the Parameters of param_dict belong to the process's modules;
        # device tensors of a training step are made again by the next one
        return dict(self.__dict__, param_dict={}, _step=None,
                    _step_sizes=None)


register = Optimizer.register
create = Optimizer.create_optimizer


def _zeros(weight, n):
    return tuple(torch.zeros_like(weight) for _ in range(n))


@register
class SGD(Optimizer):
    """SGD with optional momentum: ``mom = momentum·mom − lr·g``,
    ``w += mom`` (MXNet's rule); fp16 weights under ``multi_precision``
    through ``mp_sgd_update`` / ``mp_sgd_mom_update``.  ``lazy_update``
    (row-sparse gradients) is accepted; those wait for ROADMAP A15."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    def _kw(self, index):
        return dict(lr=self._get_lr(index), wd=self._get_wd(index),
                    rescale_grad=self.rescale_grad,
                    clip_gradient=self.clip_gradient)

    def update(self, index, weight, grad, state):
        weight, grad = _raw(weight), _raw(grad)
        self._update_count(index)
        kw = self._kw(index)
        if state is not None:
            sgd_mom_update(weight, grad, state, momentum=self.momentum, **kw)
        else:
            sgd_update(weight, grad, **kw)

    def update_multi_precision(self, index, weight, grad, state):
        w = _raw(weight)
        if not (self.multi_precision and w.dtype == torch.float16):
            return super().update_multi_precision(index, weight, grad, state)
        self._update_count(index)
        kw = self._kw(index)
        mom, w32 = state
        if mom is not None:
            mp_sgd_mom_update(w, _raw(grad), mom, w32,
                              momentum=self.momentum, **kw)
        else:
            mp_sgd_update(w, _raw(grad), w32, **kw)
        if not isinstance(weight, torch.Tensor):
            weight._version += 1


@register
class NAG(SGD):
    """Nesterov accelerated SGD (``nag_mom_update``); its fp16 path is
    SGD's, as in the JAX package."""

    def update(self, index, weight, grad, state):
        weight, grad = _raw(weight), _raw(grad)
        self._update_count(index)
        kw = self._kw(index)
        if state is not None:
            nag_mom_update(weight, grad, state, momentum=self.momentum, **kw)
        else:
            sgd_update(weight, grad, **kw)


@register
class Signum(Optimizer):
    """Sign of the momentum (``signum_update``), or of the gradient
    without momentum (``signsgd_update``)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

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
            signum_update(weight, grad, state, momentum=self.momentum,
                          wd_lh=self.wd_lh, **kw)
        else:
            signsgd_update(weight, grad, **kw)


@register
class FTML(Optimizer):
    """Follow the moving leader (``ftml_update``); state ``(d, v, z)``."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return _zeros(weight, 3)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        weight, grad = _raw(weight), _raw(grad)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._t(index)
        scalars = self._per_step("ftml", index, lambda: (
            (1.0 - self.beta1 ** t) / lr, 1.0 - self.beta2 ** t))
        d, v, z = state
        _ftml(weight, grad, d, v, z, scalars, self.beta1, self.beta2,
              self.epsilon, wd, self.rescale_grad, self.clip_gradient)


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD; state ``(momentum or None, the
    previous weight)``."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = torch.zeros_like(weight) if self.momentum else None
        return mom, weight.detach().clone()

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        weight, grad = _raw(weight), _raw(grad)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        dt = weight.dtype
        mom, prev = state
        g = self._grad(grad)
        g = g + _s(wd, dt) * weight + _s(self.lamda, dt) * g * g * (
            weight - prev)
        if mom is not None:
            mom.copy_(_s(self.momentum, dt) * mom - _s(lr, dt) * g)
            delta = mom
        else:
            delta = -_s(lr, dt) * g
        prev.copy_(weight)
        weight.copy_(weight + delta)


def _sgld_noise(weight, lr):
    """N(0, lr) noise shaped like ``weight``, in its dtype, from the
    device's stream (registered with a training step's graph, so each
    replay draws afresh)."""
    std = torch.sqrt(lr) if isinstance(lr, torch.Tensor) else math.sqrt(lr)
    gen = _random.device_generator(weight.device)
    return torch.randn(weight.shape, dtype=weight.dtype,
                       device=weight.device, generator=gen) * std


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics:
    ``w += −lr/2·(g + wd·w) + N(0, lr)``."""

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        weight, grad = _raw(weight), _raw(grad)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        dt = weight.dtype
        g = self._grad(grad)
        noise = _sgld_noise(weight, lr)
        weight.copy_(weight - _s(lr / 2, dt) * (g + _s(wd, dt) * weight)
                     + noise)


@register
class Adam(Optimizer):
    """Adam: ``lr·sqrt(1 − β2^t)/(1 − β1^t)`` as the step size, mean and
    variance kept in the weight's dtype."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return _zeros(weight, 2)

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
        (``_per_step``; XLA's CSE gives the JAX trace the same)."""
        return self._per_step("adam", index, lambda: (
            self._get_lr(index) * (1.0 - self.beta2 ** t) ** 0.5
            / (1.0 - self.beta1 ** t)))


@register
class AdamW(Adam):
    """Adam with decoupled weight decay (``adamw_update``, eta 1)."""

    def update(self, index, weight, grad, state):
        weight, grad = _raw(weight), _raw(grad)
        self._update_count(index)
        wd = self._get_wd(index)
        lr = self._step_size(index, self._t(index))
        mean, var = state
        adamw_update(weight, grad, mean, var, lr=lr, beta1=self.beta1,
                     beta2=self.beta2, epsilon=self.epsilon, wd=wd,
                     rescale_grad=self.rescale_grad,
                     clip_gradient=self.clip_gradient)


@register
class AdaGrad(Optimizer):
    """AdaGrad: the history sums the clipped, rescaled g² only; wd is
    applied outside the adaptive scale."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        weight, grad = _raw(weight), _raw(grad)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        dt = weight.dtype
        g = self._grad(grad)
        state.copy_(state + g * g)
        div = g / ((state + _s(self.float_stable_eps, dt)) ** 0.5)
        weight.copy_(weight - _s(lr, dt) * (div + _s(wd, dt) * weight))


@register
class AdaDelta(Optimizer):
    """AdaDelta (no learning rate); state ``(acc_g, acc_delta)``."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        weight, grad = _raw(weight), _raw(grad)
        self._update_count(index)
        wd = self._get_wd(index)
        dt = weight.dtype
        rho, eps = _s(self.rho, dt), _s(self.epsilon, dt)
        rho1 = _s(1 - self.rho, dt)
        g = self._grad(grad)
        acc_g, acc_delta = state
        acc_g.copy_(rho * acc_g + rho1 * g * g)
        delta = ((acc_delta + eps) ** 0.5) / ((acc_g + eps) ** 0.5) * g
        acc_delta.copy_(rho * acc_delta + rho1 * delta * delta)
        weight.copy_(weight - delta - _s(wd, dt) * weight)


@register
class RMSProp(Optimizer):
    """RMSProp (``rmsprop_update``), or Graves' centered form
    (``rmspropalex_update``, state ``(n, g, delta)``) with ``centered``."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return _zeros(weight, 3)
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        weight, grad = _raw(weight), _raw(grad)
        self._update_count(index)
        kw = dict(lr=self._get_lr(index), gamma1=self.gamma1,
                  epsilon=self.epsilon, wd=self._get_wd(index),
                  rescale_grad=self.rescale_grad,
                  clip_gradient=self.clip_gradient,
                  clip_weights=self.clip_weights)
        if self.centered:
            n, g, delta = state
            rmspropalex_update(weight, grad, n, g, delta, gamma2=self.gamma2,
                               **kw)
        else:
            rmsprop_update(weight, grad, state, **kw)


@register
class Ftrl(Optimizer):
    """FTRL-proximal (``ftrl_update``); state ``(z, n)``."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def update(self, index, weight, grad, state):
        weight, grad = _raw(weight), _raw(grad)
        self._update_count(index)
        z, n = state
        ftrl_update(weight, grad, z, n, lr=self._get_lr(index),
                    lamda1=self.lamda1, beta=self.beta,
                    wd=self._get_wd(index), rescale_grad=self.rescale_grad,
                    clip_gradient=self.clip_gradient)


@register
class Adamax(Optimizer):
    """Adam with the infinity norm; state ``(m, u)``."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        weight, grad = _raw(weight), _raw(grad)
        self._update_count(index)
        wd = self._get_wd(index)
        t = self._t(index)
        lr = self._per_step("adamax", index, lambda: (
            self._get_lr(index) / (1.0 - self.beta1 ** t)))
        dt = weight.dtype
        g = grad * _s(self.rescale_grad, dt) + _s(wd, dt) * weight
        if self.clip_gradient:
            c = _s(self.clip_gradient, dt)
            g = g.clamp(-c, c)
        m, u = state
        m.copy_(_s(self.beta1, dt) * m + _s(1.0 - self.beta1, dt) * g)
        u.copy_(torch.maximum(u * _s(self.beta2, dt), g.abs()))
        weight.copy_(weight - _s(lr, dt) * m / (u + _s(1e-8, dt)))


@register
class Nadam(Optimizer):
    """Nesterov Adam.  ``m_schedule`` (the product of every momentum so
    far, multiplied once per index per step, as in the JAX package) is a
    Python float eagerly; inside a training step it is a 0-dim fp32
    device tensor (``_step_state``) that each update multiplies in
    place."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0
        self._m_schedule_t = None

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def __getstate__(self):
        d = super().__getstate__()
        if self._m_schedule_t is not None:
            # a training step's schedule (read back once, outside a step)
            d["m_schedule"] = float(self._m_schedule_t)
        d["_m_schedule_t"] = None
        return d

    def _step_state(self, device):
        t = self._m_schedule_t
        if t is None or t.device != torch.device(device):
            self._m_schedule_t = torch.tensor(float(self.m_schedule),
                                              dtype=torch.float32,
                                              device=device)
        return [self._m_schedule_t]

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        weight, grad = _raw(weight), _raw(grad)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._t(index)
        dt = weight.dtype
        g = grad * _s(self.rescale_grad, dt) + _s(wd, dt) * weight
        if self.clip_gradient:
            c = _s(self.clip_gradient, dt)
            g = g.clamp(-c, c)
        b1, sd = self.beta1, self.schedule_decay
        momentum_t = b1 * (1.0 - 0.5 * 0.96 ** (t * sd))
        momentum_t_1 = b1 * (1.0 - 0.5 * 0.96 ** ((t + 1) * sd))
        if self._step is not None:
            sched = self._m_schedule_t.mul_(momentum_t)
        else:
            self.m_schedule *= momentum_t
            sched = self.m_schedule
        sched_next = sched * momentum_t_1
        m, v = state
        m.copy_(_s(b1, dt) * m + _s(1.0 - b1, dt) * g)
        v.copy_(_s(self.beta2, dt) * v + _s(1.0 - self.beta2, dt) * g * g)
        g_prime = g / _s(1.0 - sched, dt)
        m_prime = m / _s(1.0 - sched_next, dt)
        v_prime = v / _s(1.0 - self.beta2 ** t, dt)
        m_bar = (_s(1.0 - momentum_t, dt) * g_prime
                 + _s(momentum_t_1, dt) * m_prime)
        weight.copy_(weight - _s(lr, dt) * m_bar
                     / ((v_prime ** 0.5) + _s(self.epsilon, dt)))


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling: lr times the trust ratio
    ``eta·|w| / (|g| + wd·|w| + ε)`` (1 where a norm is 0), computed on
    the device, then SGD with optional momentum."""

    def __init__(self, momentum=0.0, eta=0.001, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        weight, grad = _raw(weight), _raw(grad)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        dt = weight.dtype
        g = self._grad(grad)
        w_norm = torch.linalg.vector_norm(weight.float())
        g_norm = torch.linalg.vector_norm(g.float())
        trust = torch.where((w_norm > 0) & (g_norm > 0),
                            self.eta * w_norm / (g_norm + wd * w_norm
                                                 + self.epsilon), 1.0)
        lr = (lr * trust).to(dt)
        g = g + _s(wd, dt) * weight
        if state is not None:
            state.copy_(_s(self.momentum, dt) * state - lr * g)
            weight.add_(state)
        else:
            weight.sub_(lr * g)


@register
class LBSGD(SGD):
    """Large-batch SGD with lr warmup: the rate ramps from ``lr`` to
    ``batch_scale·lr`` over ``warmup_epochs·updates_per_epoch`` updates
    (``'linear'``, ``'sqrt'``, ``'lars'``/``'power2'``; any other strategy
    takes ``batch_scale`` at once).  Inside a training step the warmup is
    part of the lr the step writes (``_lr_at_step``)."""

    def __init__(self, warmup_strategy="linear", warmup_epochs=5,
                 batch_scale=1, updates_per_epoch=32, begin_epoch=0,
                 num_epochs=60, **kwargs):
        super().__init__(**kwargs)
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = updates_per_epoch
        self._warmup_updates = max(1, int(warmup_epochs * updates_per_epoch))

    def _warmup_scale(self, n):
        frac = min(n, self._warmup_updates) / self._warmup_updates
        if self.warmup_strategy == "linear":
            return 1.0 + (self.batch_scale - 1.0) * frac
        if self.warmup_strategy == "sqrt":
            return 1.0 + (math.sqrt(self.batch_scale) - 1.0) * frac
        if self.warmup_strategy in ("lars", "power2"):
            return 1.0 + (self.batch_scale - 1.0) * frac * frac
        return self.batch_scale

    def _get_lr(self, index):
        lr = super()._get_lr(index)
        if self._step is not None:
            return lr          # the step's lr carries the warmup already
        return lr * self._warmup_scale(self.num_update)

    def _lr_at_step(self, n):
        return super()._lr_at_step(n) * self._warmup_scale(n)


@register
class LAMB(Optimizer):
    """Layer-wise adaptive moments: ``lamb_update_phase1`` (moments and
    direction), the norms of the weight and the direction on the device,
    then ``lamb_update_phase2`` (their ratio as a ``where``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        weight, grad = _raw(weight), _raw(grad)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._t(index)
        corr = self._per_step("lamb", index, lambda: _lamb_corr(
            self.beta1, self.beta2, t, self.bias_correction))
        mean, var = state
        g_update = _lamb_phase1(weight, grad, mean, var, self.beta1,
                                self.beta2, self.epsilon, corr, wd,
                                self.rescale_grad, self.clip_gradient)
        r1 = torch.linalg.vector_norm(weight)
        r2 = torch.linalg.vector_norm(g_update)
        lamb_update_phase2(weight, g_update, r1, r2, lr=lr,
                           lower_bound=self.lower_bound,
                           upper_bound=self.upper_bound)


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
    """The JAX package's form: ``("nd", array, dtype)`` for a tensor (a
    bfloat16 one as numpy's bfloat16 from ``ml_dtypes`` where that package
    is installed, else as its uint16 bits), ``None`` for a missing state,
    ``("tuple", ...)`` and ``("raw", value)`` for the rest."""
    if state is None:
        return None
    if isinstance(state, torch.Tensor):
        t = state.detach().cpu()
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).numpy().view(np.uint16)
            if not isinstance(BFLOAT16, str):
                bits = bits.view(BFLOAT16)
            return ("nd", bits, "bfloat16")
        return ("nd", t.numpy(), dtype_name(t.dtype))
    if isinstance(state, tuple):
        return ("tuple", tuple(_serialize(s) for s in state))
    return ("raw", state)


def _deserialize(blob):
    """Inverse of :func:`_serialize` (the JAX package's files too)."""
    if blob is None:
        return None
    kind, value = blob[0], blob[1]
    if kind == "nd":
        arr, dtype = np.array(value), blob[2]
        if dtype == "bfloat16":
            # numpy's bfloat16 (ml_dtypes) or its uint16 bits
            return torch.from_numpy(arr.view(np.uint16).view(np.int16)
                                    ).view(torch.bfloat16)
        return torch.from_numpy(arr).to(dtype_torch(dtype, narrow=False))
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
