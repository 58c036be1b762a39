"""``gluon.Trainer`` (counterpart of ``mxnet_tpu/gluon/trainer.py``,
reference ``python/mxnet/gluon/trainer.py``): applies an optimizer to a
set of :class:`~.parameter.Parameter` s.

``step(batch_size)`` sets the optimizer's ``rescale_grad`` to
``rescale_grad / batch_size`` (the loss's ``backward()`` gave the gradient
of the sum over the batch), reduces the gradients through the kvstore
(``allreduce_grads``) and updates every parameter whose ``grad_req`` is
not ``'null'`` (``update``), in place.

The kvstore follows the reference's decision matrix: ``None`` or
``'local'`` means none; any other store engages only when it has more
than one worker (a ``dist_*`` store in a job of several processes) or
its ``force_use`` is set.  Once engaged, each parameter is put in it
(rank 0's value reaches every rank) and pulled back, ``compression_params``
go to ``set_gradient_compression``, and the optimizer runs on the store
when ``update_on_kvstore`` (default ``MXNET_UPDATE_ON_KVSTORE``) is true:
``allreduce_grads`` then pushes every gradient in one list-form push and
``update`` pulls every weight; otherwise it pushpulls the gradients and
the Trainer's own updater applies them.  Optimizer-state sharding is not
ported (ROADMAP A11, the rest) and raises.
"""
from __future__ import annotations

from typing import Dict, List

from .. import optimizer as opt
from ..base import MXNetError, env
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, optimizer_state_sharding=None):
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
        if optimizer_state_sharding:
            raise MXNetError(
                "Trainer: optimizer_state_sharding (ZeRO, the JAX package's "
                "kvstore/sharded.py) is not ported yet (ROADMAP A11, the "
                "rest)")
        self._compression_params = compression_params
        self._kvstore_kind = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._kvstore = None
        self._kv_initialized = False
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

    def _init_kvstore(self):
        """The decision matrix (reference ``trainer.py:174-258``), at the
        first step, when deferred parameters have their shapes."""
        self._kv_initialized = True
        kind = self._kvstore_kind
        if kind is None or kind == "local":
            return
        from .. import kvstore as kv_mod
        kv = kv_mod.create(kind) if isinstance(kind, str) else kind
        if kv.num_workers == 1 and not kv.force_use:
            return
        self._kvstore = kv
        if self._compression_params:
            kv.set_gradient_compression(self._compression_params)
        if self._update_on_kvstore is None:
            self._update_on_kvstore = bool(env.MXNET_UPDATE_ON_KVSTORE)
        for i, p in enumerate(self._params):
            if p._allocated():
                kv.init(i, p.data())
                kv.pull(i, out=p.data())
        if self._update_on_kvstore:
            # the store runs the Trainer's own updater, so save_states and
            # load_states see its states wherever the update runs
            kv.set_optimizer(self._optimizer)
            kv._set_updater(self._updaters[0])

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
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self.update(batch_size, ignore_stale_grad)

    def _live(self):
        return [(i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null" and p._allocated()]

    def allreduce_grads(self):
        """Every gradient in one list-form push (or pushpull) with
        ``priority=-index``: a bucketed store issues
        ``ceil(bytes / MXNET_KVSTORE_BUCKET_KB)`` reductions for the step,
        the first layers' first.  Nothing to do without a kvstore."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._kvstore is None:
            return
        live = self._live()
        if not live:
            return
        keys = [i for i, _ in live]
        grads = [p.grad() for _, p in live]
        priorities = [-i for i in keys]
        if self._update_on_kvstore:
            self._kvstore.push(keys, grads, priority=priorities)
        else:
            self._kvstore.pushpull(keys, grads, out=grads,
                                   priority=priorities)

    def update(self, batch_size, ignore_stale_grad=False):
        """Update every parameter from its gradient scaled by
        ``1 / batch_size``: pulled from the kvstore when the optimizer
        runs there, else applied here."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        if self._kvstore is not None and self._update_on_kvstore:
            for i, p in self._live():
                self._kvstore.pull(i, out=p.data())
            return
        updater = self._updaters[0]
        for i, p in self._live():
            updater(i, p.grad(), p.data())

    def save_states(self, fname):
        with open(fname, "wb") as f:
            f.write(self._updaters[0].get_states(dump_optimizer=False))

    def load_states(self, fname):
        with open(fname, "rb") as f:
            states = f.read()
        self._updaters[0].set_states(states)
        self._optimizer = self._updaters[0].optimizer
