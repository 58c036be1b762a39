"""``Module``: symbolic training over one ``Executor`` (counterpart of
``mxnet_tpu/module/module.py``; reference ``python/mxnet/module/module.py``).

``bind`` infers every shape from the data and label shapes and binds one
``Executor`` (``simple_bind``) on the module's context, the card unless
told otherwise; the grad_req of each argument follows ``for_training``,
``fixed_param_names`` and ``inputs_need_grad``.  ``init_optimizer``
follows the JAX package: with a kvstore (``'local'`` by default) it
creates the store, sets the optimizer on it and puts each parameter in
it, and ``update`` then pushes each gradient and pulls each weight back,
one key at a time; without one the module's own updater updates the
weights in place.  The two give the same numbers.  Over a ``dist_*``
store the push all-reduces across processes, and ``init_optimizer``
pulls each parameter back after putting it in, so every rank starts from
rank 0's weights (upstream MXNet pulls there; the JAX package does not,
which in one process changes nothing).

Where the JAX package departs from upstream MXNet 1.6 the port follows
it: ``init_optimizer`` leaves ``rescale_grad`` as given (upstream sets
``1/batch_size``), ``Module.load`` ignores ``load_optimizer_states``, a
one-device module still creates its kvstore, and the optimizer states
file holds no update counts, so Adam's bias correction restarts on
resume.
"""
from __future__ import annotations

import logging
import warnings
from typing import Dict, List, Tuple

from .. import initializer as _init
from .. import optimizer as _opt
from ..base import MXNetError
from ..io.io import DataDesc
from ..model import load_checkpoint, save_checkpoint
from ..ndarray.ndarray import NDArray
from .base_module import BaseModule

__all__ = ["Module"]


def _as_descs(shapes) -> List[DataDesc]:
    out = []
    for s in shapes or []:
        if isinstance(s, DataDesc):
            out.append(s)
        else:
            out.append(DataDesc(s[0], s[1], *s[2:]))
    return out


def _assign(arr: NDArray, value: NDArray) -> None:
    """``arr`` takes a copy of ``value``'s tensor, on ``arr``'s device."""
    arr._set_data(value._data.detach().to(arr._data.device, copy=True))


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=None, context=None,
                 work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger or logging)
        if group2ctxs:
            warnings.warn("group2ctxs placement is ignored: the module binds "
                          "one Executor on one device", UserWarning,
                          stacklevel=2)
        self._symbol = symbol
        self.symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._fixed_param_names = set(fixed_param_names or [])
        self._context = context
        inputs = self._data_names + self._label_names
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in inputs]
        self._aux_names = symbol.list_auxiliary_states()
        self._exec = None
        self._data_shapes: List[DataDesc] = []
        self._label_shapes: List[DataDesc] = []
        self._optimizer = None
        self._updater = None
        self._kvstore = None
        self._update_on_kvstore = False
        self._grad_req = "write"
        self._var_attrs = None

    # ------------------------------------------------------------ properties
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return [(n, o.shape) for n, o in zip(self.output_names,
                                              self._exec.outputs)]

    # ------------------------------------------------------------------ bind
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self._data_shapes = _as_descs(data_shapes)
        self._label_shapes = _as_descs(label_shapes)
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        descs = self._data_shapes + self._label_shapes
        req: Dict[str, str] = {}
        for name in self._symbol.list_arguments():
            if name in self._param_names and for_training and \
                    name not in self._fixed_param_names:
                req[name] = grad_req
            elif inputs_need_grad and name in self._data_names:
                req[name] = "write"
            else:
                req[name] = "null"
        self._exec = self._symbol.simple_bind(
            ctx=self._context, grad_req=req,
            type_dict={d.name: d.dtype for d in descs},
            **{d.name: d.shape for d in descs})
        self.binded = True
        if shared_module is not None and shared_module.params_initialized:
            self.set_params(*shared_module.get_params(), allow_missing=False)

    # ---------------------------------------------------------------- params
    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Each parameter from ``arg_params``/``aux_params`` when there,
        else (when they are None, or with ``allow_missing``) from
        ``initializer`` (default ``Uniform(0.01)``) by its name and its
        variable's attributes; a parameter missing from a given dict
        without ``allow_missing`` raises."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing parameters"
        init = _init.create(initializer if initializer is not None
                            else _init.Uniform(0.01))
        for names, table, given, what in (
                (self._param_names, self._exec.arg_dict, arg_params,
                 "parameter"),
                (self._aux_names, self._exec.aux_dict, aux_params,
                 "auxiliary state")):
            for name in names:
                arr = table[name]
                if given is not None and name in given:
                    _assign(arr, given[name])
                elif given is not None and not allow_missing:
                    raise MXNetError(f"{what} {name} is missing from the "
                                     "given params and allow_missing=False")
                else:
                    init(_init.InitDesc(name, attrs=self._var_init_attrs(name)),
                         arr)
        self.params_initialized = True

    def _var_init_attrs(self, name: str) -> dict:
        """The attributes of the variable ``name`` (``__init__`` among
        them), from one walk of the graph."""
        if self._var_attrs is None:
            from ..symbol.symbol import _topo
            self._var_attrs = {node.name: dict(node.attrs) for node in
                               _topo(self._symbol._outputs) if node.is_var}
        return self._var_attrs.get(name, {})

    def get_params(self) -> Tuple[Dict[str, NDArray], Dict[str, NDArray]]:
        """Copies of the parameters and auxiliary states."""
        assert self.binded and self.params_initialized
        arg = {n: self._exec.arg_dict[n].copy() for n in self._param_names}
        aux = {n: self._exec.aux_dict[n].copy() for n in self._aux_names}
        return arg, aux

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    # ------------------------------------------------------------- optimizer
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        if isinstance(optimizer, str):
            optimizer = _opt.create(
                optimizer, param_idx2name=dict(enumerate(self._param_names)),
                **dict(optimizer_params))
        self._optimizer = optimizer
        self._updater = _opt.get_updater(optimizer)
        if kvstore:
            from .. import kvstore as kv_mod
            kv = kv_mod.create(kvstore) if isinstance(kvstore, str) \
                else kvstore
            self._kvstore = kv
            self._update_on_kvstore = True
            kv.set_optimizer(optimizer)
            for i, name in enumerate(self._param_names):
                kv.init(i, self._exec.arg_dict[name])
                # a dist store holds rank 0's value: every rank starts
                # from it (upstream model._initialize_kvstore pulls too)
                kv.pull(i, out=self._exec.arg_dict[name])
        self.optimizer_initialized = True

    def borrow_optimizer(self, shared_module):
        """Share ``shared_module``'s optimizer, updater and kvstore
        (reference ``module.py:560``)."""
        assert shared_module.optimizer_initialized
        self._optimizer = shared_module._optimizer
        self._updater = shared_module._updater
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self.optimizer_initialized = True

    def save_optimizer_states(self, fname):
        """The optimizer states, through the kvstore when updates run
        there, else through the module's updater."""
        assert self.optimizer_initialized
        if self._update_on_kvstore and self._kvstore is not None:
            self._kvstore.save_optimizer_states(fname)
        else:
            with open(fname, "wb") as f:
                f.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._update_on_kvstore and self._kvstore is not None:
            self._kvstore.load_optimizer_states(fname)
        else:
            with open(fname, "rb") as f:
                self._updater.set_states(f.read())

    # ------------------------------------------------------------------ step
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        kwargs = {d.name: a for d, a in zip(self._data_shapes,
                                            data_batch.data)}
        if self._label_shapes and data_batch.label:
            kwargs.update((d.name, a) for d, a in zip(self._label_shapes,
                                                      data_batch.label))
        self._exec.forward(is_train=is_train, **kwargs)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads=out_grads)

    def update(self):
        """Each parameter's gradient pushed and its weight pulled through
        the kvstore, or the updater applied to it in place."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        on_kv = self._kvstore is not None and self._update_on_kvstore
        for i, name in enumerate(self._param_names):
            grad = self._exec.grad_dict.get(name)
            if grad is None:
                continue
            if on_kv:
                self._kvstore.push(i, grad)
                self._kvstore.pull(i, out=self._exec.arg_dict[name])
            else:
                self._updater(i, grad, self._exec.arg_dict[name])

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.inputs_need_grad
        return [self._exec.grad_dict[n] for n in self._data_names
                if n in self._exec.grad_dict]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update_dict(
            dict(zip([d.name for d in self._label_shapes], labels)),
            dict(zip(self.output_names, self._exec.outputs)))

    def get_states(self, merge_multi_context=True):
        """No executor run-states: RNN state is explicit data."""
        assert self.binded and self.params_initialized
        return []

    def set_states(self, states=None, value=None):
        assert self.binded and self.params_initialized
        if states:
            raise ValueError("this module has no executor states "
                             "(see get_states); only value=None/empty is "
                             "valid")

    # --------------------------------------------------------------- reshape
    def reshape(self, data_shapes, label_shapes=None):
        """Rebind for new input shapes with the same configuration and
        the current parameters."""
        assert self.binded
        params = self.get_params() if self.params_initialized else None
        self.bind(data_shapes, label_shapes, for_training=self.for_training,
                  inputs_need_grad=self.inputs_need_grad, force_rebind=True,
                  grad_req=self._grad_req)
        if params is not None:
            self.set_params(*params, allow_missing=False)

    # ------------------------------------------------------------ checkpoint
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        remove_amp_cast=True):
        arg, aux = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg, aux)
        if save_optimizer_states:
            self.save_optimizer_states(f"{prefix}-{epoch:04d}.states")

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A module over a checkpoint's symbol whose ``bind`` then sets
        the checkpoint's parameters.  ``load_optimizer_states`` is
        ignored, as in the JAX package: call
        :meth:`load_optimizer_states` after ``init_optimizer``."""
        sym, arg, aux = load_checkpoint(prefix, epoch)
        mod = Module(sym, **kwargs)
        orig_bind = mod.bind

        def bind_then_load(*a, **kw):
            orig_bind(*a, **kw)
            mod.set_params(arg, aux, allow_missing=False, force_init=True)
        mod.bind = bind_then_load
        return mod
