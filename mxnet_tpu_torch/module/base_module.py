"""``BaseModule``: the symbolic training loop's contract (counterpart of
``mxnet_tpu/module/base_module.py``; reference
``python/mxnet/module/base_module.py``: ``fit`` :409, ``forward_backward``
:193, ``score`` :331).

``fit`` binds, initializes the parameters and the optimizer, then runs
each epoch's batches through ``forward_backward``, ``update`` and
``update_metric``, calling the batch-end callbacks with a
``BatchEndParam`` and the epoch-end ones with the parameters.
"""
from __future__ import annotations

import logging
import time
from typing import Any, List

from .. import metric as _metric
from ..base import MXNetError
from ..model import BatchEndParam

__all__ = ["BaseModule"]


def _as_metric(m):
    return m if isinstance(m, _metric.EvalMetric) else _metric.create(m)


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self.inputs_need_grad = False
        self.symbol = None

    # ------------------------------------------------------------ high level
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0, sparse_row_id_fn=None):
        """The metric over ``eval_data`` in predict mode, as
        ``[(name, value)]``."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        eval_metric = _as_metric(eval_metric)
        eval_metric.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                for cb in _as_list(batch_end_callback):
                    cb(BatchEndParam(epoch, nbatch, eval_metric, locals()))
        if score_end_callback is not None:
            for cb in _as_list(score_end_callback):
                cb(BatchEndParam(epoch, nbatch, eval_metric, locals()))
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False, sparse_row_id_fn=None):
        """The outputs over ``eval_data`` in predict mode, each batch's
        padding cut; merged along the batch axis unless
        ``merge_batches=False`` (then one list per batch)."""
        from ..ndarray import ndarray as _nd
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        output_list: List[List[Any]] = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            output_list.append([o[0:o.shape[0] - pad]
                                for o in self.get_outputs()])
        if not output_list:
            return []
        if not merge_batches:
            return output_list
        num_outputs = len(output_list[0])
        merged = [_nd.concatenate([b[i] for b in output_list], axis=0)
                  for i in range(num_outputs)]
        if num_outputs == 1 and not always_output_list:
            return merged[0]
        return merged

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """``(outputs, batch_index, batch)`` for each batch, in predict
        mode."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            yield self.get_outputs(), nbatch, eval_batch

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None, prefetch_to_device=False):
        """The reference's symbolic training loop (``base_module.py:409``),
        epochs ``begin_epoch`` to ``num_epoch - 1``.  ``monitor`` is
        accepted and unused, as in the JAX package."""
        assert num_epoch is not None, "please specify num_epoch"
        if prefetch_to_device:
            raise MXNetError("fit(prefetch_to_device=True): DevicePrefetchIter"
                             " is not ported yet (ROADMAP A10)")
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        eval_metric = _as_metric(eval_metric)
        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            train_data.reset()
            for nbatch, data_batch in enumerate(train_data):
                self.forward_backward(data_batch)
                self.update()
                self.update_metric(eval_metric, data_batch.label)
                if batch_end_callback is not None:
                    for cb in _as_list(batch_end_callback):
                        cb(BatchEndParam(epoch, nbatch, eval_metric,
                                         locals()))
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            if epoch_end_callback is not None:
                arg, aux = self.get_params()
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg, aux)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)

    # ---------------------------------------------------------- to implement
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        raise NotImplementedError

    def get_states(self, merge_multi_context=True):
        raise NotImplementedError

    def set_states(self, states=None, value=None):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        raise NotImplementedError

    def install_monitor(self, mon):
        raise MXNetError("install_monitor: monitor.py is not ported yet "
                         "(ROADMAP A15)")

    def prepare(self, data_batch, sparse_row_id_fn=None):
        """Pre-batch hook; nothing to do by default."""

    # ------------------------------------------------------------- params io
    def save_params(self, fname):
        """The parameters with ``arg:``/``aux:`` keys, as a checkpoint's
        ``.params`` file."""
        from ..ndarray import save as _nd_save
        arg_params, aux_params = self.get_params()
        save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
        save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
        _nd_save(fname, save_dict)

    def load_params(self, fname):
        """Load a :meth:`save_params` file into a bound module, whether or
        not its parameters were initialized."""
        from ..ndarray import load as _nd_load
        arg_params, aux_params = {}, {}
        for k, v in _nd_load(fname).items():
            if ":" not in k:
                raise ValueError(f"invalid param file {fname}: key {k!r} has "
                                 "no arg:/aux: prefix (save_params format)")
            tp, name = k.split(":", 1)
            (arg_params if tp == "arg" else aux_params)[name] = v
        if not self.params_initialized:
            self.init_params(arg_params=arg_params, aux_params=aux_params,
                             allow_missing=False)
        else:
            self.set_params(arg_params, aux_params)

    # ------------------------------------------------------------ properties
    @property
    def data_names(self):
        raise NotImplementedError

    @property
    def output_names(self):
        raise NotImplementedError

    @property
    def data_shapes(self):
        raise NotImplementedError

    @property
    def label_shapes(self):
        raise NotImplementedError

    @property
    def output_shapes(self):
        raise NotImplementedError
