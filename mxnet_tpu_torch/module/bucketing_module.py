"""``BucketingModule``: variable-length inputs as one ``Module`` per bucket
key, the parameters shared with the default bucket's (counterpart of
``mxnet_tpu/module/bucketing_module.py``; reference
``python/mxnet/module/bucketing_module.py``).

``sym_gen(bucket_key)`` gives ``(symbol, data_names, label_names)``.  A
bucket's module binds on first use from the default bucket's parameters
and borrows its optimizer; a switch back to a bucket copies the current
parameters in, and an update in another bucket copies them back to the
default one.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen: Callable, default_bucket_key=None,
                 logger=None, context=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger or logging)
        assert default_bucket_key is not None
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._buckets: Dict = {}
        self._curr_module: Optional[Module] = None
        self._curr_bucket_key = None

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        return self._sym_gen(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        return self._sym_gen(self._default_bucket_key)[0].list_outputs()

    @property
    def data_shapes(self):
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        return self._curr_module.output_shapes

    def _module_for(self, bucket_key) -> Module:
        if bucket_key not in self._buckets:
            sym, data_names, label_names = self._sym_gen(bucket_key)
            self._buckets[bucket_key] = Module(
                sym, data_names, label_names, logger=self.logger,
                context=self._context,
                fixed_param_names=self._fixed_param_names)
        return self._buckets[bucket_key]

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        mod = self._module_for(self._default_bucket_key)
        mod.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                 force_rebind, None, grad_req)
        self._curr_module = mod
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True
        self.symbol = mod.symbol

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key``'s module current, binding it on first use."""
        assert self.binded
        default = self._buckets[self._default_bucket_key]
        mod = self._module_for(bucket_key)
        if not mod.binded:
            mod.bind(data_shapes, label_shapes, self.for_training,
                     self.inputs_need_grad, False, shared_module=default,
                     grad_req=default._grad_req)
            if self.params_initialized:
                mod.set_params(*default.get_params())
            if default.optimizer_initialized:
                mod.borrow_optimizer(default)
        else:
            mod.set_params(*self._curr_module.get_params())
        self._curr_module = mod
        self._curr_bucket_key = bucket_key

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        assert self.binded
        self._curr_module.init_params(initializer, arg_params, aux_params,
                                      allow_missing, force_init, allow_extra)
        self.params_initialized = True

    def get_params(self):
        return self._curr_module.get_params()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self._curr_module.set_params(arg_params, aux_params, allow_missing,
                                     force_init, allow_extra)
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        self._curr_module.init_optimizer(kvstore, optimizer, optimizer_params,
                                         force_init)
        self.optimizer_initialized = True

    def prepare(self, data_batch, sparse_row_id_fn=None):
        """Bind the batch's bucket if needed, then switch back: ``prepare``
        leaves the current bucket as it was."""
        assert self.binded
        bucket_key = getattr(data_batch, "bucket_key", None)
        if bucket_key is not None:
            original_key = self._curr_bucket_key
            self.switch_bucket(bucket_key, data_batch.provide_data,
                               getattr(data_batch, "provide_label", None))
            self.switch_bucket(original_key, None, None)

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        key = data_batch.bucket_key
        if key is None:
            key = self._curr_bucket_key
        if key != self._curr_bucket_key:
            self.switch_bucket(key, data_batch.provide_data,
                               data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._curr_module.update()
        if self._curr_bucket_key != self._default_bucket_key:
            self._buckets[self._default_bucket_key].set_params(
                *self._curr_module.get_params())

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._curr_module.get_input_grads(merge_multi_context)

    def get_states(self, merge_multi_context=True):
        return self._curr_module.get_states(merge_multi_context)

    def set_states(self, states=None, value=None):
        return self._curr_module.set_states(states, value)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels, pre_sliced)

    def install_monitor(self, mon):
        for mod in self._buckets.values():
            mod.install_monitor(mon)

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """The default bucket's symbol with the current parameters."""
        original_key = self._curr_bucket_key
        self.switch_bucket(self._default_bucket_key, None, None)
        self._curr_module.save_checkpoint(prefix, epoch,
                                          save_optimizer_states)
        self.switch_bucket(original_key, None, None)
