"""Checkpoints and the pre-Module ``FeedForward`` (counterpart of
``mxnet_tpu/model.py``; reference ``python/mxnet/model.py:407-456``).

A checkpoint is ``prefix-symbol.json`` and ``prefix-%04d.params``, its
keys ``arg:name`` and ``aux:name``, in the ``.npz`` format both packages
write, so a checkpoint saved by either loads in the other.  Loaded arrays
land on the current context.
"""
from __future__ import annotations

import os
from collections import namedtuple
from typing import Dict

import numpy as _np

from .ndarray import ndarray as _nd
from .ndarray.ndarray import NDArray

__all__ = ["save_checkpoint", "load_checkpoint", "load_params",
           "FeedForward", "BatchEndParam"]

BatchEndParam = namedtuple("BatchEndParam",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def save_checkpoint(prefix: str, epoch: int, symbol,
                    arg_params: Dict[str, NDArray],
                    aux_params: Dict[str, NDArray],
                    remove_amp_cast: bool = True):
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    save_dict = {f"arg:{k}": v for k, v in (arg_params or {}).items()}
    save_dict.update({f"aux:{k}": v for k, v in (aux_params or {}).items()})
    _nd.save(f"{prefix}-{epoch:04d}.params", save_dict)


def load_checkpoint(prefix: str, epoch: int):
    """``(symbol, arg_params, aux_params)``; the symbol is None when the
    checkpoint has no symbol file."""
    from .symbol import load as sym_load
    symbol = None
    if os.path.exists(f"{prefix}-symbol.json"):
        symbol = sym_load(f"{prefix}-symbol.json")
    arg_params, aux_params = load_params(prefix, epoch)
    return symbol, arg_params, aux_params


def load_params(prefix: str, epoch: int):
    """``(arg_params, aux_params)`` from ``prefix-%04d.params``."""
    loaded = _nd.load(f"{prefix}-{epoch:04d}.params")
    arg_params, aux_params = {}, {}
    for k, v in loaded.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return arg_params, aux_params


class FeedForward:
    """The pre-Module training and prediction wrapper (reference
    ``model.py:486``), over :class:`~mxnet_tpu_torch.module.Module`:
    ``fit``/``predict``/``score``/``save``/``load``/``create`` from numpy
    arrays or a ``DataIter``; the optimizer's keywords are the extra
    keyword arguments."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self._kwargs = kwargs
        self._mod = None

    def _as_iter(self, X, y=None, shuffle=False):
        from .io import DataIter, NDArrayIter
        if isinstance(X, DataIter):
            return X
        return NDArrayIter(X, y, batch_size=self.numpy_batch_size,
                           shuffle=shuffle)

    def _module(self, data_iter):
        from .module import Module
        if self._mod is None:
            def _names(descs):
                return [getattr(d, "name", d[0]) for d in (descs or [])]
            self._mod = Module(self.symbol, context=self.ctx,
                               data_names=_names(data_iter.provide_data),
                               label_names=_names(data_iter.provide_label)
                               or None)
        return self._mod

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        data = self._as_iter(X, y, shuffle=True)
        if isinstance(eval_data, (tuple, list)) and len(eval_data) == 2:
            eval_data = self._as_iter(eval_data[0], eval_data[1])
        mod = self._module(data)
        mod.fit(data, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer,
                optimizer_params=dict(self._kwargs),
                initializer=self.initializer,
                arg_params=self.arg_params, aux_params=self.aux_params,
                begin_epoch=self.begin_epoch,
                num_epoch=self.num_epoch or 1)
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def _bound(self, data, with_label):
        mod = self._module(data)
        if not mod.binded:
            mod.bind(data_shapes=data.provide_data,
                     label_shapes=data.provide_label if with_label else None,
                     for_training=False)
            mod.set_params(self.arg_params or {}, self.aux_params or {},
                           allow_missing=True)
        return mod

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """The outputs as one numpy array; with ``return_data``,
        ``(outputs, data, label)`` with the padding cut."""
        data = self._as_iter(X)
        mod = self._bound(data, with_label=False)
        if reset:
            data.reset()
        if not return_data:
            outs = mod.predict(data, num_batch=num_batch)
            return outs.asnumpy() if hasattr(outs, "asnumpy") else \
                _np.concatenate([o.asnumpy() for o in outs])
        outs, datas, labels = [], [], []
        for i, batch in enumerate(data):
            if num_batch is not None and i >= num_batch:
                break
            mod.forward(batch, is_train=False)
            keep = batch.data[0].shape[0] - getattr(batch, "pad", 0)
            outs.append(mod.get_outputs()[0].asnumpy()[:keep])
            datas.append(batch.data[0].asnumpy()[:keep])
            if batch.label:
                labels.append(batch.label[0].asnumpy()[:keep])
        return (_np.concatenate(outs), _np.concatenate(datas),
                _np.concatenate(labels) if labels else None)

    def score(self, X, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        data = self._as_iter(X)
        mod = self._bound(data, with_label=True)
        if reset:
            data.reset()
        res = mod.score(data, eval_metric, num_batch=num_batch)
        return res[0][1] if res else 0.0

    def save(self, prefix, epoch=None, remove_amp_cast=True):
        save_checkpoint(prefix, epoch if epoch is not None else
                        (self.num_epoch or 0), self.symbol,
                        self.arg_params or {}, self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch, **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model
