"""``DataDesc``, ``DataBatch``, ``DataIter`` and ``NDArrayIter``
(counterparts of ``mxnet_tpu/io/io.py``, reference
``python/mxnet/io/io.py``).

``NDArrayIter`` walks arrays held in memory in batches along their first
axis.  Its arrays live on the iterator's context: the context of the first
NDArray or tensor given, else the current context (the card), where numpy
inputs are copied once, with the JAX package's width policy (64-bit
floats become float32).  A batch is gathered there from
the order's indices, so a batch of data already on the card never
crosses to the host.  ``shuffle`` draws the order with
``numpy.random.shuffle``, at construction and at each ``reset``, as the
reference does, so the same numpy seed gives the same batches.  The last
batch is handled as ``last_batch_handle`` says: ``'pad'`` fills it with
the first samples of the order (``pad`` counts them), ``'discard'`` drops
it, ``'roll_over'`` carries the remainder into the next epoch.
"""
from __future__ import annotations

from collections import namedtuple
from typing import List, Optional, Tuple

import numpy as _np
import torch

from ..base import MXNetError
from ..context import Context, current_context
from ..ndarray.ndarray import NDArray, array as _nd_array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])):
    """A named shape and dtype."""

    def __new__(cls, name, shape, dtype="float32", layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), dtype, layout)

    @staticmethod
    def get_batch_axis(layout: Optional[str]) -> int:
        return 0 if not layout else layout.find("N")


class DataBatch:
    """One batch: a data list and a label list, with the count of padding
    samples and the samples' indices."""

    def __init__(self, data, label=None, pad=0, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label if label is not None else []
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        shapes = [getattr(d, "shape", None) for d in (self.data or [])]
        lshapes = [getattr(l, "shape", None) for l in (self.label or [])]
        return f"DataBatch: data shapes: {shapes} label shapes: {lshapes}"


class DataIter:
    """The iterator protocol: ``next()`` gives a :class:`DataBatch` until
    ``StopIteration``; ``reset()`` starts again."""

    def __init__(self, batch_size: int = 0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self) -> DataBatch:
        if self.iter_next():
            return DataBatch(self.getdata(), self.getlabel(), self.getpad(),
                             self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self) -> bool:
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return 0


def _named(data, allow_empty: bool, default_name: str) -> List[Tuple]:
    if data is None:
        if not allow_empty:
            raise MXNetError("data cannot be None")
        return []
    if isinstance(data, (_np.ndarray, NDArray, torch.Tensor)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if not allow_empty and len(data) == 0:
            raise MXNetError("data cannot be empty")
        data = {default_name if i == 0 and len(data) == 1
                else f"_{i}_{default_name}": d for i, d in enumerate(data)}
    return list(data.items())


def _ctx_of(pairs) -> Optional[Context]:
    for _, v in pairs:
        if isinstance(v, NDArray):
            return v.context
        if isinstance(v, torch.Tensor):
            return Context.of(v.device)
    return None


class NDArrayIter(DataIter):
    """Batches of in-memory arrays (see the module docstring)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise ValueError(f"last_batch_handle {last_batch_handle!r}: "
                             "'pad', 'discard' or 'roll_over'")
        data = _named(data, allow_empty=False, default_name=data_name)
        label = _named(label, allow_empty=True, default_name=label_name)
        self.ctx = _ctx_of(data + label) or current_context()
        self.data = [(k, self._on_ctx(v)) for k, v in data]
        self.label = [(k, self._on_ctx(v)) for k, v in label]
        self.num_data = self.data[0][1].shape[0]
        if last_batch_handle == "discard":
            self.num_data -= self.num_data % batch_size
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size
        self._shuffled_idx = _np.arange(self.data[0][1].shape[0])
        self._maybe_shuffle()

    def _on_ctx(self, v) -> NDArray:
        if isinstance(v, NDArray):
            v = v._data
        if isinstance(v, torch.Tensor):
            return NDArray(v.detach().to(self.ctx.torch_device()), self.ctx)
        return _nd_array(_np.asarray(v), ctx=self.ctx)

    def _maybe_shuffle(self):
        if self.shuffle:
            _np.random.shuffle(self._shuffled_idx)

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data - self.batch_size:
            self.cursor = (-self.batch_size
                           + (self.cursor % self.num_data) % self.batch_size)
        else:
            self.cursor = -self.batch_size
        self._maybe_shuffle()

    def hard_reset(self):
        """Rewind to the very beginning, ignoring ``roll_over``."""
        self.cursor = -self.batch_size
        self._maybe_shuffle()

    def iter_next(self) -> bool:
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _batch_index(self) -> torch.Tensor:
        lo = self.cursor
        hi = min(self.cursor + self.batch_size, self.num_data)
        idx = self._shuffled_idx[lo:hi]
        if hi - lo < self.batch_size:  # pad by wrapping around the order
            idx = _np.concatenate(
                [idx, self._shuffled_idx[:self.batch_size - (hi - lo)]])
        return torch.as_tensor(idx, device=self.ctx.torch_device())

    def _slice(self, arrs) -> List[NDArray]:
        idx = self._batch_index()
        return [NDArray(v._data.index_select(0, idx), self.ctx)
                for _, v in arrs]

    def getdata(self):
        return self._slice(self.data)

    def getlabel(self):
        return self._slice(self.label)

    def getpad(self) -> int:
        if self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0

    def getindex(self):
        hi = min(self.cursor + self.batch_size, self.num_data)
        return self._shuffled_idx[self.cursor:hi]
