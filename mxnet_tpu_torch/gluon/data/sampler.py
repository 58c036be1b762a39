"""Samplers (counterpart of ``mxnet_tpu/gluon/data/sampler.py``, reference
``python/mxnet/gluon/data/sampler.py``).

``RandomSampler`` draws each epoch's order from the generator it is given,
a ``numpy.random.RandomState`` or a ``torch.Generator``; without one, from
numpy's global generator, as the JAX package does."""
from __future__ import annotations

import numpy as _np
import torch

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "FilterSampler"]


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """A fresh permutation of ``range(length)`` per epoch."""

    def __init__(self, length, generator=None):
        self._length = length
        self._generator = generator

    def __iter__(self):
        g = self._generator
        if isinstance(g, torch.Generator):
            idx = torch.randperm(self._length, generator=g).tolist()
        else:
            idx = (g or _np.random).permutation(self._length).tolist()
        return iter(idx)

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """Lists of ``batch_size`` indices; the last, shorter list is kept
    (``'keep'``), dropped (``'discard'``) or carried into the next epoch
    (``'rollover'``)."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "discard":
                return
            elif self._last_batch == "rollover":
                self._prev = batch
            else:
                raise ValueError(f"invalid last_batch {self._last_batch}")

    def __len__(self):
        if self._last_batch == "keep":
            return ((len(self._sampler) + self._batch_size - 1)
                    // self._batch_size)
        if self._last_batch == "discard":
            return len(self._sampler) // self._batch_size
        if self._last_batch == "rollover":
            return (len(self._prev) + len(self._sampler)) // self._batch_size
        raise ValueError(f"invalid last_batch {self._last_batch}")


class FilterSampler(Sampler):
    """The indices of the items for which ``fn(item)`` is true (reference
    ``sampler.py:77``)."""

    def __init__(self, fn, dataset):
        self._fn = fn
        self._dataset = dataset
        self._indices = [i for i in range(len(dataset)) if fn(dataset[i])]

    def __iter__(self):
        return iter(self._indices)

    def __len__(self):
        return len(self._indices)
