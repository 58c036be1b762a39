"""gluon.contrib.data (counterpart of ``mxnet_tpu/gluon/contrib/data.py``,
reference ``python/mxnet/gluon/contrib/data/sampler.py``)."""
from __future__ import annotations

from ..data.sampler import Sampler

__all__ = ["IntervalSampler"]


class IntervalSampler(Sampler):
    """``i, i + interval, i + 2·interval, ...`` for each start ``i`` below
    ``interval``; with ``rollover`` every index appears once, without it
    only the run from 0."""

    def __init__(self, length: int, interval: int, rollover: bool = True):
        if interval > length:
            raise ValueError(f"interval {interval} > length {length}")
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        starts = range(self._interval) if self._rollover else [0]
        for start in starts:
            yield from range(start, self._length, self._interval)

    def __len__(self):
        if self._rollover:
            return self._length
        return len(range(0, self._length, self._interval))
