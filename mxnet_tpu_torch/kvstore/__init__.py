"""KVStore in one process (counterpart of ``mxnet_tpu/kvstore/``).

==================  ==============================================
reference           this package
==================  ==============================================
local               pairwise tree sum of the pushed values
device / nccl       the same, on the values' card
dist_*              not ported yet: ``create`` raises (ROADMAP A11)
==================  ==============================================

With one card there is nothing to exchange: a push of a value list sums
it (the reference's ``ElementwiseSum`` order, pairwise), and the store
applies its updater or keeps the sum.
"""
from __future__ import annotations

from typing import List

from ..ndarray.ndarray import NDArray
from .base import KVStoreBase, TestStore, _copy, create, register

__all__ = ["KVStoreBase", "TestStore", "KVStore", "DeviceKVStore", "create"]


def _pairwise_sum(raws):
    """Tree-shaped sum of same-shaped tensors, pairs first (the loop of
    ``mxnet_tpu/parallel/collectives.py`` ``pairwise_sum``)."""
    vals = list(raws)
    while len(vals) > 1:
        nxt = [vals[i] + vals[i + 1] for i in range(0, len(vals) - 1, 2)]
        if len(vals) % 2:
            nxt.append(vals[-1])
        vals = nxt
    return vals[0]


def _tree_sum(vals: List[NDArray]) -> NDArray:
    if len(vals) == 1:
        return _copy(vals[0])
    dev = vals[0]._data.device
    return NDArray(_pairwise_sum([v._data.detach().to(dev) for v in vals]),
                   vals[0].context)


@register("local")
class KVStore(KVStoreBase):
    """Sums the pushed values on the first value's device."""

    def _reduce(self, vals):
        return _tree_sum(vals)


@register("device")
@register("nccl")
class DeviceKVStore(KVStore):
    """The reference's ``CommDevice``: the values stay on their card and
    are summed there (one card, so no all-reduce)."""
