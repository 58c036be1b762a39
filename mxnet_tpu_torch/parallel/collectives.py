"""Reductions for the kvstore (counterpart of the part of
``mxnet_tpu/parallel/collectives.py`` that the kvstore uses).

In one process a key's replicas are summed pairwise
(:func:`pairwise_sum`, the reference's ``ElementwiseSum`` order); across
processes a value is summed with ``torch.distributed.all_reduce``
(:func:`cross_process_allreduce`) and rank 0's value is sent to every
rank with ``broadcast`` (:func:`broadcast_from`).  These two are the
collectives gloo also runs on CUDA tensors.  Every reduction here is
elementwise, so reducing a concatenation of keys equals concatenating
their reductions, bit for bit.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from .. import distributed

__all__ = ["pairwise_sum", "allreduce_flat", "cross_process_allreduce",
           "broadcast_from", "PendingReduce"]


def pairwise_sum(raws: Sequence[torch.Tensor]) -> torch.Tensor:
    """Tree-shaped sum of same-shaped tensors, pairs first (reference
    ElementwiseSum, ``src/ndarray/ndarray.cc:1298``)."""
    vals = list(raws)
    while len(vals) > 1:
        nxt = [vals[i] + vals[i + 1] for i in range(0, len(vals) - 1, 2)]
        if len(vals) % 2:
            nxt.append(vals[-1])
        vals = nxt
    return vals[0]


def allreduce_flat(flats: Sequence[torch.Tensor]) -> torch.Tensor:
    """One process: the per-replica flat buffers of a bucket summed
    pairwise into one (the first buffer itself when there is one)."""
    return flats[0] if len(flats) == 1 else pairwise_sum(flats)


class PendingReduce:
    """An all-reduce in flight; :meth:`wait` returns its result."""

    def __init__(self, out: torch.Tensor, work, divisor: int = 0):
        self._out, self._work, self._divisor = out, work, divisor

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
        if self._divisor:
            self._out.div_(self._divisor)
            self._divisor = 0
        return self._out


def cross_process_allreduce(x: torch.Tensor, average: bool = False,
                            async_op: bool = False):
    """``x`` summed (or averaged) over every process of the job, in a new
    tensor (``x`` is left as it was); ``x`` itself in one process.  With
    ``async_op`` the reduction is issued and a :class:`PendingReduce`
    comes back.  A failed collective raises: nothing here carries on
    past it."""
    n = distributed.process_count()
    if n <= 1:
        return PendingReduce(x, None) if async_op else x
    out = x.detach().clone(memory_format=torch.contiguous_format)
    work = dist.all_reduce(out, op=dist.ReduceOp.SUM, async_op=async_op)
    pending = PendingReduce(out, work, n if average else 0)
    return pending if async_op else pending.wait()


def broadcast_from(x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank, in a new tensor (bit for bit,
    where a masked sum would turn -0.0 into 0.0); ``x`` in one process."""
    if distributed.process_count() <= 1:
        return x
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.broadcast(out, src=src)
    return out
