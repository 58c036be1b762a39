"""Bucketed gradient fusion for a multi-key push (counterpart of
``mxnet_tpu/kvstore/bucketing.py``).

A list-form push of many dense keys is staged into size-capped flat
buckets: each bucket is concatenated once, reduced once and split back
per key, so a step issues O(buckets) reductions instead of O(keys)
(Horovod's tensor fusion; PyTorch DDP's gradient buckets).

* buckets group by ``(dtype, replica count)``: a concatenation cannot mix
  dtypes, and each replica slot is a flat buffer of its own;
* a bucket closes when the next key would take it past
  ``MXNET_KVSTORE_BUCKET_KB`` (a key larger than the cap fills a bucket
  alone), and again the moment it reaches the cap;
* with ``MXNET_KVSTORE_OVERLAP`` a bucket closed at the cap is issued at
  once, while later keys are still being staged (a store's reduction may
  return a :class:`~mxnet_tpu_torch.parallel.collectives.PendingReduce`,
  an all-reduce in flight, which :meth:`GradientBucketer.flush` waits
  for); the other buckets are issued at :meth:`~GradientBucketer.flush`,
  highest priority first (the reference's ``priority=-index``);
* every reduction is elementwise, so the results equal the per-key path
  bit for bit.

Gradient compression runs once per bucket, over the reduced flat buffer,
with the residual keyed by the bucket's layout.  ``staged`` and
``issued`` count the keys staged and the buckets issued since the
bucketer was made.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..base import env

__all__ = ["GradientBucketer", "bucket_capacity_bytes",
           "partition_bucket_indices"]


def bucket_capacity_bytes() -> int:
    """The bucket cap in bytes; 0 turns fusion off."""
    return max(int(env.MXNET_KVSTORE_BUCKET_KB), 0) * 1024


def partition_bucket_indices(nbytes_list: Sequence[int],
                             dtypes: Sequence[str],
                             capacity_bytes: int) -> List[List[int]]:
    """The packing :class:`GradientBucketer` does, as index lists: in
    order within a dtype group, a bucket closing when the next entry would
    pass the cap (``capacity_bytes`` 0: one bucket per dtype)."""
    open_by_dtype: Dict[str, Optional[List[int]]] = {}
    open_bytes: Dict[str, int] = {}
    out: List[List[int]] = []
    for i, (nb, dt) in enumerate(zip(nbytes_list, dtypes)):
        bucket = open_by_dtype.get(dt)
        if bucket is not None and capacity_bytes > 0 and \
                open_bytes[dt] + nb > capacity_bytes:
            bucket = None
        if bucket is None:
            bucket = []
            out.append(bucket)
            open_by_dtype[dt] = bucket
            open_bytes[dt] = 0
        bucket.append(i)
        open_bytes[dt] += nb
        if capacity_bytes > 0 and open_bytes[dt] >= capacity_bytes:
            open_by_dtype[dt] = None
    return out


class _Entry:
    __slots__ = ("key", "sk", "shape", "size", "offset", "priority")

    def __init__(self, key, sk, shape, size, offset, priority):
        self.key, self.sk, self.shape = key, sk, shape
        self.size, self.offset, self.priority = size, offset, priority


class _Bucket:
    __slots__ = ("group", "entries", "slots", "nbytes", "priority", "result")

    def __init__(self, group: Tuple[str, int]):
        self.group = group                      # (dtype, replica count)
        self.entries: List[_Entry] = []
        self.slots: List[List[torch.Tensor]] = [[] for _ in range(group[1])]
        self.nbytes = 0
        self.priority: Optional[int] = None
        self.result = None                      # reduced flat buffer

    def signature(self) -> tuple:
        """The layout: the compression residual's key (the same keys in
        the same order carry their residual from step to step)."""
        return (self.group,) + tuple((e.sk, e.shape) for e in self.entries)


def _resolve(result):
    return result.wait() if hasattr(result, "wait") else result


class GradientBucketer:
    """Stage dense per-key values; issue one reduction per bucket.

    ``reduce_fn(flats, desc)`` takes one flat buffer per replica slot and
    a description, and returns the reduced flat buffer (or a pending one
    with ``wait()``).  ``capacity_bytes`` and ``overlap`` default to
    ``MXNET_KVSTORE_BUCKET_KB`` and ``MXNET_KVSTORE_OVERLAP``;
    ``compress_fn(signature, flat)`` compresses a reduced bucket."""

    def __init__(self, reduce_fn: Callable,
                 capacity_bytes: Optional[int] = None,
                 overlap: Optional[bool] = None,
                 compress_fn: Optional[Callable] = None):
        self._reduce = reduce_fn
        self._cap = (bucket_capacity_bytes() if capacity_bytes is None
                     else int(capacity_bytes))
        self._overlap = (bool(env.MXNET_KVSTORE_OVERLAP) if overlap is None
                         else bool(overlap))
        self._compress = compress_fn
        self._open: Dict[Tuple[str, int], _Bucket] = {}
        self._closed: List[_Bucket] = []
        self.staged = 0
        self.issued = 0

    def stage(self, key, sk: str, raws: Sequence[torch.Tensor],
              priority: int = 0) -> None:
        """Add one key's per-replica tensors (one shape and dtype)."""
        a = raws[0]
        group = (str(a.dtype).replace("torch.", ""), len(raws))
        # the cap bounds one slot's buffer: what one collective moves
        entry_bytes = a.numel() * a.element_size()
        bucket = self._open.get(group)
        if (bucket is not None and self._cap > 0 and bucket.entries
                and bucket.nbytes + entry_bytes > self._cap):
            self._close(bucket, "capacity")
            bucket = None
        if bucket is None:
            bucket = self._open[group] = _Bucket(group)
        offset = sum(e.size for e in bucket.entries)
        bucket.entries.append(_Entry(key, sk, tuple(a.shape), a.numel(),
                                     offset, priority))
        bucket.nbytes += entry_bytes
        bucket.priority = (priority if bucket.priority is None
                           else max(bucket.priority, priority))
        for slot, r in zip(bucket.slots, raws):
            slot.append(r.detach().reshape(-1))
        self.staged += 1
        if self._cap > 0 and bucket.nbytes >= self._cap:
            self._close(bucket, "capacity")

    def _close(self, bucket: _Bucket, trigger: str) -> None:
        self._open.pop(bucket.group, None)
        self._closed.append(bucket)
        if self._overlap and trigger == "capacity":
            self._issue(bucket)

    def _issue(self, bucket: _Bucket) -> None:
        flats = [s[0] if len(s) == 1 else torch.cat(s) for s in bucket.slots]
        desc = (f"bucket={len(bucket.entries)}keys/"
                f"{bucket.nbytes}B/{bucket.group[0]}")
        result = self._reduce(flats, desc)
        if self._compress is not None:
            result = self._compress(bucket.signature(), _resolve(result))
        bucket.result = result
        self.issued += 1

    def flush_buckets(self) -> List[_Bucket]:
        """Issue every bucket not yet issued (highest priority first),
        wait for every reduction, and return the buckets in close order,
        ``.result`` reduced and ``.entries`` the layout, without splitting
        them per key.  The bucketer is then empty for the next step."""
        for bucket in list(self._open.values()):
            self._close(bucket, "flush")
        pending = [b for b in self._closed if b.result is None]
        pending.sort(key=lambda b: (b.priority or 0), reverse=True)
        for bucket in pending:
            self._issue(bucket)
        out = self._closed
        for bucket in out:
            bucket.result = _resolve(bucket.result)
        self._open.clear()
        self._closed = []
        return out

    def flush(self) -> List[Tuple[object, str, torch.Tensor]]:
        """:meth:`flush_buckets`, split back per key: ``[(key, sk,
        merged)]`` grouped by bucket in close order (dtype groups may
        interleave), so match results by key, not by position."""
        out = []
        for bucket in self.flush_buckets():
            flat = bucket.result
            for e in bucket.entries:
                out.append((e.key, e.sk,
                            flat[e.offset:e.offset + e.size].reshape(e.shape)))
        return out
