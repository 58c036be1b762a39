"""KVStore: parameter aggregation (counterpart of ``mxnet_tpu/kvstore/``).

=====================  ==============================================
reference              this package
=====================  ==============================================
local                  pairwise tree sum of the pushed values
device / nccl          the same on the values' card; a multi-key dense
                       push reduces in buckets (``bucketing.py``)
dist_sync / dist_      the local sum, then one ``torch.distributed``
device_sync /          all-reduce across processes per key, or per
dist_tpu_sync          bucket for a multi-key push
dist_async /           pushes apply locally; every
dist_tpu_async         ``MXNET_ASYNC_SYNC_INTERVAL`` pushes a key's stored
                       value is averaged across processes
=====================  ==============================================

A push of a value list sums it pairwise (the reference's
``ElementwiseSum`` order) and the store applies its updater or keeps the
sum.  The dist stores take their rank and size from
:mod:`mxnet_tpu_torch.distributed`; with one process they reduce locally,
as the JAX package's do.
"""
from __future__ import annotations

import time
from typing import List

from .. import distributed
from ..base import MXNetError, env
from ..observability import metrics as _metrics
from ..ndarray.ndarray import NDArray
from ..parallel.collectives import (allreduce_flat, broadcast_from,
                                    cross_process_allreduce, pairwise_sum)
from .base import KVStoreBase, TestStore, _copy, create, register

__all__ = ["KVStoreBase", "TestStore", "KVStore", "DeviceKVStore",
           "DistSyncKVStore", "DistAsyncKVStore", "create"]

_M_COLLECTIVES = _metrics.registry().counter(
    "mxnet_tpu_kvstore_collectives_total",
    "Dist-kvstore collective rounds completed, by kind.", labels=("kind",))
_M_COLLECTIVE_SECONDS = _metrics.registry().histogram(
    "mxnet_tpu_kvstore_collective_seconds",
    "Wall time of one bounded dist-kvstore collective round.")


def _tree_sum(vals: List[NDArray]) -> NDArray:
    if len(vals) == 1:
        return _copy(vals[0])
    dev = vals[0]._data.device
    return NDArray(pairwise_sum([v._data.detach().to(dev) for v in vals]),
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
    are summed there.  A push of several dense keys is staged into
    ``MXNET_KVSTORE_BUCKET_KB`` flat buckets (``bucketing.py``): one
    reduction per bucket, results equal to the per-key path bit for bit.
    ``keys_staged`` and ``buckets_issued`` count them."""

    #: dist_async opts out: its push applies locally with no collective
    _fuse_dense_push = True

    def __init__(self):
        super().__init__()
        self.keys_staged = 0
        self.buckets_issued = 0

    def _bucket_stage_raws(self, vals):
        """The tensors one key stages: every replica's value (the bucket
        reduction sums across them)."""
        dev = vals[0]._data.device
        return [v._data.detach().to(dev) for v in vals]

    def _bucket_reduce(self, flats, desc):
        return allreduce_flat(flats)

    def _check_compression_layout(self, groups) -> None:
        """Residuals are keyed by bucket layout, so a new layout on this
        store (another cap, other keys) resets them: a residual of the old
        layout must not carry over where a signature happens to match."""
        if self._compression is None:
            return
        from .bucketing import bucket_capacity_bytes
        layout = (bucket_capacity_bytes(),
                  tuple((self._key(k), tuple(v[0].shape), str(v[0].dtype),
                         len(v)) for k, v, _p in groups))
        if getattr(self, "_comp_layout", None) not in (None, layout):
            self._compression.reset()
        self._comp_layout = layout

    def _push_group(self, groups):
        from .bucketing import GradientBucketer, bucket_capacity_bytes
        if not (self._fuse_dense_push and bucket_capacity_bytes() > 0
                and len(groups) > 1):
            return super()._push_group(groups)
        if self.optimizer_state_sharding:
            raise MXNetError(
                "kvstore: optimizer-state sharding (MXNET_KVSTORE_SHARD, "
                "kvstore/sharded.py) is not ported yet (ROADMAP A11b)")
        for k, _vals, _p in groups:
            if self._key(k) not in self._store:
                raise MXNetError(f"key {k} has not been initialized")
        self._check_compression_layout(groups)
        comp = self._compression
        bucketer = GradientBucketer(
            self._bucket_reduce,
            compress_fn=comp.roundtrip if comp is not None else None)
        contexts = {}
        for k, vals, prio in groups:
            sk = self._key(k)
            contexts[sk] = vals[0].context
            bucketer.stage(k, sk, self._bucket_stage_raws(vals), prio)
        for key, sk, merged in bucketer.flush():
            self._apply_merged(key, sk, NDArray(merged, contexts[sk]),
                               compress=False)
        self.keys_staged += bucketer.staged
        self.buckets_issued += bucketer.issued


@register("dist_sync")
@register("dist_device_sync")
@register("dist_tpu_sync")
class DistSyncKVStore(DeviceKVStore):
    """Synchronous data parallelism across the processes of
    :mod:`mxnet_tpu_torch.distributed` (reference ``kvstore_dist.h``; the
    JAX package's ``DistTPUSyncKVStore``).  The ps-lite push to servers
    and pull back is one all-reduce: after every rank pushes ``v`` every
    rank pulls the sum (``tests/nightly/dist_sync_kvstore.py``).

    ``init`` sends rank 0's value to every rank, so every replica starts
    from the same weights.  A per-key push sums its values locally, then
    all-reduces the sum; a multi-key push stages one local sum per key
    into buckets and all-reduces each bucket once.  ``_rounds_completed``
    counts the collective rounds by kind.  With one process every push
    reduces locally.  Every rank must call the same collectives in the
    same order.  Each round runs under the guard of :meth:`_collective`:
    the ``allreduce`` fault site, ``MXNET_KVSTORE_TIMEOUT`` turning a
    wedged round into :class:`~mxnet_tpu_torch.resilience.RankFailureError`
    (with this rank's progress in the flight recorder's post-mortem), a
    ``kvstore.<kind>`` span, the goodput ``collective`` bucket, and the
    ``mxnet_tpu_kvstore_collectives_total`` / ``_collective_seconds``
    metrics; nothing here carries on past a failed round."""

    def __init__(self):
        super().__init__()
        self._rank = distributed.process_index()
        self._nproc = distributed.process_count()
        self._rounds_completed: dict = {}

    def _collective(self, what: str, fn):
        """Run one collective round under the guard (see the class
        docstring); ``what`` names it (``allreduce(key=3)``), its kind is
        the part before ``(``."""
        from ..observability import goodput as _goodput
        from ..observability import tracing as _tracing
        from ..resilience import (RankFailureError, _flight_notify,
                                  call_with_timeout, maybe_fault)

        def run():
            maybe_fault("allreduce")
            return fn()

        desc = (f"kvstore collective {what} (rank {self._rank}/"
                f"{self._nproc} workers)")
        kind = what.split("(", 1)[0]  # key names stay out of label space

        def rank_failure(m):
            exc = RankFailureError(
                m + "; a peer rank is dead or wedged — every rank must call "
                    "the same collectives in the same order")
            _flight_notify(exc, "allreduce", context={
                "collective": what, "kind": kind,
                "rank": self._rank, "nproc": self._nproc,
                "rounds_completed": dict(self._rounds_completed),
                "optimizer_updates": getattr(self._optimizer, "num_update",
                                             None),
            })
            return exc

        span_name = "kvstore." + kind   # the JAX package's span names
        with _tracing.span(span_name,
                           attrs={"what": what, "rank": self._rank,
                                  "nproc": self._nproc}), \
                _goodput.train().timed("collective"):
            t0 = time.perf_counter()
            out = call_with_timeout(run, float(env.MXNET_KVSTORE_TIMEOUT),
                                    desc, error=rank_failure)
        self._rounds_completed[kind] = self._rounds_completed.get(kind, 0) + 1
        _M_COLLECTIVES.labels(kind=kind).inc()
        _M_COLLECTIVE_SECONDS.observe(time.perf_counter() - t0)
        return out

    def divergence_round(self, named):
        """One cross-rank divergence-checksum round over ``named`` (key ->
        tensor) under the same guard as every collective: every rank must
        call it in the same order.  Returns the
        :func:`~mxnet_tpu_torch.observability.health.divergence_report`
        record (on rank 0 a mismatch names the diverging rank and keys)."""
        from ..observability import health as _health
        return self._collective(
            f"divergence_checksum({len(named)}keys)",
            lambda: _health.divergence_report(named))

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def num_workers(self) -> int:
        return self._nproc

    def init(self, key, value):
        super().init(key, value)
        if self._nproc <= 1:
            return
        for k in self._aslist(key):
            sk = self._key(k)
            stored = self._store[sk]
            self._store[sk] = NDArray(self._collective(
                f"init-broadcast(key={k!r})",
                lambda t=stored._data: broadcast_from(t, 0)), stored.context)

    def _push_one(self, key, vals, priority):
        if self._nproc <= 1:
            return self._collective(
                f"allreduce(key={key!r})",
                lambda: super(DistSyncKVStore, self)._push_one(
                    key, vals, priority))
        sk = self._key(key)
        if sk not in self._store:
            raise MXNetError(f"key {key} has not been initialized")
        local = _tree_sum(vals)
        merged = self._collective(f"allreduce(key={key!r})",
                                  lambda: cross_process_allreduce(local._data))
        self._apply_merged(key, sk, NDArray(merged, local.context))

    def _bucket_stage_raws(self, vals):
        """Across processes each key stages its local sum, and the bucket's
        collective is the cross-process one."""
        if self._nproc > 1:
            return [_tree_sum(vals)._data]
        return super()._bucket_stage_raws(vals)

    def _bucket_reduce(self, flats, desc):
        """One collective per bucket; across processes it is issued
        without waiting, and the bucketer waits for it at its flush."""
        if self._nproc > 1:
            return self._collective(
                f"allreduce({desc})",
                lambda: cross_process_allreduce(flats[0], async_op=True))
        return self._collective(f"allreduce({desc})",
                                lambda: allreduce_flat(flats))

    def barrier(self):
        if self._nproc > 1:
            self._collective("barrier", distributed.barrier)
        else:
            self._collective("barrier", super().barrier)


@register("dist_async")
@register("dist_tpu_async")
class DistAsyncKVStore(DistSyncKVStore):
    """``dist_async`` as periodic averaging (the JAX package's rendering
    of free-running workers): every push applies locally with no
    collective, and every ``MXNET_ASYNC_SYNC_INTERVAL`` pushes of a key
    its stored value is averaged across processes.  ``sync_all`` averages
    every key (before evaluating or saving).  It keeps the sync store's
    rank-0 ``init``; ``pull`` returns this process's replica, which may
    differ from the others' between averaging rounds.  Every rank must
    push each key the same number of times."""

    _fuse_dense_push = False

    def __init__(self):
        super().__init__()
        self._push_counts: dict = {}

    def _push_one(self, key, vals, priority):
        sk = self._key(key)
        if sk not in self._store:
            raise MXNetError(f"key {key} has not been initialized")
        self._apply_merged(key, sk, _tree_sum(vals))
        if self._nproc <= 1:
            return
        n = self._push_counts.get(sk, 0) + 1
        self._push_counts[sk] = n
        if n % max(int(env.MXNET_ASYNC_SYNC_INTERVAL), 1) == 0:
            self._average_key(sk)

    def _average_key(self, sk: str) -> None:
        stored = self._store[sk]
        self._store[sk] = NDArray(self._collective(
            f"average(key={sk!r})",
            lambda: cross_process_allreduce(stored._data, average=True)),
            stored.context)

    def sync_all(self) -> None:
        """Average every key across processes now."""
        if self._nproc > 1:
            for sk in sorted(self._store):
                self._average_key(sk)
