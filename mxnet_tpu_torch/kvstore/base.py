"""KVStore base class and factory (counterpart of
``mxnet_tpu/kvstore/base.py``; reference ``src/kvstore/kvstore.cc:40-72``,
``python/mxnet/kvstore/base.py``).

The contract: int or str keys; ``init`` once per key; ``push`` sums a
value or a list of values, and a list of keys goes through one
``_push_group`` call (the bucketed stores fuse it); ``pull`` copies the
stored value out (a pulled buffer never aliases the store); ``pushpull``
does both; an optimizer or updater set on the store runs at push time on
the merged value into the stored one, else the merged value replaces it;
with 2-bit compression set (``set_gradient_compression``) the merged
value is quantized first.  The stores of this file live in one process:
``rank`` is 0, ``num_workers`` 1, and ``barrier`` waits for the card's
queued work; the dist stores (``kvstore/__init__.py``) span processes.

Optimizer-state sharding (ZeRO, :mod:`.sharded`) runs a bucketed push
as reduce-scatter, a per-position update and all-gather when
:attr:`KVStoreBase.optimizer_state_sharding` is on.  Not ported yet, and
an error rather than a different result: ``row_sparse_pull`` (the
row-sparse arrays, ROADMAP A15).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..base import MXNetError, env
from ..ndarray.ndarray import NDArray

__all__ = ["KVStoreBase", "TestStore", "create", "register"]

_REGISTRY: Dict[str, type] = {}


def register(name):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


def _copy(value: NDArray) -> NDArray:
    """An NDArray that owns a copy of ``value``'s tensor, off any tape."""
    return NDArray(value._data.detach().clone(), value.context)


class KVStoreBase:
    """Key/value bookkeeping; subclasses define ``_reduce``."""

    def __init__(self):
        self._store: Dict[str, NDArray] = {}
        self._updater: Optional[Callable] = None
        self._optimizer = None
        self._compression = None
        # engage the store in a Trainer even with one worker
        self.force_use = False
        # ZeRO optimizer-state sharding (sharded.py): None defers to
        # MXNET_KVSTORE_SHARD at push time; Trainer(...,
        # optimizer_state_sharding=) writes an explicit bool here
        self._shard_optimizer_state: Optional[bool] = None
        self._shard_engine = None

    # ------------------------------------------------------------- identity
    @property
    def type(self) -> str:
        return self._type

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    @staticmethod
    def is_capable(capability: str) -> bool:
        """Capability probe (reference ``kvstore.py:111``)."""
        return capability.lower() in ("optimizer", "dist_sync")

    @property
    def optimizer_state_sharding(self) -> bool:
        """Whether dense batched pushes run the ZeRO scatter→update→gather
        schedule (``kvstore/sharded.py``) instead of the replicated
        reduction and per-key update; ``MXNET_KVSTORE_SHARD`` unless a
        Trainer set it."""
        if self._shard_optimizer_state is None:
            return bool(env.MXNET_KVSTORE_SHARD)
        return bool(self._shard_optimizer_state)

    def _shard_collective(self, what: str, fn):
        """Guard hook for the sharded engine's reduce-scatter and
        all-gather; the dist store runs them under its collective guard."""
        return fn()

    # ------------------------------------------------------------- helpers
    @staticmethod
    def _key(key) -> str:
        return str(key)

    @staticmethod
    def _aslist(x):
        return list(x) if isinstance(x, (list, tuple)) else [x]

    # ------------------------------------------------------------- API
    def broadcast(self, key, value, out, priority=0):
        """Init ``key`` from ``value`` (rank 0's replica when it is a
        list) unless it is set, and copy the stored value into ``out``;
        a list of keys takes one value and one out each."""
        if isinstance(key, (list, tuple)):
            vals, outs = self._aslist(value), self._aslist(out)
            if len(vals) != len(key) or len(outs) != len(key):
                raise MXNetError("mismatched keys/values in kvstore broadcast")
            for k1, v1, o1 in zip(key, vals, outs):
                self._broadcast_one(k1, v1, o1)
        else:
            self._broadcast_one(key, value, out)

    def _broadcast_one(self, key, value, out):
        k = self._key(key)
        if k not in self._store:
            self.init(key, self._aslist(value)[0])
        for o in self._aslist(out):
            o[:] = self._store[k]

    def init(self, key, value):
        keys, values = self._aslist(key), self._aslist(value)
        if len(keys) != len(values):
            raise MXNetError("mismatched keys/values in kvstore init")
        for k, v in zip(keys, values):
            sk = self._key(k)
            if sk in self._store:
                raise MXNetError(f"key {k} already initialized")
            self._store[sk] = _copy(v)

    @staticmethod
    def _priorities(priority, n: int):
        """One priority per key, from an int or a matched list (the
        Trainer's ``priority=-index``, which orders a bucketed flush)."""
        if isinstance(priority, (list, tuple)):
            if len(priority) != n:
                raise MXNetError("mismatched keys/priorities in kvstore push")
            return [int(p) for p in priority]
        return [int(priority)] * n

    def push(self, key, value, priority=0):
        """Push one key's value or value list, or a list of keys with one
        value (or value list) each; each key's values are summed."""
        keys = self._aslist(key)
        if len(keys) == 1:
            groups = [(keys[0], self._aslist(value),
                       self._priorities(priority, 1)[0])]
        else:
            values = self._aslist(value)
            if len(keys) != len(values):
                raise MXNetError("mismatched keys/values in kvstore push")
            groups = [(k, self._aslist(v), p) for k, v, p in zip(
                keys, values, self._priorities(priority, len(keys)))]
        self._push_group(groups)

    def _push_group(self, groups):
        """One call per ``push``, every key of it at once: here the
        per-key loop; the device and dist stores bucket it."""
        for k, vals, prio in groups:
            self._push_one(k, vals, prio)

    def _push_one(self, key, vals: List[NDArray], priority: int):
        sk = self._key(key)
        if sk not in self._store:
            raise MXNetError(f"key {key} has not been initialized")
        self._apply_merged(key, sk, self._reduce(vals))

    def pull(self, key, out=None, priority: int = 0, ignore_sparse: bool = True):
        """Copy each key's stored value into its ``out`` (onto its device,
        in its dtype), or return copies when ``out`` is None; as many outs
        as keys, or several outs for one key."""
        keys = self._aslist(key)
        outs = self._aslist(out) if out is not None else [None] * len(keys)
        if len(keys) == 1 and len(outs) > 1:
            groups = [(keys[0], outs)]
        else:
            if len(keys) != len(outs):
                raise MXNetError("mismatched keys/out in kvstore pull")
            groups = [(k, self._aslist(o)) for k, o in zip(keys, outs)]
        results = []
        for k, os in groups:
            sk = self._key(k)
            if sk not in self._store:
                raise MXNetError(f"key {k} has not been initialized")
            stored = self._store[sk]
            for o in os:
                if o is None:
                    results.append(_copy(stored))
                    continue
                o._set_data(stored._data.detach().to(
                    device=o._data.device, dtype=o._data.dtype, copy=True))
                results.append(o)
        if out is not None:
            return None
        return results[0] if len(results) == 1 else results

    def pushpull(self, key, value, out=None, priority=0):
        """``push`` then ``pull``: a list of keys is one staged push (one
        bucketed flush on the device and dist stores), and the pull reads
        the store with no collective."""
        self.push(key, value, priority)
        return self.pull(key, out=out,
                         priority=priority if isinstance(priority, int) else 0)

    def row_sparse_pull(self, key, out=None, priority: int = 0, row_ids=None):
        raise MXNetError("kvstore row_sparse_pull: row-sparse arrays are not "
                         "ported yet (ROADMAP A15)")

    # ------------------------------------------------------------- updater
    def set_optimizer(self, optimizer):
        from .. import optimizer as opt
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def _set_updater(self, updater):
        self._updater = updater

    def set_gradient_compression(self, compression_params):
        """2-bit compression with error feedback on every merged dense
        value (``{"type": "2bit", "threshold": t}``)."""
        from .gradient_compression import GradientCompression
        self._compression = GradientCompression(**compression_params)

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("no optimizer/updater set on kvstore")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer=dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("no optimizer/updater set on kvstore")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def barrier(self):
        """One process: wait for the work queued on the card."""
        from ..ndarray import waitall
        waitall()

    # ------------------------------------------------------------- subclass hooks
    def _reduce(self, vals: List[NDArray]) -> NDArray:
        raise NotImplementedError

    def _apply_merged(self, key, sk: str, merged: NDArray,
                      compress: bool = True):
        """The compression round trip (unless the caller compressed a
        whole bucket already), then the updater on the merged value into
        the stored one (in place; the original key reaches it, so
        per-index multipliers resolve), else the merged value replaces
        the stored one."""
        if compress and self._compression is not None:
            merged = NDArray(self._compression.roundtrip(
                sk, merged._data.detach()), merged.context)
        if self._updater is not None:
            self._updater(key, merged, self._store[sk])
        else:
            self._store[sk] = _copy(merged)


def create(name: str = "local") -> KVStoreBase:
    """A store by type (reference ``kvstore.cc:40-72``):

    ``'local'``            the pushed values summed pairwise
    ``'device'``/``'nccl'`` the same on the values' card, a multi-key push
                           in buckets
    ``'dist_sync'``/``'dist_device_sync'``/``'dist_tpu_sync'``
                           every rank's push summed with an all-reduce
                           across the processes of ``mx.distributed``
    ``'dist_async'``/``'dist_tpu_async'``
                           pushes applied locally, each key averaged
                           across processes every
                           ``MXNET_ASYNC_SYNC_INTERVAL`` pushes
    ``'teststore'``        the plugin protocol's store
    """
    name = (name or "local").lower()
    cls = _REGISTRY.get(name)
    if cls is None:
        raise MXNetError(f"unknown kvstore type {name!r}; available: "
                         f"{sorted(_REGISTRY)}")
    kv = cls()
    kv._type = name
    return kv


@register("teststore")
class TestStore(KVStoreBase):
    """The store of the ``KVStoreBase`` plugin protocol (reference
    ``kvstore/base.py:248``): ``broadcast`` copies rank 0's value into the
    outs; ``pushpull`` sums the values and writes the sum back."""

    _type = "teststore"

    def _broadcast_one(self, key, value, out):
        v = self._aslist(value)[0]
        for o in self._aslist(out):
            o[:] = v

    def pushpull(self, key, value, out=None, priority=0):
        vals = self._aslist(value)
        reduced = vals[0]
        for v in vals[1:]:
            reduced = reduced + v
        for t in (self._aslist(out) if out is not None else vals):
            t[:] = reduced

    @staticmethod
    def is_capable(capability: str) -> bool:
        return False

    def set_optimizer(self, optimizer):
        raise NotImplementedError

    def save_optimizer_states(self, fname, dump_optimizer=False):
        raise NotImplementedError

    def load_optimizer_states(self, fname):
        raise NotImplementedError
