"""KVStore base class and factory (counterpart of
``mxnet_tpu/kvstore/base.py``; reference ``src/kvstore/kvstore.cc:40-72``,
``python/mxnet/kvstore/base.py``).

The contract: int or str keys; ``init`` once per key; ``push`` sums a
value or a list of values; ``pull`` copies the stored value out (a pulled
buffer never aliases the store); ``pushpull`` does both; an optimizer or
updater set on the store runs at push time on the merged value into the
stored one, else the merged value replaces it.  Every store here lives in
one process on one device: ``rank`` is 0, ``num_workers`` 1, and
``barrier`` waits for the card's queued work.

Not ported yet, and an error rather than a different result:
``row_sparse_pull`` (the row-sparse arrays, ROADMAP A15) and
``set_gradient_compression`` (ROADMAP A11).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..base import MXNetError
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
        """Capability probe (reference ``kvstore.py:111``): the stores
        here take an optimizer."""
        return capability.lower() == "optimizer"

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

    def push(self, key, value, priority=0):
        """Push one key's value or value list, or a list of keys with one
        value (or value list) each; each key's values are summed."""
        keys = self._aslist(key)
        if len(keys) == 1:
            groups = [(keys[0], self._aslist(value))]
        else:
            values = self._aslist(value)
            if len(keys) != len(values):
                raise MXNetError("mismatched keys/values in kvstore push")
            groups = [(k, self._aslist(v)) for k, v in zip(keys, values)]
        for k, vals in groups:
            sk = self._key(k)
            if sk not in self._store:
                raise MXNetError(f"key {k} has not been initialized")
            self._apply_merged(k, sk, self._reduce(vals))

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
        self.push(key, value)
        return self.pull(key, out=out)

    def row_sparse_pull(self, key, out=None, priority: int = 0, row_ids=None):
        raise MXNetError("kvstore row_sparse_pull: row-sparse arrays are not "
                         "ported yet (ROADMAP A15)")

    # ------------------------------------------------------------- updater
    def set_optimizer(self, optimizer):
        from .. import optimizer as opt
        self._updater = opt.get_updater(optimizer)

    def _set_updater(self, updater):
        self._updater = updater

    def set_gradient_compression(self, compression_params):
        raise MXNetError("kvstore gradient compression is not ported yet "
                         "(ROADMAP A11)")

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

    def _apply_merged(self, key, sk: str, merged: NDArray):
        """The updater on the merged value into the stored one (in place;
        the original key reaches it, so per-index multipliers resolve),
        else the merged value replaces the stored one."""
        if self._updater is not None:
            self._updater(key, merged, self._store[sk])
        else:
            self._store[sk] = _copy(merged)


_DIST = ("dist_sync", "dist_device_sync", "dist_tpu_sync", "dist_async",
         "dist_tpu_async")


def create(name: str = "local") -> KVStoreBase:
    """A store by type: ``'local'``, ``'device'`` (alias ``'nccl'``) or
    ``'teststore'``.  The distributed types raise: they need processes
    across cards and are not ported yet."""
    name = (name or "local").lower()
    if name in _DIST:
        raise MXNetError(f"kvstore {name!r}: the distributed kvstore is not "
                         "ported yet (ROADMAP A11); one process has "
                         "'local' and 'device'")
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
