"""Datasets (counterpart of ``mxnet_tpu/gluon/data/dataset.py``, reference
``python/mxnet/gluon/data/dataset.py``).

``shard``, ``sample`` and ``transform`` give lazy views: an item is read
from the base dataset when it is asked for.  ``filter`` and ``take``
materialise their items, as the JAX package's do."""
from __future__ import annotations

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset", "RecordFileDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        return SimpleDataset([self[i] for i in range(len(self))
                              if fn(self[i])])

    def take(self, count):
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])

    def shard(self, num_shards, index):
        """Shard ``index`` of ``num_shards`` even, contiguous shards, the
        first ``len % num_shards`` one item longer."""
        assert 0 <= index < num_shards
        n = len(self)
        base, rem = divmod(n, num_shards)
        start = base * index + min(index, rem)
        end = start + base + (1 if index < rem else 0)
        return _IndexView(self, list(range(start, end)))

    def sample(self, sampler):
        """The items in ``sampler``'s order."""
        return _IndexView(self, list(sampler))

    def transform(self, fn, lazy=True):
        return _LazyTransformDataset(self, fn)

    def transform_first(self, fn, lazy=True):
        def first(*items):
            if len(items) == 1:
                return fn(items[0])
            return (fn(items[0]),) + items[1:]
        return self.transform(first, lazy)


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class ArrayDataset(Dataset):
    """Item i is ``(a[i], b[i], ...)`` of equal-length arrays (one array:
    ``a[i]`` alone)."""

    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        for a in args:
            assert len(a) == self._length, \
                "all arrays must have the same length"
        self._data = list(args)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)

    def __len__(self):
        return self._length


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class RecordFileDataset(Dataset):
    """The raw records of a RecordIO file and its ``.idx``, in the index's
    order."""

    def __init__(self, filename):
        from ...recordio import MXIndexedRecordIO
        idx_file = (filename[:-4] + ".idx" if filename.endswith(".rec")
                    else filename + ".idx")
        self._record = MXIndexedRecordIO(idx_file, filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)


class _IndexView(Dataset):
    """The base dataset's items at ``indices``, read on demand."""

    def __init__(self, base, indices):
        self._base = base
        self._indices = indices

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, idx):
        return self._base[self._indices[idx]]
