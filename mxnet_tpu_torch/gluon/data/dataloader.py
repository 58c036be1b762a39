"""DataLoader (counterpart of ``mxnet_tpu/gluon/data/dataloader.py``,
reference ``python/mxnet/gluon/data/dataloader.py:134``).

Batches are host data: ``default_batchify_fn`` stacks samples into CPU
NDArrays (NDArray samples stay where they are), and
``io.DevicePrefetchIter`` stages them onto the card.  Three ways to fetch:

* ``num_workers=0``: in the caller's thread;
* ``num_workers>0`` (``thread_pool=True``, the default): worker threads
  batchify ahead into a bounded queue, handed out in order;
* ``thread_pool=False``: a pool of worker processes, spawned (never
  forked) with ``CUDA_VISIBLE_DEVICES`` empty, so no worker touches the
  card; each ships its batch back as numpy.

``pin_memory=True`` pins each batch's tensors when a card exists (a
CPU-only torch cannot pin).  ``timeout`` bounds the wait for any one
batch.
"""
from __future__ import annotations

import os
import queue
import threading

import numpy as _np
import torch

from ...context import cpu
from ...ndarray import ndarray as _nd
from ...ndarray.ndarray import NDArray
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch: NDArrays with ``stack``, tuples field by
    field, anything else through numpy into a CPU NDArray (float64 as
    float32)."""
    if isinstance(data[0], NDArray):
        return _nd.invoke("stack", [list(data)], {"axis": 0})
    if isinstance(data[0], tuple):
        return tuple(default_batchify_fn(list(x)) for x in zip(*data))
    arr = _np.asarray(data)
    if arr.dtype == _np.float64:
        arr = arr.astype(_np.float32)
    return _nd.array(arr, ctx=cpu())


# -- process workers (module level: they must pickle under spawn) ----------
_WORKER_DATASET = None
_WORKER_BATCHIFY = None


def _mp_worker_init(dataset, batchify_fn):
    global _WORKER_DATASET, _WORKER_BATCHIFY
    _WORKER_DATASET = dataset
    _WORKER_BATCHIFY = batchify_fn


def _mp_worker_fn(batch_idx):
    batch = _WORKER_BATCHIFY([_WORKER_DATASET[i] for i in batch_idx])
    return _tree_map(batch, NDArray, lambda x: x.asnumpy())


def _tree_map(x, kind, fn):
    if isinstance(x, kind):
        return fn(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_map(e, kind, fn) for e in x)
    return x


def _pin(batch):
    return _tree_map(batch, NDArray,
                     lambda a: NDArray(a._data.pin_memory(), a.context)
                     if a._data.device.type == "cpu" else a)


class DataLoader:
    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=True, timeout=120):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size required when batch_sampler is "
                                 "None")
            if sampler is None:
                sampler = (RandomSampler(len(dataset)) if shuffle
                           else SequentialSampler(len(dataset)))
            elif shuffle:
                raise ValueError("shuffle must be False with custom sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch):
            raise ValueError("batch_size/shuffle/sampler/last_batch "
                             "incompatible with batch_sampler")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = max(0, num_workers)
        self._thread_pool = thread_pool
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)
        self._pin = bool(pin_memory) and torch.cuda.is_available()
        self._timeout = timeout

    def __len__(self):
        return len(self._batch_sampler)

    def __iter__(self):
        if self._num_workers == 0:
            batches = (self._batchify_fn([self._dataset[i] for i in idx])
                       for idx in self._batch_sampler)
        elif self._thread_pool:
            batches = self._threaded_iter()
        else:
            batches = self._multiprocess_iter()
        for batch in batches:
            yield _pin(batch) if self._pin else batch

    def _multiprocess_iter(self):
        """A spawned process pool, ``prefetch`` batches in flight."""
        import concurrent.futures as _cf
        import multiprocessing as _mp

        batches = list(self._batch_sampler)
        window = self._prefetch or 2 * self._num_workers
        # the children inherit this at spawn: they cannot see the card
        saved = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        try:
            pool = _cf.ProcessPoolExecutor(
                max_workers=self._num_workers,
                mp_context=_mp.get_context("spawn"),
                initializer=_mp_worker_init,
                initargs=(self._dataset, self._batchify_fn))
            # start every worker now, while the variable is set
            for f in [pool.submit(int, 0) for _ in range(self._num_workers)]:
                f.result(timeout=self._timeout)
        finally:
            if saved is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = saved
        with pool:
            pending = {}
            submitted = min(window, len(batches))
            for i in range(submitted):
                pending[i] = pool.submit(_mp_worker_fn, batches[i])
            for i in range(len(batches)):
                batch_np = pending.pop(i).result(timeout=self._timeout)
                if submitted < len(batches):
                    pending[submitted] = pool.submit(_mp_worker_fn,
                                                     batches[submitted])
                    submitted += 1
                yield _tree_map(batch_np, _np.ndarray,
                                lambda a: _nd.array(a, ctx=cpu()))

    def _threaded_iter(self):
        """Worker threads batchify ahead into a queue of ``prefetch``
        batches; the consumer takes them in order.  Leaving the loop early
        stops and joins the workers."""
        batches = list(self._batch_sampler)
        out_q: "queue.Queue" = queue.Queue(maxsize=self._prefetch or 2)
        task_q: "queue.Queue" = queue.Queue()
        stop = threading.Event()
        for i, b in enumerate(batches):
            task_q.put((i, b))

        def put(item):
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.05)
                    return
                except queue.Full:
                    pass

        def worker():
            while not stop.is_set():
                try:
                    i, idxs = task_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    put((i, self._batchify_fn([self._dataset[j]
                                               for j in idxs])))
                except Exception as e:  # raised by the consumer
                    put((i, e))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self._num_workers)]
        for t in threads:
            t.start()
        try:
            received = {}
            for next_idx in range(len(batches)):
                while next_idx not in received:
                    i, item = out_q.get(timeout=self._timeout)
                    received[i] = item
                item = received.pop(next_idx)
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=self._timeout)
