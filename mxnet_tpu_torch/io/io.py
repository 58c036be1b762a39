"""The data iterators of the port (counterpart of ``mxnet_tpu/io/io.py``,
reference ``python/mxnet/io/io.py`` and the C++ iterators of ``src/io/``).

``NDArrayIter`` walks arrays held in memory in batches along their first
axis.  Its arrays live on the iterator's context: the context of the first
NDArray or tensor given, else the current context (the card), where numpy
inputs are copied once, with the JAX package's width policy (64-bit
floats become float32).  A batch is gathered there from
the order's indices, so a batch of data already on the card never
crosses to the host.  ``shuffle`` draws the order with
``numpy.random.shuffle``, at construction and at each ``reset``, as the
reference does, so the same numpy seed gives the same batches.  The last
batch is handled as ``last_batch_handle`` says: ``'pad'`` fills it with
the first samples of the order (``pad`` counts them), ``'discard'`` drops
it, ``'roll_over'`` carries the remainder into the next epoch.

The file iterators (``CSVIter``, ``ImageRecordIter`` and its uint8, int8
and detection variants, ``MNISTIter``, ``LibSVMIter``) are host code: they
parse, decode and assemble each batch in numpy and hand it out as a CPU
``NDArray`` (``LibSVMIter`` as a host :class:`CSRBatch`).  Moving a batch
to the card is the consumer's step, or :class:`~.device_prefetch.
DevicePrefetchIter`'s, which overlaps the copy with the step.
``PrefetchingIter`` assembles batches ahead on a background thread;
:class:`_PrefetchLoop` is the drain, kill and restart machinery it shares
with ``DevicePrefetchIter``.
"""
from __future__ import annotations

import os as _os
import queue
import struct as _struct
import threading
import time
from collections import namedtuple
from typing import List, Optional, Tuple

import numpy as _np
import torch

from ..base import MXNetError, narrow_source
from ..context import Context, cpu, current_context
from ..ndarray.ndarray import NDArray, array as _nd_array
from ..observability import metrics as _metrics, tracing as _tracing

_M_PREFETCHED = _metrics.registry().counter(
    "mxnet_tpu_io_prefetch_batches_total",
    "Batches assembled by PrefetchingIter background threads.")
_M_PREFETCH_SECONDS = _metrics.registry().histogram(
    "mxnet_tpu_io_prefetch_seconds",
    "Host-side assembly time of one prefetched batch.")

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "MXDataIter", "CSVIter", "ImageRecordIter",
           "ImageDetRecordIter", "ImageRecordUInt8Iter",
           "ImageRecordInt8Iter", "MNISTIter", "LibSVMIter", "CSRBatch"]


def _host(a) -> NDArray:
    """A CPU NDArray over a freshly assembled numpy batch, without a copy
    (64-bit values narrowed by the JAX package's width policy)."""
    a = narrow_source(_np.ascontiguousarray(a))
    return NDArray(torch.from_numpy(a), cpu())


class DataDesc(namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])):
    """A named shape and dtype."""

    def __new__(cls, name, shape, dtype="float32", layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), dtype, layout)

    @staticmethod
    def get_batch_axis(layout: Optional[str]) -> int:
        return 0 if not layout else layout.find("N")


class DataBatch:
    """One batch: a data list and a label list, with the count of padding
    samples and the samples' indices."""

    def __init__(self, data, label=None, pad=0, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label if label is not None else []
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        shapes = [getattr(d, "shape", None) for d in (self.data or [])]
        lshapes = [getattr(l, "shape", None) for l in (self.label or [])]
        return f"DataBatch: data shapes: {shapes} label shapes: {lshapes}"


class DataIter:
    """The iterator protocol: ``next()`` gives a :class:`DataBatch` until
    ``StopIteration``; ``reset()`` starts again."""

    def __init__(self, batch_size: int = 0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self) -> DataBatch:
        if self.iter_next():
            return DataBatch(self.getdata(), self.getlabel(), self.getpad(),
                             self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self) -> bool:
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return 0


def _named(data, allow_empty: bool, default_name: str) -> List[Tuple]:
    if data is None:
        if not allow_empty:
            raise MXNetError("data cannot be None")
        return []
    if isinstance(data, (_np.ndarray, NDArray, torch.Tensor)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if not allow_empty and len(data) == 0:
            raise MXNetError("data cannot be empty")
        data = {default_name if i == 0 and len(data) == 1
                else f"_{i}_{default_name}": d for i, d in enumerate(data)}
    return list(data.items())


def _ctx_of(pairs) -> Optional[Context]:
    for _, v in pairs:
        if isinstance(v, NDArray):
            return v.context
        if isinstance(v, torch.Tensor):
            return Context.of(v.device)
    return None


class NDArrayIter(DataIter):
    """Batches of in-memory arrays (see the module docstring)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise ValueError(f"last_batch_handle {last_batch_handle!r}: "
                             "'pad', 'discard' or 'roll_over'")
        data = _named(data, allow_empty=False, default_name=data_name)
        label = _named(label, allow_empty=True, default_name=label_name)
        self.ctx = _ctx_of(data + label) or current_context()
        self.data = [(k, self._on_ctx(v)) for k, v in data]
        self.label = [(k, self._on_ctx(v)) for k, v in label]
        self.num_data = self.data[0][1].shape[0]
        if last_batch_handle == "discard":
            self.num_data -= self.num_data % batch_size
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size
        self._shuffled_idx = _np.arange(self.data[0][1].shape[0])
        self._maybe_shuffle()

    def _on_ctx(self, v) -> NDArray:
        if isinstance(v, NDArray):
            v = v._data
        if isinstance(v, torch.Tensor):
            return NDArray(v.detach().to(self.ctx.torch_device()), self.ctx)
        return _nd_array(_np.asarray(v), ctx=self.ctx)

    def _maybe_shuffle(self):
        if self.shuffle:
            _np.random.shuffle(self._shuffled_idx)

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data - self.batch_size:
            self.cursor = (-self.batch_size
                           + (self.cursor % self.num_data) % self.batch_size)
        else:
            self.cursor = -self.batch_size
        self._maybe_shuffle()

    def hard_reset(self):
        """Rewind to the very beginning, ignoring ``roll_over``."""
        self.cursor = -self.batch_size
        self._maybe_shuffle()

    def iter_next(self) -> bool:
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _batch_index(self) -> torch.Tensor:
        lo = self.cursor
        hi = min(self.cursor + self.batch_size, self.num_data)
        idx = self._shuffled_idx[lo:hi]
        if hi - lo < self.batch_size:  # pad by wrapping around the order
            idx = _np.concatenate(
                [idx, self._shuffled_idx[:self.batch_size - (hi - lo)]])
        return torch.as_tensor(idx, device=self.ctx.torch_device())

    def _slice(self, arrs) -> List[NDArray]:
        idx = self._batch_index()
        return [NDArray(v._data.index_select(0, idx), self.ctx)
                for _, v in arrs]

    def getdata(self):
        return self._slice(self.data)

    def getlabel(self):
        return self._slice(self.label)

    def getpad(self) -> int:
        if self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0

    def getindex(self):
        hi = min(self.cursor + self.batch_size, self.num_data)
        return self._shuffled_idx[self.cursor:hi]


class ResizeIter(DataIter):
    """Exactly ``size`` batches per epoch from ``data_iter``, restarting it
    when it runs out (reference ``ResizeIter``)."""

    def __init__(self, data_iter: DataIter, size: int,
                 reset_internal: bool = True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch: Optional[DataBatch] = None

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getpad(self):
        return self.current_batch.pad


class _EndOfEpoch:
    """Queue sentinel: the producer exhausted its source."""


class _ProducerError:
    """Queue sentinel carrying a producer thread's exception to the
    consumer (a producer that died silently would leave it blocked)."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class _PrefetchLoop:
    """A background producer thread feeding a bounded queue, with
    drain-then-restart shutdown: the machinery of :class:`PrefetchingIter`
    and :class:`~.device_prefetch.DevicePrefetchIter`.

    ``produce`` runs on the producer thread and returns one item per call;
    it ends the epoch by raising ``StopIteration``.  Any other exception
    is shipped to the consumer and raised again from :meth:`get`.
    """

    def __init__(self, produce, capacity: int):
        self._produce = produce
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, int(capacity)))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._done = False

    @property
    def done(self) -> bool:
        """The producer reached a terminal state (end of epoch consumed, an
        error delivered, or :meth:`drain`) and :meth:`start` has not run
        since."""
        return self._done

    @property
    def capacity(self) -> int:
        return self._queue.maxsize

    def qsize(self) -> int:
        return self._queue.qsize()

    def empty(self) -> bool:
        return self._queue.empty()

    def start(self) -> None:
        def run():
            while not self._stop.is_set():
                try:
                    item = self._produce()
                except StopIteration:
                    self._queue.put(_EndOfEpoch)
                    return
                except BaseException as e:  # noqa: BLE001 (raised in get)
                    self._queue.put(_ProducerError(e))
                    return
                self._queue.put(item)
        self._done = False
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def get(self):
        """The next item; ``None`` at the end of the epoch; a producer's
        error is raised here.  Never blocks on a terminal producer: after
        the end of the epoch, an error or :meth:`drain` (with no restart),
        it returns ``None``."""
        while True:
            if self._done:
                return None
            try:
                item = self._queue.get(timeout=0.05)
                break
            except queue.Empty:
                t = self._thread
                if t is None or not t.is_alive():
                    # the producer's last put may have landed between the
                    # timeout and this check: look once more
                    try:
                        item = self._queue.get_nowait()
                        break
                    except queue.Empty:
                        return None
        if item is _EndOfEpoch:
            self._done = True
            return None
        if isinstance(item, _ProducerError):
            self._done = True
            raise item.exc
        return item

    def drain(self) -> None:
        """Stop the producer, wait for it to exit, and empty the queue.
        The thread has fully exited before the queue is emptied, so its
        last put has landed and no stale item survives into the next
        epoch."""
        self._stop.set()
        # free a producer blocked on a full queue, then wait for its exit
        while self._thread is not None and self._thread.is_alive():
            try:
                self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._stop.clear()
        self._done = True

    def kill(self) -> None:
        """Finalizer-safe stop: signal the producer and free one queue slot
        so a put blocked on a full queue completes and the thread sees the
        signal.  No join: a finalizer must not stall."""
        self._stop.set()
        try:
            self._queue.get_nowait()
        except Exception:
            pass


class PrefetchingIter(DataIter):
    """Batches of one iterator assembled ahead on a background thread
    (reference ``io.py:347``, ``src/io/iter_prefetcher.h:142``)."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 capacity: int = 2):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        if len(iters) != 1:
            raise MXNetError("PrefetchingIter composes exactly one iterator")
        super().__init__(iters[0].batch_size)
        self._iter = iters[0]
        self._loop = _PrefetchLoop(self._produce, capacity)
        self.current_batch: Optional[DataBatch] = None
        self._loop.start()

    def _produce(self):
        t0 = time.perf_counter()
        # spans from the producer thread land in its own lane of the trace
        with _tracing.span("io.prefetch"):
            batch = self._iter.next()
        _M_PREFETCHED.inc()
        _M_PREFETCH_SECONDS.observe(time.perf_counter() - t0)
        return batch

    @property
    def provide_data(self):
        return self._iter.provide_data

    @property
    def provide_label(self):
        return self._iter.provide_label

    def reset(self):
        self._loop.drain()
        self._iter.reset()
        self._loop.start()

    def iter_next(self):
        batch = self._loop.get()
        self.current_batch = batch
        return batch is not None

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getpad(self):
        return self.current_batch.pad

    def close(self):
        """Stop the producer thread and drop the queued batches."""
        self._loop.drain()

    def __del__(self):
        loop = getattr(self, "_loop", None)
        if loop is not None:
            loop.kill()


class MXDataIter(DataIter):
    """Base of the named file iterators, which the reference implements in
    C++ (reference ``io.py:800``); here they are host Python."""


class _InnerIter(MXDataIter):
    """A file iterator that parses its file into numpy at construction and
    walks it with an ``NDArrayIter`` on the CPU."""

    def _walk(self, data, label, **kwargs):
        self._inner = NDArrayIter(torch.from_numpy(narrow_source(data)),
                                  torch.from_numpy(narrow_source(label)),
                                  **kwargs)

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def iter_next(self):
        return self._inner.iter_next()

    def getdata(self):
        return self._inner.getdata()

    def getlabel(self):
        return self._inner.getlabel()

    def getpad(self):
        return self._inner.getpad()


class CSVIter(_InnerIter):
    """Numeric CSV rows as fixed-shape float32 batches (reference
    ``src/io/iter_csv.cc``)."""

    def __init__(self, data_csv: str, data_shape: Tuple[int, ...],
                 label_csv=None, label_shape: Tuple[int, ...] = (1,),
                 batch_size: int = 1, round_batch: bool = True, **kwargs):
        super().__init__(batch_size)
        data = _np.loadtxt(data_csv, delimiter=",", dtype=_np.float32,
                           ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = _np.loadtxt(label_csv, delimiter=",", dtype=_np.float32,
                                ndmin=2)
            label = label.reshape((-1,) + tuple(label_shape))
            if label.shape[-1] == 1:
                label = label.reshape(label.shape[:-1])
        else:
            label = _np.zeros((data.shape[0],), _np.float32)
        self._walk(data, label, batch_size=batch_size,
                   last_batch_handle="pad" if round_batch else "discard",
                   data_name="data", label_name="label")


class ImageRecordIter(MXDataIter):
    """Batches of images from a RecordIO file, decoded and augmented by a
    pool of threads (reference ``src/io/iter_image_recordio_2.cc``).

    Each batch's records come from one call of the indexed file's
    ``read_batch`` (the native reader, outside the GIL, where it built);
    PIL decodes each record (it releases the GIL), then the crop (random
    with ``rand_crop``, else centred), the mirror (``rand_mirror``) and,
    for float32, ``(x - mean) / std`` run in numpy.  The batch leaves as a
    CPU ``NDArray`` [B, C, H, W].  Each decode thread draws from its own
    ``RandomState`` (``seed`` plus the thread's id); the epoch order from
    one seeded by ``seed``.  ``dtype='uint8'`` keeps raw pixels and
    ``'int8'`` shifts them by -128.  ``part_index``/``num_parts`` take one
    rank's contiguous share of the records.
    """

    def __init__(self, path_imgrec, data_shape, batch_size, path_imgidx=None,
                 label_width=1, shuffle=False, rand_crop=False,
                 rand_mirror=False, resize=-1, mean_r=0.0, mean_g=0.0,
                 mean_b=0.0, std_r=1.0, std_g=1.0, std_b=1.0, part_index=0,
                 num_parts=1, preprocess_threads=4, prefetch_buffer=4,
                 round_batch=True, seed=0, data_name="data",
                 label_name="softmax_label", dtype="float32", **kwargs):
        super().__init__(batch_size)
        from .. import recordio as _rio

        if len(data_shape) != 3:
            raise MXNetError("data_shape must be (channels, height, width)")
        if dtype not in ("float32", "uint8", "int8"):
            raise MXNetError(f"unsupported dtype {dtype!r}")
        self._dtype = dtype
        self._data_shape = tuple(int(d) for d in data_shape)
        self._label_width = label_width
        self._shuffle = shuffle
        self._rand_crop = rand_crop
        self._rand_mirror = rand_mirror
        self._resize = resize
        self._mean = _np.array([mean_r, mean_g, mean_b],
                               _np.float32).reshape(3, 1, 1)
        self._std = _np.array([std_r, std_g, std_b],
                              _np.float32).reshape(3, 1, 1)
        self._round_batch = round_batch
        self._threads = max(1, int(preprocess_threads))
        self._seed = seed
        self._rng = _np.random.RandomState(seed)  # the epoch order
        # each decode thread its own stream: RandomState is not thread-safe
        self._tls = threading.local()
        self._data_name, self._label_name = data_name, label_name

        if path_imgidx is None and path_imgrec.endswith(".rec"):
            cand = path_imgrec[:-4] + ".idx"
            path_imgidx = cand if _os.path.exists(cand) else None
        if path_imgidx:
            self._rec = _rio.MXIndexedRecordIO(path_imgidx, path_imgrec, "r")
            keys = list(self._rec.keys)
        else:
            # no index: scan once for the records' offsets
            self._rec = _rio.MXRecordIO(path_imgrec, "r")
            keys = []
            while True:
                pos = self._rec.tell()
                if self._rec.read() is None:
                    break
                keys.append(pos)
            self._rec.reset()
        shard = len(keys) // num_parts
        self._keys = (keys[part_index * shard:(part_index + 1) * shard]
                      if num_parts > 1 else keys)
        self._lock = threading.Lock()
        self._order = list(self._keys)
        self._pool = None
        self._gen = None
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self._data_shape,
                         _np.dtype(self._dtype))]

    @property
    def provide_label(self):
        shape = ((self.batch_size,) if self._label_width == 1
                 else (self.batch_size, self._label_width))
        return [DataDesc(self._label_name, shape, _np.float32)]

    # -- decode and augment (the pool's threads) -------------------------
    def _worker_rng(self):
        rng = getattr(self._tls, "rng", None)
        if rng is None:
            rng = _np.random.RandomState(
                (self._seed + threading.get_ident()) % (2 ** 31))
            self._tls.rng = rng
        return rng

    def _fetch_raw(self, keys):
        """A batch's record payloads: one native call where the library
        built (``read_batch``), else a read per record."""
        with self._lock:
            if hasattr(self._rec, "read_batch"):
                return self._rec.read_batch(keys)
            out = []
            for k in keys:
                self._rec.record.seek(k)
                out.append(self._rec.read())
            return out

    def _decode_one(self, s):
        from .. import recordio as _rio
        header, img = _rio.unpack_img(s)
        c, h, w = self._data_shape
        if self._resize > 0:
            from PIL import Image
            short = min(img.shape[:2])
            scale = self._resize / short
            nh = int(round(img.shape[0] * scale))
            nw = int(round(img.shape[1] * scale))
            img = _np.asarray(Image.fromarray(img).resize((nw, nh),
                                                          Image.BILINEAR))
        ih, iw = img.shape[:2]
        if ih < h or iw < w:
            from PIL import Image
            img = _np.asarray(Image.fromarray(img).resize(
                (max(w, iw), max(h, ih)), Image.BILINEAR))
            ih, iw = img.shape[:2]
        if self._rand_crop:
            rng = self._worker_rng()
            top = rng.randint(0, ih - h + 1)
            left = rng.randint(0, iw - w + 1)
        else:
            top, left = (ih - h) // 2, (iw - w) // 2
        img = img[top:top + h, left:left + w]
        if self._rand_mirror and self._worker_rng().randint(2):
            img = img[:, ::-1]
        if self._dtype in ("uint8", "int8"):
            chw = img.transpose(2, 0, 1)
            chw = (chw.astype(_np.uint8) if self._dtype == "uint8"
                   else (chw.astype(_np.int16) - 128).astype(_np.int8))
        else:
            chw = img.astype(_np.float32).transpose(2, 0, 1)
            chw = (chw - self._mean) / self._std
        label = (header.label if _np.ndim(header.label)
                 else _np.float32(header.label))
        return chw, label

    def _batches(self):
        try:
            order = list(self._order)
            if self._shuffle:
                self._rng.shuffle(order)
            n = (len(order) // self.batch_size * self.batch_size
                 if self._round_batch else len(order))
            for start in range(0, n, self.batch_size):
                idxs = order[start:start + self.batch_size]
                raws = self._fetch_raw(idxs)
                samples = list(self._pool.map(self._decode_one, raws))
                pad = self.batch_size - len(idxs)
                data = _np.stack([s[0] for s in samples]
                                 + [samples[-1][0]] * pad).astype(
                                     self._dtype, copy=False)
                label = self._assemble_labels(samples, pad)
                yield DataBatch([_host(data)], [_host(label)], pad, None)
        except GeneratorExit:
            # abandoned (reset() replaced it, or collected): the pool
            # stays up for the next epoch
            raise
        except BaseException:
            # a failure mid-epoch joins the decode pool before it
            # propagates; reset() revives the iterator
            self._gen = None
            self._shutdown_pool()
            raise

    def _assemble_labels(self, samples, pad):
        if self._label_width == 1:
            return _np.array([_np.ravel(s[1])[0] for s in samples]
                             + [0.0] * pad, _np.float32)
        return _np.stack([_np.resize(_np.asarray(s[1], _np.float32),
                                     self._label_width) for s in samples]
                         + [_np.zeros(self._label_width, _np.float32)] * pad)

    def reset(self):
        import concurrent.futures as _cf
        if self._pool is None:
            self._pool = _cf.ThreadPoolExecutor(max_workers=self._threads)
        self._gen = iter(self._batches())
        self._current = None

    def _shutdown_pool(self):
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    def close(self):
        """Join and release the decode pool (idempotent); a later
        ``reset()`` revives the iterator with a fresh pool."""
        gen, self._gen = self._gen, None
        if gen is not None:
            gen.close()
        self._shutdown_pool()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def iter_next(self):
        if self._gen is None:
            return False
        try:
            self._current = next(self._gen)
            return True
        except StopIteration:
            self._current = None
            return False

    def next(self):
        if self.iter_next():
            return self._current
        raise StopIteration

    def getdata(self):
        return self._current.data

    def getlabel(self):
        return self._current.label

    def getpad(self):
        return self._current.pad


class ImageRecordUInt8Iter(ImageRecordIter):
    """Raw uint8 pixel batches: decode, crop and mirror, no float
    conversion or normalization (reference ``ImageRecordUInt8Iter``)."""

    def __init__(self, *args, **kwargs):
        kwargs["dtype"] = "uint8"
        super().__init__(*args, **kwargs)


class ImageRecordInt8Iter(ImageRecordIter):
    """uint8 pixels shifted by -128 into int8 (reference
    ``ImageRecordInt8Iter``)."""

    def __init__(self, *args, **kwargs):
        kwargs["dtype"] = "int8"
        super().__init__(*args, **kwargs)


class ImageDetRecordIter(ImageRecordIter):
    """Detection records (reference ``src/io/iter_image_det_recordio.cc``):
    variable-length object labels batched to [B, label_pad_width,
    object_width] with ``label_pad_value`` rows.  A record's flat label is
    ``[header_width, object_width, header extras..., objects...]`` when
    those two lead it plausibly, else headerless object rows."""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 label_pad_width: int = 16, label_pad_value: float = -1.0,
                 object_width: int = 5, **kwargs):
        self._pad_objs = int(label_pad_width)
        self._pad_value = float(label_pad_value)
        self._obj_width = int(object_width)
        kwargs.setdefault("label_name", "label")
        kwargs.pop("label_width", None)  # variable: see _assemble_labels
        super().__init__(path_imgrec, data_shape, batch_size,
                         label_width=2, **kwargs)

    @property
    def provide_label(self):
        return [DataDesc(self._label_name,
                         (self.batch_size, self._pad_objs, self._obj_width),
                         _np.float32)]

    def _assemble_labels(self, samples, pad):
        out = _np.full((self.batch_size, self._pad_objs, self._obj_width),
                       self._pad_value, _np.float32)
        for i, (_, raw) in enumerate(samples):
            flat = _np.ravel(_np.asarray(raw, _np.float32))
            hw, ow = 0, self._obj_width
            if flat.size >= 2:
                h0, o0 = float(flat[0]), float(flat[1])
                if (h0 == int(h0) and o0 == int(o0) and int(h0) >= 2
                        and int(o0) >= 1 and int(h0) <= flat.size
                        and (flat.size - int(h0)) % int(o0) == 0):
                    hw, ow = int(h0), int(o0)
            body = flat[hw:]
            n = min(body.size // ow, self._pad_objs) if ow > 0 else 0
            if n:
                objs = body[:n * ow].reshape(n, ow)[:, :self._obj_width]
                out[i, :n, :objs.shape[1]] = objs
        return out


class MNISTIter(_InnerIter):
    """MNIST idx-ubyte files (gzip or not) as float32 batches in [0, 1]
    (reference ``src/io/iter_mnist.cc``); ``flat`` gives [B, 784], else
    [B, 1, 28, 28]."""

    def __init__(self, image, label, batch_size=128, shuffle=False,
                 flat=False, seed=0, part_index=0, num_parts=1, **kwargs):
        super().__init__(batch_size)
        import gzip

        def _open(p):
            return gzip.open(p, "rb") if p.endswith(".gz") else open(p, "rb")

        with _open(image) as f:
            magic, n, rows, cols = _struct.unpack(">IIII", f.read(16))
            if magic != 2051:
                raise MXNetError(f"bad MNIST image magic {magic}")
            imgs = _np.frombuffer(f.read(n * rows * cols), _np.uint8)
            imgs = imgs.reshape(n, rows, cols).astype(_np.float32) / 255.0
        with _open(label) as f:
            magic, n2 = _struct.unpack(">II", f.read(8))
            if magic != 2049:
                raise MXNetError(f"bad MNIST label magic {magic}")
            labels = _np.frombuffer(f.read(n2), _np.uint8).astype(_np.float32)
        if num_parts > 1:
            shard = n // num_parts
            sl = slice(part_index * shard, (part_index + 1) * shard)
            imgs, labels = imgs[sl], labels[sl]
        data = imgs.reshape(len(imgs), -1) if flat else imgs[:, None, :, :]
        self._walk(data, labels, batch_size=batch_size, shuffle=shuffle,
                   last_batch_handle="discard")


class CSRBatch:
    """A host CSR batch (``data``, ``indices``, ``indptr`` as CPU NDArrays,
    ``shape``): what ``LibSVMIter`` hands out while the port has no sparse
    arrays.  ``tostype("default")``/``todense()`` give the dense NDArray."""

    stype = "csr"

    def __init__(self, data, indices, indptr, shape):
        self.data = _host(data)
        self.indices = _host(indices.astype(_np.int64))
        self.indptr = _host(indptr.astype(_np.int64))
        self.shape = tuple(shape)

    def todense(self) -> NDArray:
        rows = torch.repeat_interleave(
            torch.arange(self.shape[0]), torch.diff(self.indptr._data.long()))
        dense = torch.zeros(self.shape, dtype=self.data._data.dtype)
        dense[rows, self.indices._data.long()] = self.data._data
        return NDArray(dense, cpu())

    def tostype(self, stype: str):
        if stype == "csr":
            return self
        if stype == "default":
            return self.todense()
        raise MXNetError(f"CSRBatch.tostype: {stype!r} (sparse arrays are "
                         "not ported)")

    def asnumpy(self):
        return self.todense().asnumpy()


class LibSVMIter(MXDataIter):
    """libsvm text (``label idx:value ...`` per line) as CSR data batches
    (reference ``src/io/iter_libsvm.cc``); ``label_libsvm`` gives the
    labels from a file of its own."""

    def __init__(self, data_libsvm, data_shape, batch_size=1,
                 label_libsvm=None, label_shape=None, round_batch=True,
                 **kwargs):
        super().__init__(batch_size)
        feat_dim = (int(data_shape[0]) if isinstance(data_shape, (tuple, list))
                    else int(data_shape))
        self._feat_dim = feat_dim
        labels, indptr, indices, values = [], [0], [], []
        with open(data_libsvm) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                for tok in parts[1:]:
                    k, v = tok.split(":")
                    indices.append(int(k))
                    values.append(float(v))
                indptr.append(len(indices))
        if label_libsvm is not None:
            width = int(_np.prod(label_shape)) if label_shape else 1
            rows = []
            with open(label_libsvm) as f:
                for line in f:
                    parts = line.split()
                    if not parts:
                        continue
                    vals = [float(p.split(":")[-1]) for p in parts]
                    rows.append(_np.resize(_np.asarray(vals, _np.float32),
                                           width))
            if len(rows) != len(labels):
                raise MXNetError(f"label_libsvm has {len(rows)} rows but the "
                                 f"data file has {len(labels)}")
            labels = _np.stack(rows) if width > 1 else [r[0] for r in rows]
        self._labels = _np.asarray(labels, _np.float32)
        self._indptr = _np.asarray(indptr, _np.int64)
        self._indices = _np.asarray(indices, _np.int64)
        self._values = _np.asarray(values, _np.float32)
        self._round_batch = round_batch
        self._cursor = 0

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size, self._feat_dim),
                         _np.float32)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) + tuple(self._labels.shape[1:])
        return [DataDesc("softmax_label", shape, _np.float32)]

    def reset(self):
        self._cursor = 0

    def iter_next(self):
        n = len(self._labels)
        limit = (n // self.batch_size * self.batch_size if self._round_batch
                 else n)
        if self._cursor >= limit:
            return False
        lo = self._cursor
        hi = min(lo + self.batch_size, n)
        rows = self._indptr[lo:hi + 1]
        start, stop = rows[0], rows[-1]
        sub_indptr = rows - start
        pad = self.batch_size - (hi - lo)
        if pad:
            sub_indptr = _np.concatenate(
                [sub_indptr, _np.full(pad, sub_indptr[-1], _np.int64)])
        self._data = CSRBatch(self._values[start:stop],
                              self._indices[start:stop], sub_indptr,
                              (self.batch_size, self._feat_dim))
        lbl = self._labels[lo:hi]
        if pad:
            lbl = _np.concatenate(
                [lbl, _np.zeros((pad,) + lbl.shape[1:], _np.float32)])
        self._label = _host(lbl)
        self._pad = pad
        self._cursor = hi
        return True

    def next(self):
        if self.iter_next():
            return DataBatch([self._data], [self._label], self._pad, None)
        raise StopIteration

    def getdata(self):
        return [self._data]

    def getlabel(self):
        return [self._label]

    def getpad(self):
        return self._pad
