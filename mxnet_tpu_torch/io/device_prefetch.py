"""Input prefetch onto the card: the host-to-device half of the pipelined
training loop (counterpart of ``mxnet_tpu/io/device_prefetch.py``).

Without it the step loop pays the copy of each batch to the card on its
critical path.  :class:`DevicePrefetchIter` assembles host batches on a
background thread (the :class:`~.io._PrefetchLoop` machinery that
``PrefetchingIter`` uses) and stages each one onto the card at once, so
the copies of batches n+1..n+Q overlap the step of batch n.  Up to
``queue_size`` (``MXNET_IO_DEVICE_QUEUE``) staged batches wait ahead of
the consumer.

How a batch crosses, on a CUDA context:

* each host leaf is copied into a pinned host buffer taken from a small
  ring, ``queue_size + 1`` buffers per leaf shape and dtype, allocated
  once; a buffer is reused only after the event of its last copy has
  completed (pinning 154 MB per ResNet-50 batch anew would cost more than
  the copy);
* from there it goes to the card with ``non_blocking=True`` on a side
  CUDA stream that the producer thread owns; the batch enters the queue
  with that stream's event;
* the consumer's current stream waits on the event before the batch is
  handed out, and each device tensor gets ``record_stream`` on the
  consumer's stream, so the caching allocator cannot give its memory back
  to the side stream while the step still reads it.

On a CPU context the copy is a no-op and the leaves pass through.

Over a device mesh (``mesh=``, by default the mesh entered on the
constructing thread) each batch is staged on the device of the mesh's
first ``data_axis`` position: on one card, one copy on the card, which a
meshed ``CompiledTrainStep`` splits over the positions itself (the port's
step takes its batch in global view).  :meth:`DevicePrefetchIter.reshard`
retargets the staging at another mesh (an elastic reformation), from the
next staged batch on; ``staged_by_dp`` counts the batches staged per
``dp`` size.

Starvation is telemetry: a ``next()`` that finds the queue empty while
the producer runs is a starved step (``mxnet_tpu_io_starved_steps_total``),
the queue depth is ``mxnet_tpu_io_device_queue_depth``, and
:meth:`DevicePrefetchIter.stats` splits the consumer's wall time into the
wait for batches and everything else, and reports the ring's pinned
bytes.  The wait also goes to the train goodput ledger's ``input_wait``.
"""
from __future__ import annotations

import itertools
import time
from typing import Any, Dict, List, Optional

import numpy as _np
import torch

from ..base import MXNetError, env as _env, narrow_source
from ..context import Context, gpu
from ..ndarray.ndarray import NDArray
from ..observability import (goodput as _goodput, memory as _memory,
                             metrics as _metrics, tracing as _tracing)
from .io import (DataBatch, DataIter, _M_PREFETCHED, _M_PREFETCH_SECONDS,
                 _PrefetchLoop)

__all__ = ["DevicePrefetchIter"]

_M_STARVED = _metrics.registry().counter(
    "mxnet_tpu_io_starved_steps_total",
    "Consumer steps that found the device-prefetch queue empty while the "
    "producer was still running (input pipeline behind compute).")
_M_QUEUE_DEPTH = _metrics.registry().gauge(
    "mxnet_tpu_io_device_queue_depth",
    "Device-staged batches currently queued ahead of the training loop "
    "(sampled at every DevicePrefetchIter put/get).")
_M_DEVICE_PUT_SECONDS = _metrics.registry().histogram(
    "mxnet_tpu_io_device_put_seconds",
    "Host-side time of staging one batch onto the card (the copy into the "
    "pinned ring and the dispatch of the asynchronous copy).")

_PF_IDS = itertools.count(1)  # per-instance memory-ledger components


class _PinnedRing:
    """``slots`` pinned host buffers per (shape, dtype), handed out in turn;
    a buffer waits for the event of its last copy before it is reused.
    Used by the producer thread only."""

    def __init__(self, slots: int):
        self._slots = slots
        self._bufs: Dict[tuple, Dict[str, Any]] = {}

    def take(self, shape, dtype) -> List:
        entry = self._bufs.setdefault((tuple(shape), dtype),
                                      {"next": 0, "slots": []})
        if len(entry["slots"]) < self._slots:
            slot = [torch.empty(shape, dtype=dtype, pin_memory=True), None]
            entry["slots"].append(slot)
            return slot
        slot = entry["slots"][entry["next"]]
        entry["next"] = (entry["next"] + 1) % self._slots
        if slot[1] is not None:
            slot[1].synchronize()
        return slot

    @property
    def nbytes(self) -> int:
        return sum(s[0].numel() * s[0].element_size()
                   for e in self._bufs.values() for s in e["slots"])


def _tree_nbytes(value) -> int:
    """Array bytes in a batch tree (NDArray, tensor, tuple/list)."""
    if isinstance(value, (tuple, list)):
        return sum(_tree_nbytes(v) for v in value)
    if isinstance(value, NDArray):
        value = value._data
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    return int(getattr(value, "nbytes", 0) or 0)


def _tree_tensors(value, out: List[torch.Tensor]) -> List[torch.Tensor]:
    if isinstance(value, (tuple, list)):
        for v in value:
            _tree_tensors(v, out)
    elif isinstance(value, NDArray):
        out.append(value._data)
    elif isinstance(value, torch.Tensor):
        out.append(value)
    return out


class DevicePrefetchIter(DataIter):
    """Wrap a ``DataIter``, a ``DataLoader`` or any re-iterable of batches
    and stage its batches onto ``ctx`` from a background thread.

    Parameters
    ----------
    source : ``DataIter`` (driven through ``next()``/``reset()``), or any
        iterable (a fresh ``iter()`` per epoch).  Batches are
        ``DataBatch`` objects or ``(data, label)`` tuples; their array
        leaves (``NDArray``, tensors, numpy arrays) are staged, anything
        else passes through.
    queue_size : int, default ``env.MXNET_IO_DEVICE_QUEUE`` (2).  Batches
        staged ahead of the consumer; each holds its device memory, so this
        bounds what the input pipeline keeps on the card.
    ctx : the context to stage to, ``mx.gpu(0)`` by default; ``mx.cpu()``
        makes the copy a no-op.
    mesh, data_axis : a :class:`~mxnet_tpu_torch.parallel.DeviceMesh` to
        stage each batch over (default: the mesh entered on the
        constructing thread; the producer thread has none of its own),
        and the axis the batch dimension splits over.  A mesh's devices
        take the place of ``ctx``.
    """

    def __init__(self, source, queue_size: Optional[int] = None, mesh=None,
                 data_axis: str = "dp", ctx: Optional[Context] = None):
        super().__init__(getattr(source, "batch_size", 0))
        if mesh is None:
            from ..parallel.mesh import current_mesh
            mesh = current_mesh()
        self._mesh = mesh
        self._data_axis = data_axis
        self.staged_by_dp: Dict[int, int] = {}
        if queue_size is None:
            queue_size = int(_env.MXNET_IO_DEVICE_QUEUE)
        if queue_size < 1:
            raise MXNetError(
                f"DevicePrefetchIter needs queue_size >= 1, got {queue_size}")
        if mesh is not None:
            ctx = Context.of(mesh.devices[0])
        self._ctx = ctx if ctx is not None else gpu(0)
        self._device = self._ctx.torch_device()
        self._stream = None
        if self._device.type == "cuda":
            # initialise CUDA on this thread before the producer thread
            # uses its side stream
            torch.cuda.init()
            self._stream = torch.cuda.Stream(device=self._device)
        self._ring = _PinnedRing(queue_size + 1)
        self._source = source
        self._is_dataiter = isinstance(source, DataIter) or (
            hasattr(source, "next") and hasattr(source, "reset"))
        self._epoch_iter = None if self._is_dataiter else iter(source)
        # iter(gen) is gen: a one-shot source cannot restart, so reset()
        # must not drain and re-iterate it (that would lose the staged head)
        self._one_shot = self._epoch_iter is source
        self.current_batch: Optional[Any] = None
        # starvation accounting (consumer side)
        self._batches = 0
        self._since_reset = 0
        self._starved = 0
        self._wait_seconds = 0.0
        self._compute_seconds = 0.0
        self._last_return: Optional[float] = None
        self._batch_nbytes = 0  # bytes of the last staged batch (producer)
        self._loop = _PrefetchLoop(self._produce, queue_size)
        self._loop.start()
        # staged batches hold device memory: queue depth x batch bytes in
        # the memory ledger, one component per instance (a train and a
        # validation iterator must not overwrite each other)
        _memory.ledger().register_object(
            f"io:device_prefetch:{next(_PF_IDS)}", self,
            lambda it: it._loop.qsize() * it._batch_nbytes)

    # -- producer thread -------------------------------------------------
    def _next_host_batch(self):
        if self._is_dataiter:
            return self._source.next()          # StopIteration at the end
        return next(self._epoch_iter)

    def _stage_tensor(self, t: torch.Tensor) -> torch.Tensor:
        device = self._batch_device
        if self._stream is None or t.device.type == "cuda":
            return t.to(device, non_blocking=True)
        slot = self._ring.take(t.shape, t.dtype)
        slot[0].copy_(t)
        dev = torch.empty(t.shape, dtype=t.dtype, device=device)
        dev.copy_(slot[0], non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record(self._stream)
        return dev

    def _stage(self, value):
        """Each array leaf of a batch tree on the context, structure kept."""
        if isinstance(value, (tuple, list)):
            return type(value)(self._stage(v) for v in value)
        if isinstance(value, NDArray):
            return NDArray(self._stage_tensor(value._data), self._ctx)
        if isinstance(value, torch.Tensor):
            return self._stage_tensor(value)
        if isinstance(value, _np.ndarray):
            return self._stage_tensor(torch.from_numpy(
                narrow_source(_np.ascontiguousarray(value))))
        return value

    def _stage_batch(self, batch):
        mesh = self._mesh  # one read per batch: reshard may swap it
        self._batch_device = self._device
        if mesh is not None:
            from ..kvstore.sharded import axis_devices
            self._batch_device = axis_devices(mesh, self._data_axis)[0]
            dp = mesh.axis_size(self._data_axis)
            self.staged_by_dp[dp] = self.staged_by_dp.get(dp, 0) + 1
        if isinstance(batch, DataBatch):
            batch.data = self._stage(batch.data)
            batch.label = self._stage(batch.label)
            return batch
        return self._stage(batch)

    def _produce(self):
        t0 = time.perf_counter()
        with _tracing.span("io.prefetch"):
            batch = self._next_host_batch()     # StopIteration ends the epoch
        _M_PREFETCHED.inc()
        _M_PREFETCH_SECONDS.observe(time.perf_counter() - t0)
        t1 = time.perf_counter()
        event = None
        with _tracing.span("io.device_put",
                           attrs={"queue_depth": self._loop.qsize()}):
            if self._stream is None:
                batch = self._stage_batch(batch)
            else:
                with torch.cuda.device(self._device), \
                        torch.cuda.stream(self._stream):
                    batch = self._stage_batch(batch)
                    event = torch.cuda.Event()
                    event.record(self._stream)
        _M_DEVICE_PUT_SECONDS.observe(time.perf_counter() - t1)
        self._batch_nbytes = _tree_nbytes(
            (batch.data, batch.label) if isinstance(batch, DataBatch)
            else batch)
        _M_QUEUE_DEPTH.set(self._loop.qsize() + 1)  # about to be queued
        return batch, event

    # -- consumer side ---------------------------------------------------
    def _receive(self, item):
        """Order the consumer's stream after the batch's copies and tie
        each device tensor's memory to that stream."""
        batch, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            tree = ((batch.data, batch.label) if isinstance(batch, DataBatch)
                    else batch)
            for t in _tree_tensors(tree, []):
                if t.device.type == "cuda":
                    t.record_stream(consumer)
        return batch

    def iter_next(self) -> bool:
        t0 = time.perf_counter()
        if self._last_return is not None:
            self._compute_seconds += t0 - self._last_return
        starved = self._loop.empty()
        item = self._loop.get()
        _M_QUEUE_DEPTH.set(self._loop.qsize())
        self._last_return = time.perf_counter()
        wait = self._last_return - t0
        self._wait_seconds += wait
        # time blocked on the staged queue is input wait on the training
        # loop's critical path: the goodput ledger's input_wait bucket
        _goodput.train().attribute("input_wait", wait)
        if item is None:
            self.current_batch = None
            return False
        self.current_batch = self._receive(item)
        self._batches += 1
        self._since_reset += 1
        if starved:
            # the loop outran host assembly and staging: this step paid
            # input latency (an epoch's first batch counts: a cold pipeline)
            self._starved += 1
            _M_STARVED.inc()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def __next__(self):
        return self.next()

    def __iter__(self):
        return self

    def reset(self):
        """Drain, then restart: no staged batch of the previous epoch is
        handed out after a reset (as ``PrefetchingIter``).

        A one-shot source (a generator) cannot restart: a reset before any
        batch was taken is a no-op (the staged queue is the stream's head),
        and a reset after that raises.  For every source, a reset with
        nothing taken since construction or the last reset is a no-op while
        the producer is healthy, so wrap a fresh source: staging starts at
        construction, and a first reset does not rewind a source that was
        already mid-epoch."""
        if self._one_shot:
            if self._batches == 0:
                return
            raise MXNetError(
                "DevicePrefetchIter wraps a one-shot iterator (e.g. a "
                "generator) and cannot be reset for another epoch; pass a "
                "re-iterable (list, DataLoader) or a resettable DataIter")
        if self._since_reset == 0 and not self._loop.done:
            return
        self._loop.drain()
        if self._is_dataiter:
            self._source.reset()
        else:
            self._epoch_iter = iter(self._source)
        self._last_return = None
        self._since_reset = 0
        _M_QUEUE_DEPTH.set(0)
        self._loop.start()

    @property
    def mesh(self):
        """The mesh batches are staged for (None: ``ctx``)."""
        return self._mesh

    def reshard(self, mesh) -> None:
        """Retarget the staging at ``mesh`` (an elastic reformation):
        batches staged from here on follow it; batches already staged keep
        their placement, which a meshed step splits again itself, so
        nothing staged is thrown away when the world shrinks.  One
        reference write, which the producer reads once per batch."""
        self._mesh = mesh

    def close(self):
        """Stop the producer and drop the staged batches (idempotent)."""
        self._loop.drain()
        _M_QUEUE_DEPTH.set(0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        loop = getattr(self, "_loop", None)
        if loop is not None:
            loop.kill()

    # -- DataIter surface -------------------------------------------------
    @property
    def provide_data(self):
        return getattr(self._source, "provide_data", None)

    @property
    def provide_label(self):
        return getattr(self._source, "provide_label", None)

    def getdata(self):
        b = self.current_batch
        return b.data if isinstance(b, DataBatch) else b[0]

    def getlabel(self):
        b = self.current_batch
        return b.label if isinstance(b, DataBatch) else b[1]

    def getpad(self):
        return getattr(self.current_batch, "pad", 0) or 0

    def getindex(self):
        return getattr(self.current_batch, "index", None)

    # -- telemetry --------------------------------------------------------
    def stats(self) -> dict:
        """The consumer's split of wall time (host clock):
        ``wait_seconds`` blocked on the staged queue, ``compute_seconds``
        everything between (the step); with the queue's state and the
        pinned ring's bytes."""
        return {
            "batches": self._batches,
            "starved_steps": self._starved,
            "wait_seconds": round(self._wait_seconds, 6),
            "compute_seconds": round(self._compute_seconds, 6),
            "queue_depth": self._loop.qsize(),
            "queue_capacity": self._loop.capacity,
            "pinned_bytes": self._ring.nbytes,
        }
