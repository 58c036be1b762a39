"""Dynamic request batcher over an :class:`~.engine.InferenceEngine`.

Counterpart of ``mxnet_tpu/serving/batcher.py``.  One worker thread
drains a request queue under a ``max_batch`` / ``max_wait_us`` policy:
the first request opens a batch and starts the wait clock; later ones
pack in until the next would overflow ``max_batch`` rows (it is carried
to open the next batch) or the clock runs out.  The batch's rows are
staged in one reusable host buffer per input (padding rows zero), sent to
the card in one copy, run once through the engine's rung, and split back
per request through :class:`concurrent.futures.Future`s.  A batch with
no input spec to stage by, or one request above ``max_batch`` rows (which
the engine chunks), goes to the card request by request instead.  The
host time of each stage (pack, execute, split) goes to the statistics.

Admission control: the queue is bounded (``max_queue`` /
``MXNET_SERVING_MAX_QUEUE``, overload raises :class:`OverloadedError`); a
request may carry a deadline (``deadline_ms`` /
``MXNET_SERVING_DEADLINE_MS``) after which it fails with
:class:`DeadlineExceededError` instead of taking a batch slot; a bad
request is refused at submit, and a batch that fails fails only its own
requests.  ``close()`` refuses new work, drains what was accepted and
joins the worker; ``fail_pending()`` fails what is still queued.  With
``warmup`` the worker runs the engine's ladder once before it takes
requests, so the first batches do not pay for what a thread's first
forward on the card sets up (its cuBLAS and cuDNN handles).  The JAX
package's circuit breaker, tracing spans and goodput accounting are not
ported yet.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional

import torch

from ..base import env
from ..error import DeadlineExceededError, OverloadedError, ServerClosedError
from ..ndarray.ndarray import NDArray
from .hostbuf import HostBufferPool

__all__ = ["DynamicBatcher"]


class _Request:
    __slots__ = ("arrays", "n", "future", "t_enqueue", "deadline")

    def __init__(self, arrays, n, deadline: Optional[float] = None):
        self.arrays = arrays          # host numpy arrays, [n, ...]
        self.n = n
        self.future: Future = Future()
        self.t_enqueue = time.monotonic()
        self.deadline = deadline      # a monotonic instant, or None


class DynamicBatcher:
    def __init__(self, engine, max_batch: Optional[int] = None,
                 max_wait_us: int = 2000, stats=None,
                 name: Optional[str] = None, max_queue: Optional[int] = None,
                 warmup: bool = False):
        self._engine = engine
        self.max_batch = max_batch or engine.max_batch
        self.max_wait_us = int(max_wait_us)
        self.max_queue = int(env.MXNET_SERVING_MAX_QUEUE
                             if max_queue is None else max_queue)
        self._stats = stats
        self._pack_pool = HostBufferPool()   # the worker's alone
        self._q: "queue.Queue" = queue.Queue()
        self._carry: Optional[_Request] = None  # opens the next batch
        self._carry_lock = threading.Lock()
        # orders an enqueue against close(): a request either lands before
        # the worker sees the queue empty, or is refused
        self._submit_lock = threading.Lock()
        self._closing = False
        self._closed = threading.Event()
        self._warmup = warmup
        self._warmed = threading.Event()
        self._warm_error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._worker, daemon=True,
            name=f"mx-serving-batcher-{name or engine.name}")
        self._thread.start()
        if warmup:
            self._warmed.wait()
            if self._warm_error is not None:
                raise self._warm_error

    # -------------------------------------------------------------- submit
    def submit(self, inputs, deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one request (any number of rows); the Future's result
        is the engine's output for this request's rows.  Raises at once
        for a bad request, after shutdown (:class:`ServerClosedError`)
        and when the queue is full (:class:`OverloadedError`)."""
        arrs = self._engine.normalize_host(inputs)
        if deadline_ms is None:
            deadline_ms = float(env.MXNET_SERVING_DEADLINE_MS)
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms and deadline_ms > 0 else None)
        req = _Request(arrs, arrs[0].shape[0], deadline)
        with self._submit_lock:
            if self._closing:
                raise ServerClosedError(
                    "batcher is shut down; no new requests")
            if self.pending >= self.max_queue:
                if self._stats is not None:
                    self._stats.record_shed()
                retry_after = max(1.0, self.max_wait_us / 1e6
                                  * (self.max_queue / max(1, self.max_batch)))
                raise OverloadedError(
                    f"{self._engine.name}: queue full ({self.pending} pending"
                    f" >= max_queue {self.max_queue}); shedding load",
                    retry_after_s=retry_after)
            self._q.put(req)
            self._set_depth()
        return req.future

    def _set_depth(self):
        if self._stats is not None:
            self._stats.queue_depth = self.pending

    # -------------------------------------------------------------- worker
    def _next(self, timeout: Optional[float]):
        with self._carry_lock:
            if self._carry is not None:
                req, self._carry = self._carry, None
                return req
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def _admit(self, req: Optional[_Request]) -> Optional[_Request]:
        """Fail a request whose deadline passed while it queued."""
        if req is None or req.deadline is None or \
                time.monotonic() < req.deadline:
            return req
        if req.future.set_running_or_notify_cancel():
            req.future.set_exception(DeadlineExceededError(
                f"request expired after "
                f"{(time.monotonic() - req.t_enqueue) * 1e3:.1f}ms in queue "
                f"({self._engine.name})"))
        if self._stats is not None:
            self._stats.record_expired()
        self._set_depth()
        return None

    def _worker(self):
        if self._warmup:
            try:
                self._engine.warmup()
            except BaseException as e:  # noqa: BLE001 - raised by __init__
                self._warm_error = e
                self._closing = True
            finally:
                self._warmed.set()
        while True:
            req = self._admit(self._next(timeout=0.05))
            if req is None:
                if self._closing and self._carry is None and self._q.empty():
                    break
                continue
            batch: List[_Request] = [req]
            rows = req.n
            deadline = time.monotonic() + self.max_wait_us / 1e6
            # pack until full or the first request has waited long enough;
            # while closing, take what is queued without waiting
            while rows < self.max_batch:
                remaining = 0.0 if self._closing else (
                    deadline - time.monotonic())
                if remaining <= 0 and self._q.empty():
                    break
                raw = self._next(timeout=max(0.0, remaining))
                if raw is None:
                    break
                nxt = self._admit(raw)
                if nxt is None:
                    continue
                if rows + nxt.n > self.max_batch:
                    with self._carry_lock:
                        self._carry = nxt
                    break
                batch.append(nxt)
                rows += nxt.n
            self._run(batch, rows)
        self._closed.set()

    def _pack(self, batch: List[_Request], rows: int) -> List[NDArray]:
        """The batch's rows in one host buffer per input at the rung's
        size (padding rows zero), each sent to the card in one copy."""
        bucket = self._engine.bucket_for(rows)
        ctx = self._engine.context
        dev = ctx.torch_device()
        arrs = []
        for i, (feat, dtype) in enumerate(self._engine.input_spec):
            buf = self._pack_pool.get((bucket,) + tuple(feat), dtype,
                                      tag=str(i), zero=rows < bucket)
            lo = 0
            for r in batch:
                buf[lo:lo + r.n] = r.arrays[i]
                lo += r.n
            # a synchronous copy: the buffer is free again on return
            arrs.append(NDArray(torch.from_numpy(buf).to(dev, copy=True),
                                ctx))
        return arrs

    def _run(self, batch: List[_Request], rows: int):
        packed = (self._engine.input_spec is not None
                  and rows <= self.max_batch)
        t0 = time.perf_counter()
        stage = {}
        try:
            if packed:
                arrs = self._pack(batch, rows)
                stage["pack"] = time.perf_counter() - t0
                out_list, single = self._engine.execute_padded(arrs, rows)
            else:
                # each request to the card, joined there
                ctx = self._engine.context
                parts = [[torch.from_numpy(a).to(ctx.torch_device())
                          for a in r.arrays] for r in batch]
                arrs = [NDArray(torch.cat([p[i] for p in parts]), ctx)
                        for i in range(len(parts[0]))]
                stage["pack"] = time.perf_counter() - t0
                outs = self._engine.predict(arrs)
                single = not isinstance(outs, (list, tuple))
                out_list = [outs] if single else list(outs)
            t1 = time.perf_counter()
            stage["execute"] = t1 - t0 - stage["pack"]
            delivered: List[_Request] = []
            lo = 0
            for r in batch:
                piece = [o if o.shape[0] == r.n else o[lo:lo + r.n]
                         for o in out_list]
                lo += r.n
                # a caller may have cancelled its future while queued;
                # that must not reach the other requests of the batch
                if r.future.set_running_or_notify_cancel():
                    r.future.set_result(piece[0] if single else piece)
                    delivered.append(r)
            t_done = time.monotonic()
            stage["split"] = time.perf_counter() - t1
            if self._stats is not None:
                for r in delivered:
                    self._stats.record_request((t_done - r.t_enqueue) * 1e6)
                top = self._engine.ladder[-1]
                self._stats.record_batch(
                    len(batch), rows,
                    self._engine.bucket_for(rows) if rows <= top else top,
                    **stage)
        except Exception as e:  # noqa: BLE001 - a failed batch fails its own
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)
                    if self._stats is not None:
                        self._stats.record_error()
        finally:
            self._set_depth()

    # ------------------------------------------------------------ shutdown
    def close(self, timeout: Optional[float] = 30.0) -> bool:
        """Refuse new requests, drain the queue, join the worker; True
        when that finished within ``timeout``."""
        with self._submit_lock:
            self._closing = True
        drained = self._closed.wait(timeout)
        self._thread.join(timeout)
        return drained and not self._thread.is_alive()

    def fail_pending(self, exc: Optional[BaseException] = None) -> int:
        """Fail every still-queued request with ``exc`` (default
        :class:`ServerClosedError`); returns how many."""
        exc = exc or ServerClosedError(
            f"{self._engine.name}: server shut down before this queued "
            "request ran")
        failed = 0
        while True:
            with self._carry_lock:
                req, self._carry = self._carry, None
            if req is None:
                try:
                    req = self._q.get_nowait()
                except queue.Empty:
                    break
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(exc)
                failed += 1
                if self._stats is not None:
                    self._stats.record_error()
        self._set_depth()
        return failed

    @property
    def pending(self) -> int:
        return self._q.qsize() + (1 if self._carry is not None else 0)
