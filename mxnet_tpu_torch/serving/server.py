"""In-process serving surface.

Counterpart of ``mxnet_tpu/serving/server.py`` without its HTTP surface:
a :class:`ModelServer` serves non-generative models through ``register``
(an :class:`~.engine.InferenceEngine` behind a
:class:`~.batcher.DynamicBatcher`, warmed over its bucket ladder) and
generation models through ``register_generation`` (a
:class:`GenerationScheduler` driven by a daemon step loop).
``predict``/``predict_async``, the in-process :class:`Client` and
``generate``/``generate_async``/``generate_stream`` submit requests;
``stats`` reports per model; ``stop`` drains them all.  The HTTP endpoints
and the circuit breaker wait for later slices.
"""
from __future__ import annotations

import threading
import time
import warnings
from typing import Any, Dict, Optional

from ..base import MXNetError, ServerClosedError
from .batcher import DynamicBatcher
from .engine import InferenceEngine
from .generation import DEFAULT_EOS, GenerationScheduler, TokenStream
from .stats import ServingStats

__all__ = ["ModelServer", "Client"]


class _Served:
    """One non-generative model: its engine, batcher and statistics."""

    __slots__ = ("engine", "batcher", "stats")

    def __init__(self, engine, batcher, stats):
        self.engine = engine
        self.batcher = batcher
        self.stats = stats


class _GenServed:
    """One generation model: a scheduler plus the daemon thread that drives
    its step loop whenever work is pending."""

    __slots__ = ("scheduler", "thread", "wake", "closed")

    def __init__(self, scheduler: GenerationScheduler, name: str):
        self.scheduler = scheduler
        self.wake = threading.Event()
        self.closed = False
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name=f"mx-serving-gen-{name}")
        self.thread.start()

    def _loop(self):
        while not self.closed:
            self.wake.wait()
            self.wake.clear()
            while not self.closed and self.scheduler.step():
                pass

    def submit(self, prompt, max_new_tokens, eos_id, stream=None):
        if self.closed:
            raise ServerClosedError("generation model is draining")
        fut = self.scheduler.submit(prompt, max_new_tokens=max_new_tokens,
                                    eos_id=eos_id, stream=stream)
        self.wake.set()
        return fut

    def close(self, timeout: Optional[float]) -> int:
        """Stop the step loop (after the step in progress) and fail every
        request it left behind with :class:`ServerClosedError`; returns how
        many were failed."""
        self.closed = True
        self.wake.set()
        self.thread.join(timeout)
        sched = self.scheduler
        with sched._lock:
            seqs = [s for s in sched._slots if s is not None]
            seqs += list(sched._pending)
            sched._pending.clear()
            for i in range(len(sched._slots)):
                sched._slots[i] = None
            for s in seqs:
                sched._rids.pop(s.rid, None)
                if sched.paged:
                    sched._free_pages(s)
        failed = 0
        for s in seqs:
            exc = ServerClosedError("server stopped mid-generation")
            if s.stream is not None:
                # flush what was produced, then end the stream with the
                # same error the Future carries
                delta = s.generated[s.streamed:]
                if delta:
                    s.stream._push(delta)
                    s.streamed = len(s.generated)
                s.stream._fail(exc)
            if not s.future.done() and not s.future.cancelled():
                s.future.set_exception(exc)
                failed += 1
        return failed


class ModelServer:
    """Serves models in-process."""

    def __init__(self):
        self._models: Dict[str, _Served] = {}
        self._generators: Dict[str, _GenServed] = {}
        self._stopped = False

    def register(self, name: str, block=None,
                 engine: Optional[InferenceEngine] = None,
                 max_batch: int = 8, max_wait_us: int = 2000,
                 input_spec=None, warmup: bool = True,
                 max_queue: Optional[int] = None) -> InferenceEngine:
        """Serve ``block`` (or a prebuilt ``engine``) under ``name``.
        ``warmup`` runs the whole bucket ladder, on the batcher's worker
        thread, before the model takes traffic, so live requests only hit
        cache entries; it needs an input spec (given, captured from a
        forward, or from an export's sidecar)."""
        if self._stopped:
            raise MXNetError("server is stopped; create a new ModelServer")
        if name in self._models or name in self._generators:
            raise MXNetError(f"model {name!r} already registered")
        stats = ServingStats(name)
        if engine is None:
            if block is None:
                raise MXNetError("register needs a block or an engine")
            engine = InferenceEngine(block, input_spec=input_spec,
                                     max_batch=max_batch, name=name,
                                     stats=stats)
        else:
            engine._stats = stats
        batcher = DynamicBatcher(engine, max_wait_us=max_wait_us,
                                 stats=stats, name=name, max_queue=max_queue,
                                 warmup=warmup)
        self._models[name] = _Served(engine, batcher, stats)
        return engine

    def register_generation(self, name: str, model,
                            scheduler: Optional[GenerationScheduler] = None,
                            max_slots: int = 4, eos_id: Optional[int] = None,
                            max_length: Optional[int] = None,
                            min_bucket: int = 16,
                            **sched_kwargs) -> GenerationScheduler:
        """Serve a decoder LM under ``name``: continuous batching (paged KV
        cache unless ``kv_cache=False``), or a prebuilt ``scheduler``,
        driven by a daemon step loop.  Extra keyword arguments go to
        :class:`GenerationScheduler`."""
        if self._stopped:
            raise MXNetError("server is stopped; create a new ModelServer")
        if name in self._generators or name in self._models:
            raise MXNetError(f"model {name!r} already registered")
        if scheduler is None:
            if model is None:
                raise MXNetError("register_generation needs a model or a "
                                 "prebuilt scheduler")
            scheduler = GenerationScheduler(
                model, max_slots=max_slots, eos_id=eos_id,
                max_length=max_length, min_bucket=min_bucket, name=name,
                **sched_kwargs)
        self._generators[name] = _GenServed(scheduler, name)
        return scheduler

    def _gen(self, name: str) -> _GenServed:
        try:
            return self._generators[name]
        except KeyError:
            raise MXNetError(f"unknown generation model {name!r}; serving "
                             f"{self.models()}") from None

    def models(self):
        """The names served, non-generative and generative."""
        return sorted([*self._models, *self._generators])

    def _served(self, name: str) -> _Served:
        try:
            return self._models[name]
        except KeyError:
            raise MXNetError(f"unknown model {name!r}; serving "
                             f"{self.models()}") from None

    def predict_async(self, name: str, inputs,
                      deadline_ms: Optional[float] = None):
        """Submit a request; the Future resolves to the model's outputs
        for its rows (one NDArray, or a list)."""
        return self._served(name).batcher.submit(inputs,
                                                 deadline_ms=deadline_ms)

    def predict(self, name: str, inputs, deadline_ms: Optional[float] = None):
        return self.predict_async(name, inputs, deadline_ms).result()

    def client(self) -> "Client":
        return Client(self)

    def generate_async(self, name: str, prompt, max_new_tokens: int = 16,
                       eos_id=DEFAULT_EOS):
        """Submit a request; the Future resolves to the generated tokens.
        Omit ``eos_id`` for the scheduler's default, pass ``None`` to
        disable eos for this request."""
        return self._gen(name).submit(prompt, max_new_tokens, eos_id)

    def generate(self, name: str, prompt, max_new_tokens: int = 16,
                 eos_id=DEFAULT_EOS):
        return self.generate_async(name, prompt, max_new_tokens,
                                   eos_id=eos_id).result()

    def generate_stream(self, name: str, prompt, max_new_tokens: int = 16,
                        eos_id=DEFAULT_EOS) -> TokenStream:
        """A :class:`TokenStream` yielding tokens as the step loop produces
        them, ending with the request's error on failure."""
        gen = self._gen(name)
        stream = TokenStream()
        gen.submit(prompt, max_new_tokens, eos_id, stream=stream)
        return stream

    def stats(self, name: Optional[str] = None) -> Dict[str, Any]:
        """Serving statistics of one model (with its CachedOp counters, or
        its scheduler's), or of all."""
        if name is None:
            return {n: self.stats(n) for n in self.models()}
        if name in self._models:
            m = self._models[name]
            return m.stats.snapshot(m.engine.cache_stats)
        sched = self._gen(name).scheduler
        snap = sched._stats.snapshot()
        snap.update(sched.stats_snapshot())
        return snap

    def stop(self, timeout: Optional[float] = 30.0):
        """Graceful shutdown: refuse new work, stop every step loop and
        drain every batcher.  One drain budget of ``timeout`` seconds is
        shared by all models; requests still unfinished fail with
        :class:`ServerClosedError`."""
        if self._stopped:
            return
        self._stopped = True
        end = None if timeout is None else time.monotonic() + timeout

        def left():
            return None if end is None else max(0.0, end - time.monotonic())
        for name, g in self._generators.items():
            failed = g.close(left())
            if failed:
                warnings.warn(
                    f"serving: generation model {name!r} stopped with "
                    f"{failed} unfinished request(s) failed with "
                    "ServerClosedError", RuntimeWarning, stacklevel=2)
        for name, m in self._models.items():
            if not m.batcher.close(left()):
                failed = m.batcher.fail_pending()
                warnings.warn(
                    f"serving: model {name!r} did not drain within "
                    f"{timeout}s; failed {failed} still-queued request(s) "
                    "with ServerClosedError", RuntimeWarning, stacklevel=2)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class Client:
    """The in-process client: the same calls a remote client makes, on a
    :class:`ModelServer` in this process (the HTTP transport is not
    ported yet)."""

    def __init__(self, server: ModelServer):
        if not isinstance(server, ModelServer):
            raise MXNetError("Client takes a ModelServer; the HTTP transport"
                             " is not ported yet")
        self._server = server

    def predict(self, name: str, inputs, block: bool = True):
        fut = self._server.predict_async(name, inputs)
        return fut.result() if block else fut
