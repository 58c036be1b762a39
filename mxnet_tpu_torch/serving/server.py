"""Server surface: in-process :class:`Client` plus a stdlib HTTP endpoint.

Counterpart of ``mxnet_tpu/serving/server.py``.  A :class:`ModelServer`
serves non-generative models through ``register`` (an
:class:`~.engine.InferenceEngine` behind a :class:`~.batcher.DynamicBatcher`,
warmed over its bucket ladder, guarded by a per-model
:class:`~mxnet_tpu_torch.resilience.CircuitBreaker`) and generation models
through ``register_generation`` (a :class:`GenerationScheduler` driven by
a daemon step loop), and exposes

* an **in-process client** (``Client(server)``): no sockets;
* a **JSON/HTTP endpoint** (``start_http``, stdlib ``ThreadingHTTPServer``):
  ``POST /predict/<model>``, ``POST /generate/<model>`` (``"stream": true``
  answers Server-Sent Events, one per token; a ``"kv"`` handoff admits
  prompt K/V computed elsewhere), ``POST /cancel/<model>``, the fleet's
  ``POST /prefill/<model>``, ``POST /export/<model>`` and ``GET
  /fleet/state``, ``GET /ping``, ``GET /stats[/<model>]``, ``GET /metrics`` (Prometheus
  0.0.4, or OpenMetrics with exemplars under ``Accept:
  application/openmetrics-text``) and ``GET /goodput`` (request-time
  attribution, memory ledger, retained tail traces); ``Client(url)`` is
  its socket client, retrying connection errors and 503s through a
  :class:`~mxnet_tpu_torch.resilience.RetryPolicy`.

Every HTTP request runs on its own handler thread, which only parses JSON
into host numpy and hands it over: the replays stay on the batcher's
worker thread and the generation loop's thread, and a predict's outputs
come back to the handler as host arrays (the batcher copies them there).
JSON carries fp32 exactly (``tolist`` gives Python floats, ``repr``
round-trips them).

Failure semantics on the wire: 404 unknown model or route; 400 malformed
payload or wrong shape/dtype; 500 the model failed to execute; 503 with
``retry_after_s`` (and ``Retry-After``) load shed — queue full, the
model's breaker open, or draining; 504 the request's deadline expired in
the queue.  ``GET /ping`` reports ``SERVING``, ``DEGRADED`` (some model's
breaker is not closed) or ``DRAINING`` (shutdown in progress; 503, with
the requests still in flight).  ``stop()`` drains every model under one
:class:`~mxnet_tpu_torch.resilience.Deadline` before the listener dies.

The fleet's replica surface (the ``prefill`` / ``decode`` roles, each
warming only its own family): ``/prefill`` runs a prompt's prefill and
exports its K/V, ``/export`` snapshots a live request, both in the JAX
package's wire form (:func:`encode_kv`: base64 float32 ``[layers,
tokens, kv_units]``), so a replica of either package admits the other's
payload.  A stream that drops before its done event raises
:class:`ReplicaDeadError`.
"""
from __future__ import annotations

import base64
import json
import threading
import uuid
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as _np

from ..base import BFLOAT16, MXNetError, env as _env
from ..observability import metrics as _obs_metrics, tracing as _tracing
from ..resilience import (BackendUnavailableError, CircuitBreaker, Deadline,
                          DeadlineExceededError, FaultInjected,
                          OverloadedError, RequestCancelledError, RetryPolicy,
                          ServerClosedError, is_transient, maybe_fault)
from .batcher import DynamicBatcher
from .engine import InferenceEngine
from .generation import DEFAULT_EOS, GenerationScheduler, TokenStream
from .stats import ServingStats

__all__ = ["ModelServer", "Client", "TRACE_HEADER", "PARENT_HEADER",
           "trace_headers", "parent_from_headers", "encode_kv", "decode_kv",
           "sse_events", "next_sse_event", "ReplicaDeadError"]

# cross-process trace propagation: a caller stamps its span context into
# these headers and the handler links its root span under it
TRACE_HEADER = "X-Mxtpu-Trace-Id"
PARENT_HEADER = "X-Mxtpu-Parent-Id"


def trace_headers(ctx=None) -> Dict[str, str]:
    """Outbound propagation headers for the ambient (or given) span
    context; empty when no span is open."""
    ctx = ctx or _tracing.current_context()
    if ctx is None:
        return {}
    return {TRACE_HEADER: str(ctx.trace_id), PARENT_HEADER: str(ctx.span_id)}


def parent_from_headers(headers) -> Optional[_tracing.SpanContext]:
    """A SpanContext from propagation headers (None when absent or
    malformed: telemetry never fails a request)."""
    try:
        tid = headers.get(TRACE_HEADER)
        sid = headers.get(PARENT_HEADER)
        if tid is None or sid is None:
            return None
        return _tracing.SpanContext(int(tid), int(sid))
    except (TypeError, ValueError):
        return None


class ReplicaDeadError(MXNetError, ConnectionError):
    """A replica died mid-request after tokens were already delivered, so
    the caller cannot transparently re-run it.  The fleet Router relays it
    when no survivor can take a stream; :func:`sse_events` raises it on a
    stream that drops (or tears its final chunk) before its done event.
    A ``ConnectionError``, so ``except ConnectionError`` callers keep
    working."""


def encode_kv(k, v, first_token: int) -> Dict[str, Any]:
    """JSON-safe wire form of a K/V export: base64 float32 K/V of shape
    ``[layers, tokens, kv_units]`` plus the first sampled token, byte for
    byte the JAX package's."""
    k = _np.ascontiguousarray(k, dtype=_np.float32)
    v = _np.ascontiguousarray(v, dtype=_np.float32)
    return {"dtype": "float32", "shape": list(k.shape),
            "k": base64.b64encode(k.tobytes()).decode("ascii"),
            "v": base64.b64encode(v.tobytes()).decode("ascii"),
            "first_token": int(first_token)}


def decode_kv(payload: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Inverse of :func:`encode_kv` on a request payload's ``"kv"`` key;
    None when the request carries no handoff.  A malformed handoff raises
    ``ValueError`` or ``KeyError`` (400 at the HTTP layer)."""
    wire = payload.get("kv")
    if wire is None:
        return None
    shape = tuple(int(d) for d in wire["shape"])
    k = _np.frombuffer(base64.b64decode(wire["k"]),
                       dtype=_np.float32).reshape(shape)
    v = _np.frombuffer(base64.b64decode(wire["v"]),
                       dtype=_np.float32).reshape(shape)
    return {"k": k, "v": v, "first_token": int(wire["first_token"])}


class _Served:
    """One non-generative model: its engine, batcher, statistics and
    breaker."""

    __slots__ = ("engine", "batcher", "stats", "breaker")

    def __init__(self, engine, batcher, stats, breaker):
        self.engine = engine
        self.batcher = batcher
        self.stats = stats
        self.breaker = breaker


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

    def submit(self, prompt, max_new_tokens, eos_id, stream=None,
               ext_kv=None, rid=None):
        if self.closed:
            raise ServerClosedError("generation model is draining")
        fut = self.scheduler.submit(prompt, max_new_tokens=max_new_tokens,
                                    eos_id=eos_id, stream=stream,
                                    ext_kv=ext_kv, rid=rid)
        self.wake.set()
        return fut

    def in_flight(self) -> int:
        """Requests accepted but not resolved (pending + active slots)."""
        sched = self.scheduler
        return len(sched._pending) + sum(s is not None for s in sched._slots)

    def close(self, timeout: Optional[float]) -> int:
        """Stop the step loop (after the step in progress) and fail every
        request it left behind with :class:`ServerClosedError`; returns
        how many were failed."""
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


def _injected(site: str) -> Optional[Tuple[int, Dict[str, Any]]]:
    """Run the named fault site; ``(status, body)`` when a fault fired
    (transient -> 503 shed, fatal -> 500), None to proceed."""
    try:
        maybe_fault(site)
    except Exception as e:  # noqa: BLE001 - an injected fault only
        if isinstance(e, FaultInjected) and e.transient:
            return 503, {"error": str(e), "retry_after_s": 1.0}
        return 500, {"error": str(e)}
    return None


def _host_list(a: _np.ndarray):
    """A host output as nested lists of Python numbers (bfloat16 through
    float32, which holds it exactly)."""
    if a.dtype.kind not in "biuf":
        a = a.astype(_np.float32)
    return a.tolist()


class ModelServer:
    """Serves models in-process and, after :meth:`start_http`, over HTTP.
    ``role`` is the fleet's disaggregation role (advertised on
    ``/fleet/state``): ``"prefill"`` and ``"decode"`` replicas warm only
    the family their disaggregated traffic reaches."""

    def __init__(self, role: str = "mixed"):
        if role not in ("mixed", "prefill", "decode"):
            raise MXNetError(f"unknown server role {role!r}; expected "
                             "'mixed', 'prefill' or 'decode'")
        self.role = role
        self._models: Dict[str, _Served] = {}
        self._generators: Dict[str, _GenServed] = {}
        self._httpd = None
        self._http_thread = None
        self._stopped = False

    # ------------------------------------------------------------ registry
    def register(self, name: str, block=None,
                 engine: Optional[InferenceEngine] = None,
                 max_batch: int = 8, max_wait_us: int = 2000,
                 input_spec=None, warmup: Optional[bool] = None,
                 max_queue: Optional[int] = None,
                 breaker: Optional[CircuitBreaker] = None
                 ) -> InferenceEngine:
        """Serve ``block`` (or a prebuilt ``engine``) under ``name``.
        ``warmup`` (default ``MXNET_SERVING_WARMUP``) runs the whole bucket
        ladder, on the batcher's worker thread, before the model takes
        traffic, so live requests only hit cache entries; it needs an
        input spec (given, captured from a forward, or from an export's
        sidecar).  ``breaker`` (default: a :class:`CircuitBreaker` named
        ``serving:<name>``, from ``MXNET_TPU_BREAKER_THRESHOLD`` and
        ``MXNET_TPU_BREAKER_COOLDOWN``) sheds the model's requests while
        it is open."""
        if warmup is None:
            warmup = bool(_env.MXNET_SERVING_WARMUP)
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
        if breaker is None:
            breaker = CircuitBreaker(name=f"serving:{name}")
        batcher = DynamicBatcher(engine, max_wait_us=max_wait_us,
                                 stats=stats, name=name, max_queue=max_queue,
                                 warmup=warmup, breaker=breaker)
        self._models[name] = _Served(engine, batcher, stats, breaker)
        from .. import profiler
        profiler.register_stats_provider(
            f"serving:{name}", lambda n=name: self.stats(n))
        return engine

    def register_generation(self, name: str, model,
                            scheduler: Optional[GenerationScheduler] = None,
                            max_slots: int = 4, eos_id: Optional[int] = None,
                            max_length: Optional[int] = None,
                            min_bucket: int = 16, draft_model=None,
                            warmup: Optional[bool] = None,
                            warmup_prompt_len: Optional[int] = None,
                            **sched_kwargs) -> GenerationScheduler:
        """Serve a decoder LM under ``name``: continuous batching (paged KV
        cache unless ``kv_cache=False``, speculative with a
        ``draft_model``), or a prebuilt ``scheduler``, driven by a daemon
        step loop.  ``POST /generate/<name>`` with ``{"prompt": [ids],
        "max_new_tokens": n}`` answers ``{"tokens": [...]}``.  ``warmup``
        (default ``MXNET_SERVING_WARMUP``) makes the scheduler's prefill,
        decode and draft/verify families first (on the card: captures
        their CUDA graphs), for prompts up to ``warmup_prompt_len``, so no
        first token waits for a capture.  Extra keyword arguments go to
        :class:`GenerationScheduler`."""
        if warmup is None:
            warmup = bool(_env.MXNET_SERVING_WARMUP)
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
                max_length=max_length, min_bucket=min_bucket,
                draft_model=draft_model, name=name, **sched_kwargs)
        if warmup:
            # the role's family only: what its traffic can reach
            scheduler.warmup(max_prompt_len=warmup_prompt_len,
                             role=self.role)
        self._generators[name] = _GenServed(scheduler, name)
        from .. import profiler
        profiler.register_stats_provider(
            f"generation:{name}",
            lambda n=name: self._generators[n].scheduler.stats_snapshot())
        return scheduler

    def _gen(self, name: str) -> _GenServed:
        try:
            return self._generators[name]
        except KeyError:
            raise MXNetError(f"unknown generation model {name!r}; serving "
                             f"{sorted(self._generators)}") from None

    def models(self):
        """The names served, non-generative and generative."""
        return sorted([*self._models, *self._generators])

    def _served(self, name: str) -> _Served:
        try:
            return self._models[name]
        except KeyError:
            raise MXNetError(f"unknown model {name!r}; serving "
                             f"{self.models()}") from None

    # ------------------------------------------------------------- predict
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
        disable eos for this request (as the HTTP payload's absent versus
        null ``eos_id``)."""
        return self._gen(name).submit(prompt, max_new_tokens, eos_id)

    def generate(self, name: str, prompt, max_new_tokens: int = 16,
                 eos_id=DEFAULT_EOS):
        return self.generate_async(name, prompt, max_new_tokens,
                                   eos_id=eos_id).result()

    def generate_stream(self, name: str, prompt, max_new_tokens: int = 16,
                        eos_id=DEFAULT_EOS, ext_kv=None) -> TokenStream:
        """A :class:`TokenStream` yielding tokens as the step loop produces
        them, ending with the request's error on failure (what the SSE
        path writes out).  ``ext_kv`` admits imported prompt K/V."""
        gen = self._gen(name)
        stream = TokenStream()
        gen.submit(prompt, max_new_tokens, eos_id, stream=stream,
                   ext_kv=ext_kv)
        return stream

    # -------------------------------------------------------------- health
    def health(self) -> str:
        """``SERVING`` / ``DEGRADED`` (some model's breaker is not closed;
        that model sheds while the others serve) / ``DRAINING`` (shutdown
        started) — what ``/ping`` reports."""
        if self._stopped:
            return "DRAINING"
        if any(m.breaker is not None
               and m.breaker.state != CircuitBreaker.CLOSED
               for m in self._models.values()):
            return "DEGRADED"
        return "SERVING"

    def in_flight(self) -> int:
        """Accepted but unresolved requests across every model: queued
        batcher requests plus pending and active generation sequences."""
        n = sum(g.in_flight() for g in self._generators.values())
        return n + sum(m.batcher.pending for m in self._models.values())

    def ping_payload(self) -> Dict[str, Any]:
        """The ``/ping`` body: the state, and while DRAINING the requests
        still in flight."""
        state = self.health()
        payload: Dict[str, Any] = {"status": state}
        if state == "DRAINING":
            payload["in_flight"] = self.in_flight()
        return payload

    def fleet_state(self) -> Dict[str, Any]:
        """The control view a fleet Router polls (``GET /fleet/state``):
        health, role, live load (in flight, and per model its queue), and
        each paged model's prefix digest, the chain hashes materialised in
        its pool, which the Router matches against request prompts."""
        out: Dict[str, Any] = {"status": self.health(), "role": self.role,
                               "in_flight": self.in_flight(), "models": {}}
        cap = int(_env.MXNET_FLEET_PREFIX_DIGEST_CAP)
        for name, g in self._generators.items():
            sched = g.scheduler
            d: Dict[str, Any] = {
                "kind": "generation",
                "engine": "paged" if sched.paged else "dense",
                "pending": len(sched._pending),
                "active": sum(s is not None for s in sched._slots),
                "slots": sched.max_slots,
            }
            if sched.paged:
                pool = sched._target.pool
                d["page_tokens"] = sched.page_tokens
                d["page_pool"] = pool.stats()
                d["prefix_digest"] = pool.prefix_digest(cap)
            out["models"][name] = d
        for name, m in self._models.items():
            out["models"][name] = {"kind": "predict",
                                   "pending": m.batcher.pending,
                                   "breaker": m.breaker.state
                                   if m.breaker is not None else None}
        return out

    # --------------------------------------------------- wire-level semantics
    def handle_predict(self, name: str, payload: Dict[str, Any],
                       deadline_ms: Optional[float] = None,
                       parent=None) -> Tuple[int, Dict[str, Any]]:
        """One ``/predict`` request -> ``(http_status, response_dict)``:
        404 unknown model, 400 bad payload, 503 shed (with
        ``retry_after_s``), 504 queue-deadline expiry, 500 model execution
        failure.  Opens the request's root span (``http.predict``, under
        ``parent`` when a caller propagated one) on the calling thread;
        the batcher's spans link back to it."""
        with _tracing.span("http.predict", attrs={"model": name},
                           parent=parent) as root:
            code, resp = self._handle_predict(name, payload, deadline_ms)
            root.set_attr("status", code)
        return code, resp

    def _handle_predict(self, name, payload, deadline_ms):
        hurt = _injected("http")
        if hurt is not None:
            return hurt
        try:
            served = self._served(name)
        except MXNetError as e:
            return 404, {"error": str(e)}
        try:
            spec = served.engine.input_spec
            raw = payload["inputs"] if "inputs" in payload \
                else [payload["data"]]
            if spec is not None and len(raw) == len(spec):
                arrs = [_np.asarray(x, dtype=BFLOAT16 if d == "bfloat16"
                                    else _np.dtype(d))
                        for x, (_, d) in zip(raw, spec)]
            else:
                arrs = [_np.asarray(x) for x in raw]
            fut = served.batcher.submit(arrs, deadline_ms=deadline_ms,
                                        host=True)
        except OverloadedError as e:
            return 503, {"error": str(e), "retry_after_s": e.retry_after_s}
        except (BackendUnavailableError, ServerClosedError) as e:
            return 503, {"error": str(e), "retry_after_s": 1.0}
        except (MXNetError, ValueError, TypeError, KeyError) as e:
            return 400, {"error": repr(e)}  # payload/shape/dtype
        except Exception as e:  # noqa: BLE001 - anything else is ours
            return 500, {"error": repr(e)}
        try:
            outs = fut.result()
        except DeadlineExceededError as e:
            return 504, {"error": str(e)}
        except ServerClosedError as e:
            return 503, {"error": str(e), "retry_after_s": 1.0}
        except Exception as e:  # noqa: BLE001 - the model failed to run
            return 500, {"error": repr(e)}
        out_list = outs if isinstance(outs, (list, tuple)) else [outs]
        return 200, {"outputs": [_host_list(o) for o in out_list]}

    def _submit_generate(self, name, payload, stream=None):
        """The generate request's submission: ``(status, body)`` for an
        error, else ``(None, future)``."""
        if name not in self._generators:
            return 404, {"error": f"unknown generation model {name!r}; "
                                  f"serving {sorted(self._generators)}"}
        try:
            prompt = payload["prompt"]
            max_new = int(payload.get("max_new_tokens", 16))
            fut = self._generators[name].submit(
                [int(t) for t in prompt], max_new,
                payload.get("eos_id", DEFAULT_EOS), stream=stream,
                ext_kv=decode_kv(payload),
                rid=stream.rid if stream is not None else payload.get("rid"))
        except ServerClosedError as e:
            return 503, {"error": str(e), "retry_after_s": 1.0}
        except (MXNetError, ValueError, TypeError, KeyError) as e:
            return 400, {"error": repr(e)}
        return None, fut

    def handle_generate(self, name: str, payload: Dict[str, Any],
                        parent=None) -> Tuple[int, Dict[str, Any]]:
        """One ``/generate`` request -> ``(http_status, response_dict)``:
        404 unknown model, 400 bad payload, 503 draining, 409 cancelled,
        500 model failure.  A ``"kv"`` payload (a ``/prefill`` or
        ``/export`` body's) admits the shipped prompt K/V instead of
        prefilling.  ``"rid"`` names the request for ``/cancel`` and
        ``/export``."""
        with _tracing.span("http.generate", attrs={"model": name},
                           parent=parent) as root:
            hurt = _injected("replica_exec")
            if hurt is not None:
                code, resp = hurt
            else:
                code, resp = self._submit_generate(name, payload)
                if code is None:
                    try:
                        code, resp = 200, {"tokens": resp.result()}
                    except ServerClosedError as e:
                        code, resp = 503, {"error": str(e),
                                           "retry_after_s": 1.0}
                    except RequestCancelledError as e:
                        code, resp = 409, {"error": str(e),
                                           "type": "RequestCancelledError"}
                    except Exception as e:  # noqa: BLE001 - model failed
                        code, resp = 500, {"error": repr(e)}
            root.set_attr("status", code)
        return code, resp

    def handle_generate_stream(self, name: str, payload: Dict[str, Any],
                               parent=None):
        """Streaming ``/generate`` (``{"stream": true}``): ``(200,
        TokenStream)`` on acceptance (the handler writes one SSE event per
        token), else the error taxonomy of :meth:`handle_generate`."""
        with _tracing.span("http.generate",
                           attrs={"model": name, "stream": True},
                           parent=parent) as root:
            hurt = _injected("replica_exec")
            if hurt is not None:
                code, resp = hurt
            else:
                # the stream carries its rid so that the handler can
                # cancel the request when its client walks away
                stream = TokenStream(rid=str(payload.get("rid")
                                             or uuid.uuid4().hex))
                code, resp = self._submit_generate(name, payload, stream)
                if code is None:
                    code, resp = 200, stream
            root.set_attr("status", code)
        return code, resp

    def cancel_generation(self, name: str, rid: str) -> bool:
        """Cancel one in-flight generation request by id; True when it was
        live and its pages were freed (False: unknown or finished)."""
        return self._gen(name).scheduler.cancel(rid)

    def handle_cancel(self, name: str, payload: Dict[str, Any]
                      ) -> Tuple[int, Dict[str, Any]]:
        """``POST /cancel/<model>`` with ``{"rid": ...}``: 200 with
        ``{"cancelled": bool}`` (a finished request is a no-op), 400
        without a rid, 404 for an unknown model."""
        try:
            rid = payload["rid"]
        except KeyError:
            return 400, {"error": "cancel payload needs a 'rid'"}
        try:
            return 200, {"cancelled": self.cancel_generation(name, rid)}
        except MXNetError as e:
            return 404, {"error": str(e)}

    def handle_export(self, name: str, payload: Dict[str, Any]
                      ) -> Tuple[int, Dict[str, Any]]:
        """``POST /export/<model>`` with ``{"rid": ...}``: the live-migration
        snapshot of one in-flight request (prompt, tokens so far, remaining
        budget and, once it holds pages, its K/V in the ``"kv"`` wire form
        ``/prefill`` answers), ready for a survivor's ``/generate``."""
        try:
            rid = payload["rid"]
        except KeyError:
            return 400, {"error": "export payload needs a 'rid'"}
        gen = self._generators.get(name)
        if gen is None:
            return 404, {"error": f"unknown generation model {name!r}; "
                                  f"serving {sorted(self._generators)}"}
        try:
            snap = gen.scheduler.export_request(rid)
        except MXNetError as e:
            return 404, {"error": str(e)}
        except Exception as e:  # noqa: BLE001 - the export raced a step
            return 500, {"error": repr(e)}
        out = {k: snap[k] for k in ("rid", "prompt", "generated",
                                    "max_new_tokens", "eos_id", "sampling")}
        if "k" in snap:
            out["kv"] = encode_kv(snap["k"], snap["v"],
                                  first_token=snap["generated"][-1]
                                  if snap["generated"]
                                  else snap["prompt"][-1])
            out["hashes"] = snap["hashes"]
            out["page_tokens"] = snap["page_tokens"]
        return 200, out

    def handle_prefill(self, name: str, payload: Dict[str, Any],
                       parent=None) -> Tuple[int, Dict[str, Any]]:
        """``POST /prefill/<model>``, the disaggregation export: run the
        prompt's ``[1, L]`` prefill on this replica and answer the first
        token, the chain hashes and the K/V in the ``"kv"`` wire form a
        decode replica's ``/generate`` admits.  503 with
        ``retry_after_s`` when the pool has no free pages."""
        with _tracing.span("http.prefill", attrs={"model": name},
                           parent=parent) as root:
            hurt = _injected("replica_exec")
            if hurt is not None:
                code, resp = hurt
            elif name not in self._generators:
                code, resp = 404, {
                    "error": f"unknown generation model {name!r}; serving "
                             f"{sorted(self._generators)}"}
            else:
                try:
                    prompt = payload["prompt"]
                    max_new = int(payload.get("max_new_tokens", 16))
                    if self._stopped:
                        raise ServerClosedError("server is draining")
                    out = self._generators[name].scheduler.prefill_only(
                        prompt, max_new)
                except OverloadedError as e:
                    code, resp = 503, {"error": str(e),
                                       "retry_after_s": e.retry_after_s}
                except ServerClosedError as e:
                    code, resp = 503, {"error": str(e), "retry_after_s": 1.0}
                except (MXNetError, ValueError, TypeError, KeyError) as e:
                    code, resp = 400, {"error": repr(e)}
                except Exception as e:  # noqa: BLE001 - the model failed
                    code, resp = 500, {"error": repr(e)}
                else:
                    code, resp = 200, {
                        "first_token": out["first_token"],
                        "hashes": out["hashes"],
                        "page_tokens": out["page_tokens"],
                        "kv": encode_kv(out["k"], out["v"],
                                        out["first_token"])}
            root.set_attr("status", code)
        return code, resp

    # --------------------------------------------------------------- views
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

    def metrics_text(self, exemplars: bool = False) -> str:
        """Prometheus text of the process-global registry (the body of
        ``GET /metrics``); ``exemplars=True`` renders OpenMetrics."""
        return _obs_metrics.render_prometheus(exemplars=exemplars)

    def goodput_snapshot(self) -> Dict[str, Any]:
        """What ``GET /goodput`` serves: per-bucket request-time totals,
        the last attributed request, the memory ledger and the retained
        tail-trace summaries; once this process has used the card, also
        ``device_memory``, the caching allocator's bytes allocated now and
        at their peak, and reserved (a fleet's chaos run samples each
        replica process's peak here)."""
        import torch
        from ..observability import goodput as _goodput, memory as _memory
        out = _goodput.snapshot()
        out["memory"] = _memory.ledger().snapshot()
        if torch.cuda.is_initialized():
            out["device_memory"] = {
                "allocated_bytes": torch.cuda.memory_allocated(),
                "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                "reserved_bytes": torch.cuda.memory_reserved()}
        return out

    # ---------------------------------------------------------------- http
    def start_http(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Serve the JSON endpoint on a daemon thread; returns the bound
        port (``port=0`` picks a free one)."""
        if self._httpd is not None:
            raise MXNetError("HTTP endpoint already running")
        from http.server import ThreadingHTTPServer
        self._httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="mx-serving-http")
        self._http_thread.start()
        return self._httpd.server_address[1]

    # ------------------------------------------------------------ shutdown
    def stop(self, timeout: Optional[float] = 30.0):
        """Graceful shutdown: refuse new work, drain every model (one
        ``timeout`` budget shared by all), stop the HTTP listener, unhook
        the profiler providers.  Requests still unfinished fail with
        :class:`ServerClosedError`."""
        if self._stopped:
            return
        self._stopped = True  # health() now reports DRAINING
        budget = Deadline(timeout) if timeout is not None else None

        def left():
            return None if budget is None else max(0.0, budget.remaining())
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
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._http_thread.join(timeout)
            self._httpd = None
        from .. import profiler
        for name in self._models:
            profiler.unregister_stats_provider(f"serving:{name}")
        for name in self._generators:
            profiler.unregister_stats_provider(f"generation:{name}")

    shutdown = stop

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def _remote_error(code: int, payload: Dict[str, Any]) -> Exception:
    """A server's error response as the local exception type, so callers
    and retry classifiers see the same types either side of the wire."""
    msg = payload.get("error", f"HTTP {code}")
    if code == 503:
        return OverloadedError(msg, retry_after_s=float(
            payload.get("retry_after_s", 1.0)))
    if code == 504:
        return DeadlineExceededError(msg)
    return MXNetError(f"HTTP {code}: {msg}")


class Client:
    """One client, two transports: a :class:`ModelServer` for the
    in-process mode (the HTTP surface's contract without sockets), or an
    ``"http://host:port"`` URL for the socket mode, which retries
    connection errors and 503 answers through a :class:`RetryPolicy`."""

    def __init__(self, server, retry: Optional[RetryPolicy] = None):
        if isinstance(server, str):
            self._server = None
            self._base = server.rstrip("/")
            self._retry = retry or RetryPolicy(
                max_attempts=5, base_delay=0.2, max_delay=2.0,
                retryable=self._retryable)
        elif isinstance(server, ModelServer):
            self._server = server
            self._base = None
            self._retry = None
        else:
            raise MXNetError("Client takes a ModelServer or an "
                             "'http://host:port' URL")

    # -- socket transport ---------------------------------------------------
    @staticmethod
    def _retryable(exc: BaseException) -> bool:
        if isinstance(exc, OverloadedError):
            return True  # 503: warming up, shedding or briefly open
        return is_transient(exc)

    @staticmethod
    def _error_of(e) -> Exception:
        try:
            err = json.loads(e.read() or b"{}")
        except Exception:  # noqa: BLE001 - a non-JSON error body
            err = {"error": str(e)}
        return _remote_error(e.code, err)

    def _http(self, method: str, path: str,
              payload: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        import urllib.error
        import urllib.request

        def once():
            body = None if payload is None else json.dumps(payload).encode()
            req = urllib.request.Request(
                self._base + path, data=body, method=method,
                headers={"Content-Type": "application/json",
                         **trace_headers()})
            try:
                with urllib.request.urlopen(req, timeout=600.0) as resp:
                    return json.loads(resp.read() or b"{}")
            except urllib.error.HTTPError as e:
                raise self._error_of(e) from None

        return self._retry.call(once, site=f"client:{path}")

    def ping(self) -> Dict[str, Any]:
        return self._http("GET", "/ping")

    # -- the shared surface -------------------------------------------------
    def predict(self, name: str, inputs, block: bool = True):
        """The model's outputs for ``inputs`` (a list of arrays, one per
        input): over HTTP the JSON ``outputs`` (nested lists), in process
        the Future's result (or the Future, ``block=False``)."""
        if self._server is None:
            inputs = [_np.asarray(x).tolist() for x in inputs]
            return self._http("POST", f"/predict/{name}",
                              {"inputs": inputs})["outputs"]
        fut = self._server.predict_async(name, inputs)
        return fut.result() if block else fut

    def generate(self, name: str, prompt, max_new_tokens: int = 16,
                 block: bool = True, eos_id=DEFAULT_EOS,
                 kv: Optional[Dict[str, Any]] = None):
        """The generated tokens; ``kv`` (over HTTP) is a ``/prefill``
        body's ``"kv"`` handoff."""
        if self._server is None:
            body = {"prompt": [int(t) for t in prompt],
                    "max_new_tokens": max_new_tokens}
            if eos_id is not DEFAULT_EOS:
                body["eos_id"] = eos_id
            if kv is not None:
                body["kv"] = kv
            return self._http("POST", f"/generate/{name}", body)["tokens"]
        fut = self._server.generate_async(name, prompt, max_new_tokens,
                                          eos_id=eos_id)
        return fut.result() if block else fut

    def generate_stream(self, name: str, prompt, max_new_tokens: int = 16,
                        eos_id=DEFAULT_EOS, rid: Optional[str] = None):
        """Incremental tokens: in process the scheduler's TokenStream; over
        HTTP a generator over the server's SSE events (the acceptance is
        retried; the open stream is not)."""
        if self._server is not None:
            return self._server.generate_stream(name, prompt,
                                                max_new_tokens, eos_id)
        body = {"prompt": [int(t) for t in prompt],
                "max_new_tokens": max_new_tokens, "stream": True}
        if eos_id is not DEFAULT_EOS:
            body["eos_id"] = eos_id
        if rid is not None:
            body["rid"] = rid
        import urllib.error
        import urllib.request

        def open_stream():
            req = urllib.request.Request(
                f"{self._base}/generate/{name}", method="POST",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json",
                         "Accept": "text/event-stream", **trace_headers()})
            try:
                return urllib.request.urlopen(req, timeout=600.0)
            except urllib.error.HTTPError as e:
                raise self._error_of(e) from None

        resp = self._retry.call(open_stream, site=f"client:/generate/{name}")
        return sse_events(resp)

    def prefill(self, name: str, prompt, max_new_tokens: int = 16
                ) -> Dict[str, Any]:
        """A prefill replica's export of ``prompt``: ``first_token``,
        ``hashes``, ``page_tokens`` and the ``kv`` handoff."""
        if self._server is None:
            return self._http("POST", f"/prefill/{name}",
                              {"prompt": [int(t) for t in prompt],
                               "max_new_tokens": max_new_tokens})
        code, resp = self._server.handle_prefill(
            name, {"prompt": list(prompt), "max_new_tokens": max_new_tokens})
        if code != 200:
            raise _remote_error(code, resp)
        return resp

    def cancel(self, name: str, rid: str) -> bool:
        """Cancel an in-flight generation by request id; True when it was
        live (False: already finished)."""
        if self._server is None:
            return bool(self._http("POST", f"/cancel/{name}",
                                   {"rid": rid}).get("cancelled"))
        return self._server.cancel_generation(name, rid)

    def stats(self, name: Optional[str] = None):
        if self._server is None:
            return self._http("GET", "/stats" if name is None
                              else f"/stats/{name}")
        return self._server.stats(name)


_SSE_ERRORS = {"ServerClosedError": ServerClosedError,
               "OverloadedError": OverloadedError,
               "DeadlineExceededError": DeadlineExceededError,
               "ReplicaDeadError": ReplicaDeadError,
               "RequestCancelledError": RequestCancelledError}


def next_sse_event(resp) -> Optional[Dict[str, Any]]:
    """Read ONE complete SSE data event from ``resp`` (anything with a
    ``readline()`` returning bytes): the decoded JSON dict, or None on EOF
    — a line the connection dropped mid-write (no newline, or truncated
    JSON) counts as EOF, never as a decode error."""
    buf = b""
    while True:
        piece = resp.readline()
        if not piece:           # EOF mid-line: a torn write
            return None
        buf += piece
        if not buf.endswith(b"\n"):
            continue            # a partial line: keep reading
        line = buf.decode("utf-8", "replace").strip()
        buf = b""
        if not line.startswith("data:"):
            continue            # blank separator or comment line
        try:
            event = json.loads(line[len("data:"):].strip())
        except ValueError:
            return None         # a torn JSON tail
        if isinstance(event, dict):
            return event


def sse_events(resp):
    """Generator over one SSE response: yields ints (tokens), raises the
    mapped exception on an error event, returns on the done event.  A
    connection that drops without a done event raises
    :class:`ReplicaDeadError` (tokens were already seen, so it is not
    retried here: the fleet Router's migration is what resumes safely)."""
    done = False
    try:
        while True:
            event = next_sse_event(resp)
            if event is None:
                break
            if "token" in event:
                yield int(event["token"])
            elif "error" in event:
                raise _SSE_ERRORS.get(event.get("type", ""), MXNetError)(
                    event["error"])
            elif event.get("done"):
                done = True
                return
    finally:
        resp.close()
    if not done:
        raise ReplicaDeadError(
            "stream closed by replica before completion (connection reset)")


# ---------------------------------------------------------------------------
# HTTP plumbing (stdlib http.server; JSON bodies both ways)
# ---------------------------------------------------------------------------
def _make_handler(server: ModelServer):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet by default
            pass

        def _reply(self, code: int, payload: Dict[str, Any]):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if code == 503:
                self.send_header("Retry-After", str(max(1, int(round(
                    payload.get("retry_after_s", 1.0))))))
            self.end_headers()
            self.wfile.write(body)

        def _reply_stream(self, stream: TokenStream):
            """One SSE event per token as the step loop produces it.
            HTTP/1.0 with Connection: close: the closed socket ends the
            stream."""
            self.protocol_version = "HTTP/1.0"
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()

            def emit(event: Dict[str, Any]):
                self.wfile.write(b"data: " + json.dumps(event).encode()
                                 + b"\n\n")
                self.wfile.flush()

            tokens = []
            try:
                for tok in stream.events():
                    tokens.append(tok)
                    try:
                        emit({"token": tok})
                    except OSError:
                        # the client walked away: cancel so that the
                        # scheduler frees the slot and its pages now
                        self._cancel_abandoned(stream)
                        return
            except Exception as e:  # noqa: BLE001 - relay the typed error
                try:
                    emit({"error": str(e), "type": type(e).__name__})
                except OSError:
                    pass  # both sides gone
            else:
                try:
                    emit({"done": True, "tokens": tokens})
                except OSError:
                    pass  # finished anyway; nothing to cancel

        @staticmethod
        def _cancel_abandoned(stream: TokenStream):
            if stream.rid is None:
                return
            for gen in list(server._generators.values()):
                if gen.scheduler.cancel(stream.rid):
                    return

        def do_GET(self):
            if self.path == "/ping":
                # DRAINING answers 503 so load balancers pull the instance
                payload = server.ping_payload()
                self._reply(503 if payload["status"] == "DRAINING" else 200,
                            payload)
            elif self.path == "/fleet/state":
                self._reply(200, server.fleet_state())
            elif self.path == "/metrics":
                # exemplars are legal only in OpenMetrics: a classic 0.0.4
                # scraper gets an exemplar-free body
                accept = self.headers.get("Accept", "")
                openmetrics = "application/openmetrics-text" in accept
                text = server.metrics_text(exemplars=openmetrics)
                if openmetrics:
                    ctype = ("application/openmetrics-text; version=1.0.0; "
                             "charset=utf-8")
                    text += "# EOF\n"
                else:
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                body = text.encode()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/goodput":
                self._reply(200, json.loads(json.dumps(
                    server.goodput_snapshot(), default=repr)))
            elif self.path == "/stats":
                self._reply(200, json.loads(json.dumps(
                    server.stats(), default=repr)))
            elif self.path.startswith("/stats/"):
                try:
                    snap = server.stats(self.path[len("/stats/"):])
                except MXNetError as e:
                    self._reply(404, {"error": str(e)})
                else:
                    self._reply(200, json.loads(json.dumps(snap,
                                                           default=repr)))
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            parent = parent_from_headers(self.headers)
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("request body must be a JSON object, "
                                     f"got {type(req).__name__}")
            except Exception as e:  # noqa: BLE001 - a malformed body
                self._reply(400, {"error": repr(e)})
                return
            if self.path.startswith("/generate/"):
                name = self.path[len("/generate/"):]
                if req.get("stream"):
                    code, payload = server.handle_generate_stream(
                        name, req, parent=parent)
                    if isinstance(payload, TokenStream):
                        self._reply_stream(payload)
                    else:
                        self._reply(code, payload)
                    return
                self._reply(*server.handle_generate(name, req,
                                                    parent=parent))
            elif self.path.startswith("/cancel/"):
                self._reply(*server.handle_cancel(
                    self.path[len("/cancel/"):], req))
            elif self.path.startswith("/prefill/"):
                self._reply(*server.handle_prefill(
                    self.path[len("/prefill/"):], req, parent=parent))
            elif self.path.startswith("/export/"):
                self._reply(*server.handle_export(
                    self.path[len("/export/"):], req))
            elif self.path.startswith("/predict/"):
                self._reply(*server.handle_predict(
                    self.path[len("/predict/"):], req,
                    deadline_ms=req.get("deadline_ms"), parent=parent))
            else:
                self._reply(404, {"error": f"no route {self.path}"})

    return Handler
