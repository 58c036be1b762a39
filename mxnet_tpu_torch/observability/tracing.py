"""Causal tracing: Dapper-style trace/span trees over threads.

Counterpart of ``mxnet_tpu/observability/tracing.py``.  A **span** is one
timed operation with a ``trace_id`` (shared by every span of one request),
a unique ``span_id``, a ``parent_id`` link, and free-form attributes.
Parenting is ambient within a thread (a ``contextvars.ContextVar`` carries
the active span) and **explicit across threads**: a producer captures
:func:`current_context` and the consumer passes it as ``parent=`` (how the
serving batcher carries causality from the HTTP thread to its worker
thread, which runs the replays).

Emission is two-plane:

* **always-on**: every ended span lands in the flight recorder's bounded
  ring;
* **when the profiler collects** (``profiler.set_state('run')``): spans are
  appended to the chrome-trace event stream as ``X`` events whose ``args``
  carry ``trace_id``/``span_id``/``parent_id`` plus attributes, and
  cross-thread handoffs emit chrome flow events (:func:`flow_start` /
  :func:`flow_end`).

A span measures host time.  Around a CUDA graph replay, which returns once
the work is queued, it measures the launch; the device time shows up in
the first span that waits for the result.

Span taxonomy (the JAX package's names): ``http.predict``,
``http.generate``, ``serving.enqueue``, ``serving.batcher.pack/execute/
split``, ``serving.engine.predict``, ``serving.generation.prefill/decode``,
``cachedop.compile/execute``, ``trainstep.compile/execute``.
"""
from __future__ import annotations

import contextvars
import itertools
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

__all__ = ["Span", "SpanContext", "span", "start_span", "current_context",
           "current_span_info", "flow_start", "flow_end",
           "SPAN_SUBSYSTEMS", "retain_trace", "discard_trace",
           "retained_trace", "retained_traces", "export_chrome_trace"]

# registered span-name subsystems: every span name is `<subsystem>.<verb>`
# dotted form with the first segment drawn from this set (enforced by
# tests/test_torch_telemetry_lint.py so dashboards keyed on span prefixes
# survive refactors)
SPAN_SUBSYSTEMS = frozenset({
    "http", "serving", "cachedop", "trainstep", "kvstore", "io", "elastic",
    "health", "fleet",
})

_ids = itertools.count(1)
# itertools.count.__next__ is a single C call — atomic under the GIL, so no
# lock on the id hot path (every span takes 1-2 ids)
_new_id = _ids.__next__

_profiler = None  # resolved on first span; avoids per-span import machinery


def _get_profiler():
    global _profiler
    if _profiler is None:
        from .. import profiler
        _profiler = profiler
    return _profiler


_flight = None


def _recorder():
    global _flight
    if _flight is None:
        from . import flight_recorder
        _flight = flight_recorder.get()
    return _flight


class SpanContext:
    """Immutable (trace_id, span_id) handle — what crosses thread/queue
    boundaries.  Cheap enough to stash on every queued request."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: int, span_id: int):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):
        return f"SpanContext(trace={self.trace_id}, span={self.span_id})"


_current: contextvars.ContextVar[Optional[SpanContext]] = \
    contextvars.ContextVar("mxnet_tpu_span", default=None)

# open spans by span_id (name only) — lets the flight recorder name the
# failing span at crash time without holding Span references.  Plain dict
# item set/del are single C ops (GIL-atomic); keys are unique ids, so no
# lock on the per-span path
_OPEN: Dict[int, str] = {}


def current_context() -> Optional[SpanContext]:
    """The calling thread's active span context (None outside any span)."""
    return _current.get()


def current_span_info() -> Optional[Dict[str, Any]]:
    """``{trace_id, span_id, name}`` of the innermost open span on this
    thread — what a crash dump records as the failing span."""
    ctx = _current.get()
    if ctx is None:
        return None
    return {"trace_id": ctx.trace_id, "span_id": ctx.span_id,
            "name": _OPEN.get(ctx.span_id, "?")}


class Span:
    """One timed, attributed, parent-linked operation.  Use as a context
    manager (installs itself as the thread's ambient parent) or drive
    ``start()``/``end()`` manually for non-lexical lifetimes."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs",
                 "_t0_perf", "_t0_us", "_token", "_ended", "tid")

    def __init__(self, name: str, parent: Optional[object] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        if parent is None:
            parent = _current.get()
        if isinstance(parent, Span):
            parent = parent.context()
        self.name = name
        self.parent_id = parent.span_id if parent is not None else None
        self.trace_id = (parent.trace_id if parent is not None
                         else _new_id())
        self.span_id = _new_id()
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self._t0_perf = time.perf_counter()
        self._token = None
        self._ended = False
        self.tid = threading.get_ident()
        self._t0_us = (self._t0_perf - _get_profiler()._t_origin) * 1e6
        _OPEN[self.span_id] = name

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def set_attr(self, key: str, value: Any) -> "Span":
        self.attrs[key] = value
        return self

    def __enter__(self) -> "Span":
        self._token = _current.set(self.context())
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        if exc is not None:
            self.attrs.setdefault("error", f"{type(exc).__name__}: {exc}")
        self.end()
        return False

    def end(self) -> None:
        if self._ended:
            return
        self._ended = True
        dur_us = (time.perf_counter() - self._t0_perf) * 1e6
        _OPEN.pop(self.span_id, None)
        record = {
            "name": self.name, "trace_id": self.trace_id,
            "span_id": self.span_id, "parent_id": self.parent_id,
            "ts_us": self._t0_us, "dur_us": dur_us, "tid": self.tid,
            "attrs": self.attrs,
        }
        _note_span(record)
        _recorder().record_span(record)
        profiler = _get_profiler()
        if profiler.collecting():
            profiler._append_event({
                "name": self.name, "cat": "span", "ph": "X",
                "ts": self._t0_us, "dur": dur_us,
                "pid": os.getpid(), "tid": self.tid,
                "args": {"trace_id": self.trace_id, "span_id": self.span_id,
                         "parent_id": self.parent_id, **self.attrs},
            })


def span(name: str, attrs: Optional[Dict[str, Any]] = None,
         parent: Optional[object] = None) -> Span:
    """``with span("cachedop.execute", {"cache": "hit"}):`` — child of the
    ambient span unless ``parent`` (a Span or SpanContext) is given."""
    return Span(name, parent=parent, attrs=attrs)


def start_span(name: str, attrs: Optional[Dict[str, Any]] = None,
               parent: Optional[object] = None) -> Span:
    """Non-lexical span (caller must call :meth:`Span.end`)."""
    return Span(name, parent=parent, attrs=attrs)


# ---------------------------------------------------------------------------
# chrome-trace flow events: the visual arrow for a cross-thread handoff
# ---------------------------------------------------------------------------
def _flow_event(ph: str, flow_id: int, name: str) -> None:
    profiler = _get_profiler()
    if not profiler.collecting():
        return
    ev = {"name": name, "cat": "handoff", "ph": ph, "id": flow_id,
          "ts": profiler._now_us(), "pid": os.getpid(),
          "tid": threading.get_ident()}
    if ph == "f":
        ev["bp"] = "e"  # bind to the enclosing slice's end
    profiler._append_event(ev)


def flow_start(name: str = "handoff") -> int:
    """Mark the producing side of a handoff (e.g. enqueue); returns the flow
    id the consumer passes to :func:`flow_end`."""
    fid = _new_id()
    _flow_event("s", fid, name)
    return fid


def flow_end(flow_id: Optional[int], name: str = "handoff") -> None:
    """Mark the consuming side of a handoff (e.g. the batcher dequeue)."""
    if flow_id is not None:
        _flow_event("f", flow_id, name)


# ---------------------------------------------------------------------------
# tail-based trace retention: full trace slices only for the requests/steps
# worth explaining (Dean & Barroso '13 — the p99 must always have a trace)
# ---------------------------------------------------------------------------
# Every ended span parks under its trace_id in a bounded PENDING store; the
# goodput ledger decides at request/step completion whether the trace was
# slow enough to promote into the bounded RETAINED store (everything else is
# dropped), so steady-state trace overhead is O(caps), not O(traffic).
_trace_lock = threading.Lock()
_pending: "OrderedDict[int, List[Dict[str, Any]]]" = OrderedDict()
_retained: "OrderedDict[int, Dict[str, Any]]" = OrderedDict()
# traces whose retention verdict was "drop": the request's ROOT span
# (http.predict/generate) ends AFTER the worker thread decides, so without
# this tombstone every completed request would re-open an orphan pending
# entry — and under load those orphans would LRU-evict the span buffers of
# requests still in flight, breaking the p99-always-explainable guarantee
_dropped: "OrderedDict[int, None]" = OrderedDict()
_PENDING_SPAN_CAP = 512   # spans kept per pending trace (runaway guard)
_DROPPED_CAP = 4096       # discard tombstones (small: ints only)


def _caps():
    from ..base import env
    return (int(env.MXNET_TPU_TRACE_PENDING_CAP),
            int(env.MXNET_TPU_TRACE_RETAIN_CAP))


def _note_span(record: Dict[str, Any]) -> None:
    try:
        pending_cap, _ = _caps()
    except Exception:  # pragma: no cover — env not ready at import time
        return
    if pending_cap <= 0:
        return
    tid = record["trace_id"]
    with _trace_lock:
        kept = _retained.get(tid)
        if kept is not None:
            # a straggler span of an already-retained trace (typically the
            # request's root span): complete the retained slice in place
            if len(kept["spans"]) < _PENDING_SPAN_CAP:
                kept["spans"].append(record)
            return
        if tid in _dropped:
            return  # trace already judged below threshold: stay dropped
        q = _pending.get(tid)
        if q is None:
            while len(_pending) >= pending_cap:
                _pending.popitem(last=False)
            q = _pending[tid] = []
        else:
            _pending.move_to_end(tid)
        if len(q) < _PENDING_SPAN_CAP:
            q.append(record)


def retain_trace(trace_id: int,
                 meta: Optional[Dict[str, Any]] = None) -> bool:
    """Promote a pending trace into the retained store (evicting oldest
    retained beyond the cap).  Returns True when spans were found."""
    _, retain_cap = _caps()
    with _trace_lock:
        spans = _pending.pop(trace_id, None)
        if not spans or retain_cap <= 0:
            return False
        while len(_retained) >= retain_cap:
            _retained.popitem(last=False)
        _retained[trace_id] = {"trace_id": trace_id, "t_unix": time.time(),
                               "meta": dict(meta) if meta else {},
                               "spans": spans}
        return True


def discard_trace(trace_id: int) -> None:
    """Drop a pending trace that completed below the retention threshold
    (and tombstone it so its late root span doesn't re-open an entry)."""
    with _trace_lock:
        _pending.pop(trace_id, None)
        _dropped[trace_id] = None
        while len(_dropped) > _DROPPED_CAP:
            _dropped.popitem(last=False)


def retained_trace(trace_id: int) -> Optional[Dict[str, Any]]:
    with _trace_lock:
        t = _retained.get(trace_id)
        return dict(t) if t is not None else None


def retained_traces() -> List[Dict[str, Any]]:
    """Summaries of every retained trace, oldest first."""
    with _trace_lock:
        return [{"trace_id": t["trace_id"], "t_unix": t["t_unix"],
                 "meta": dict(t["meta"]), "n_spans": len(t["spans"])}
                for t in _retained.values()]


def export_chrome_trace(trace_id: Optional[int] = None) -> Dict[str, Any]:
    """Retained trace slices as a chrome-trace JSON object (viewer-loadable
    in Perfetto): one ``X`` slice per span, args carrying the causal ids —
    the same shape ``profiler.dump()`` writes, minus the op events."""
    with _trace_lock:
        traces = ([_retained[trace_id]] if trace_id is not None
                  and trace_id in _retained else
                  [] if trace_id is not None else list(_retained.values()))
    events = []
    for t in traces:
        for s in t["spans"]:
            events.append({
                "name": s["name"], "cat": "span", "ph": "X",
                "ts": s["ts_us"], "dur": s["dur_us"],
                "pid": os.getpid(), "tid": s["tid"],
                "args": {"trace_id": s["trace_id"], "span_id": s["span_id"],
                         "parent_id": s["parent_id"], **s["attrs"]},
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _reset_retention() -> None:
    """Test isolation: drop every pending/retained trace and tombstone."""
    with _trace_lock:
        _pending.clear()
        _retained.clear()
        _dropped.clear()
