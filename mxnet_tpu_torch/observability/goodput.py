"""Goodput ledger: wall-time attribution for serving requests and train
steps.

Counterpart of ``mxnet_tpu/observability/goodput.py``:

* **Serving ledger** — per-request decomposition (:data:`SERVING_BUCKETS`):
  ``queue`` (enqueue → the request's batch dispatches), ``pack`` (host
  staging and the copy to the card), ``execute`` (the engine run),
  ``split`` (per-request output fan-out), ``stream`` (generation: retire →
  future resolution), ``other`` (the exact residual to the measured
  request wall).  Counters are request-seconds (co-batched requests each
  account the shared batch phases, like latency sums do).  On the card a
  replay returns once its work is queued, so ``execute`` holds the launch
  and the device time lands in the first bucket that waits for the
  result: ``split``'s first copy to the host for a request that asked for
  host outputs (the HTTP path).  The reconciliation (buckets + ``other``
  == wall) holds either way.

* **Train ledger** — the driver's critical path by bucket
  (:data:`TRAIN_BUCKETS`) with :meth:`Ledger.timed` intervals that split
  nested self time exactly, :meth:`TrainLedger.step` and
  :meth:`TrainLedger.window` reconciliations.  The call sites are the JAX
  package's: ``CompiledTrainStep`` (one ``step`` record per call:
  ``dispatch``, ``compile``, ``device_compute``), ``CachedOp``
  (``compile``, ``device_compute``), the dist kvstore's collective guard
  (``collective``) and ``AsyncCheckpointer.save`` (``checkpoint``, the
  wait for the previous write) and ``DevicePrefetchIter`` (``input_wait``,
  the consumer's wait for a staged batch); ``Estimator.fit`` reconciles
  its run in a ``window('fit')``.  On the card a replay returns
  once queued, so a step's device time lands in whatever waits for it
  first: the health fetch (``other``), the next call's staging, or the
  caller's own copy after the record closes.

* **Tail attribution** — request completion *offers* its trace to
  tail-based retention: kept in full only when the wall time reaches the
  ``MXNET_TPU_TRACE_RETAIN_PCT`` percentile of its own latency histogram
  (threshold = lower edge of the quantile bucket).  Retained traces live in
  :mod:`.tracing`'s bounded store, exportable as chrome-trace JSON.

Metrics::

    mxnet_tpu_goodput_train_seconds_total{bucket=...}
    mxnet_tpu_goodput_train_wall_seconds_total
    mxnet_tpu_goodput_train_ratio
    mxnet_tpu_goodput_serving_seconds_total{model=...,bucket=...}
    mxnet_tpu_goodput_serving_wall_seconds_total{model=...}
    mxnet_tpu_goodput_traces_offered_total / _retained_total
"""
from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Optional

from ..base import env as _env
from . import metrics as _metrics
from . import tracing as _tracing

__all__ = ["TRAIN_BUCKETS", "SERVING_BUCKETS", "train", "serving",
           "TrainLedger", "ServingLedger"]

TRAIN_BUCKETS = ("input_wait", "dispatch", "compile", "device_compute",
                 "collective", "checkpoint", "reform", "other")
SERVING_BUCKETS = ("queue", "pack", "execute", "split", "stream", "other")

_REG = _metrics.registry()
_M_TRAIN = _REG.counter(
    "mxnet_tpu_goodput_train_seconds_total",
    "Train-driver critical-path seconds attributed by bucket (input_wait/"
    "compile/device_compute/collective/checkpoint/reform/other); 'other' is "
    "the exact per-step residual, so buckets sum to step wall.",
    labels=("bucket",))
_M_TRAIN_WALL = _REG.counter(
    "mxnet_tpu_goodput_train_wall_seconds_total",
    "Wall seconds inside compiled train-step calls (the denominator the "
    "per-step bucket decomposition reconciles against).")
_M_TRAIN_RATIO = _REG.gauge(
    "mxnet_tpu_goodput_train_ratio",
    "Cumulative goodput: productive device-compute seconds over all "
    "attributed train-driver seconds (updated at every step).")
_M_SERVING = _REG.counter(
    "mxnet_tpu_goodput_serving_seconds_total",
    "Request-seconds attributed by bucket (queue/pack/execute/split/stream/"
    "other); co-batched requests each account the shared batch phases, so "
    "per model the buckets sum to the request-latency sum.",
    labels=("model", "bucket"))
_M_SERVING_WALL = _REG.counter(
    "mxnet_tpu_goodput_serving_wall_seconds_total",
    "Request wall seconds (enqueue to future resolution) the serving "
    "bucket decomposition reconciles against.", labels=("model",))
_M_OFFERED = _REG.counter(
    "mxnet_tpu_goodput_traces_offered_total",
    "Completed requests/steps offered to tail-based trace retention.")
_M_RETAINED = _REG.counter(
    "mxnet_tpu_goodput_traces_retained_total",
    "Traces promoted to the retained store (wall time at or above the "
    "MXNET_TPU_TRACE_RETAIN_PCT percentile of their own histogram).")

# thread-local stack of open attribution intervals: [ledger, child_seconds].
# The innermost same-ledger frame accumulates children so a parent can
# attribute self-time only; a frame owned by a DIFFERENT ledger swallows
# nested intervals entirely (its caller records the request-level split).
_tls = threading.local()


def _stack():
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


class Ledger:
    """Shared attribution machinery (see module docstring)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._records: deque = deque(
            maxlen=max(int(_env.MXNET_TPU_GOODPUT_RECORDS), 1))

    def _count(self, bucket: str, seconds: float, model: Optional[str]):
        raise NotImplementedError

    @contextmanager
    def timed(self, bucket: str, model: Optional[str] = None):
        """Attribute this interval's SELF time to ``bucket``.  Nested
        same-ledger intervals split exactly (parent gets wall minus
        children); under another ledger's interval this is a no-op."""
        stack = _stack()
        if stack and stack[-1][0] is not self:
            yield
            return
        frame = [self, 0.0]
        stack.append(frame)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            stack.pop()
            self._count(bucket, max(dt - frame[1], 0.0), model)
            if stack and stack[-1][0] is self:
                stack[-1][1] += dt

    @contextmanager
    def owned(self):
        """Mark this interval as owned by this ledger WITHOUT attributing
        it (the caller records the request-level decomposition itself);
        nested intervals from other ledgers become no-ops."""
        stack = _stack()
        stack.append([self, 0.0])
        try:
            yield
        finally:
            stack.pop()

    def records(self):
        with self._lock:
            return list(self._records)


def _quantile_threshold(family_name: str, q: float,
                        model: Optional[str] = None) -> float:
    fam = _REG.get(family_name)
    if fam is None:
        return 0.0
    try:
        child = (fam.labels(model=model) if model is not None
                 else fam._one())
        return child.quantile_lower(q)
    except Exception:  # noqa: BLE001 — retention must never break serving
        return 0.0


def _offer_tail(trace_id: Optional[int], wall: float, threshold: float,
                meta: Dict[str, Any]) -> bool:
    """Retain the trace when its wall time reaches the percentile
    threshold; drop its pending spans otherwise.  Returns True on retain."""
    if trace_id is None:
        return False
    _M_OFFERED.inc()
    pct = float(_env.MXNET_TPU_TRACE_RETAIN_PCT)
    if 0 < pct and wall < threshold:
        _tracing.discard_trace(trace_id)
        return False
    if _tracing.retain_trace(trace_id, meta=meta):
        _M_RETAINED.inc()
        return True
    return False


class TrainLedger(Ledger):
    """Attribution for the training driver (one per process)."""

    def __init__(self):
        super().__init__()
        self._cum = {b: 0.0 for b in TRAIN_BUCKETS}
        self._wall = 0.0
        self.last_step: Optional[Dict[str, Any]] = None
        self.last_window: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------- counting
    def _count(self, bucket: str, seconds: float, model=None):
        self.attribute(bucket, seconds)

    def attribute(self, bucket: str, seconds: float) -> None:
        s = float(seconds)
        if s <= 0.0:
            return
        with self._lock:
            self._cum[bucket] = self._cum.get(bucket, 0.0) + s
        _M_TRAIN.labels(bucket=bucket).inc(s)

    def _snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._cum)

    def totals(self) -> Dict[str, Any]:
        with self._lock:
            return {"buckets": dict(self._cum), "step_wall_seconds": self._wall}

    # ------------------------------------------------------------- windows
    @contextmanager
    def step(self, steps: int = 1):
        """One executor call: reconciles in-call bucket attributions against
        the call's measured wall (``other`` is the exact residual) and
        offers the step's trace to tail retention.  The yielded dict takes
        ``trace_id`` (the execute span's trace) and ``steps`` (when only
        known mid-call) from the caller.  Reentrant calls (a wrapped step
        driving an inner step) only account once."""
        if getattr(_tls, "in_step", False):
            yield {}
            return
        _tls.in_step = True
        base = self._snapshot()
        info: Dict[str, Any] = {"trace_id": None, "steps": int(steps)}
        t0 = time.perf_counter()
        try:
            yield info
        finally:
            _tls.in_step = False
            wall = time.perf_counter() - t0
            cur = self._snapshot()
            buckets = {b: cur[b] - base[b] for b in TRAIN_BUCKETS
                       if b != "other" and cur[b] - base[b] > 0.0}
            other = max(wall - sum(buckets.values()), 0.0)
            buckets["other"] = other
            self.attribute("other", other)
            _M_TRAIN_WALL.inc(wall)
            rec = {"kind": "train_step", "steps": int(info.get("steps", steps)),
                   "t_unix": time.time(),
                   "wall_seconds": wall, "buckets": buckets,
                   "goodput_ratio": (buckets.get("device_compute", 0.0) / wall
                                     if wall > 0 else 0.0),
                   "trace_id": info.get("trace_id")}
            with self._lock:
                self._wall += wall
                self.last_step = rec
                self._records.append(rec)
                attributed = sum(self._cum.values())
                ratio = (self._cum["device_compute"] / attributed
                         if attributed > 0 else 0.0)
            _M_TRAIN_RATIO.set(ratio)
            pct = float(_env.MXNET_TPU_TRACE_RETAIN_PCT)
            thr = _quantile_threshold("mxnet_tpu_executor_step_seconds",
                                      pct / 100.0)
            # compare the same quantity the histogram observed (the caller
            # passes it via hist_seconds; the window wall additionally
            # includes dispatch/compile, which would bias every step over
            # a percentile computed from the narrower distribution)
            rec["retained"] = _offer_tail(
                info.get("trace_id"),
                float(info.get("hist_seconds", wall)), thr, rec)

    @contextmanager
    def window(self, label: str = "fit"):
        """A whole driver run (``Estimator.fit``, a bench loop): yields a
        dict filled at exit with the window's wall, per-bucket deltas, and
        the ``unattributed`` residual — the tested reconciliation surface
        (buckets + unattributed == wall, exactly)."""
        base = self._snapshot()
        with self._lock:
            base_wall = self._wall
        report: Dict[str, Any] = {}
        t0 = time.perf_counter()
        try:
            yield report
        finally:
            wall = time.perf_counter() - t0
            cur = self._snapshot()
            with self._lock:
                step_wall = self._wall - base_wall
            buckets = {b: cur[b] - base[b] for b in TRAIN_BUCKETS
                       if cur[b] - base[b] > 0.0}
            attributed = sum(buckets.values())
            report.update({
                "kind": "train_window", "label": label,
                "t_unix": time.time(),
                "wall_seconds": wall, "buckets": buckets,
                "attributed_seconds": attributed,
                "unattributed_seconds": wall - attributed,
                "step_wall_seconds": step_wall,
                "goodput_ratio": (buckets.get("device_compute", 0.0) / wall
                                  if wall > 0 else 0.0),
            })
            with self._lock:
                self.last_window = dict(report)


class ServingLedger(Ledger):
    """Per-request attribution for the serving planes (one per process)."""

    def __init__(self):
        super().__init__()
        self.last_request: Optional[Dict[str, Any]] = None

    def _count(self, bucket: str, seconds: float, model=None):
        if seconds <= 0.0:
            return
        _M_SERVING.labels(model=model or "default", bucket=bucket).inc(seconds)

    def record_request(self, model: str, wall_seconds: float,
                       buckets: Dict[str, float],
                       trace_id: Optional[int] = None,
                       attrs: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """One completed request: counts each bucket plus the exact
        ``other`` residual to the measured wall, and offers the request's
        trace to tail retention against its model's latency histogram."""
        label = model or "default"
        wall = max(float(wall_seconds), 0.0)
        clean = {b: max(float(s), 0.0) for b, s in buckets.items()
                 if float(s) > 0.0}
        other = max(wall - sum(clean.values()), 0.0)
        clean["other"] = other
        for b, s in clean.items():
            self._count(b, s, model=label)
        _M_SERVING_WALL.labels(model=label).inc(wall)
        rec = {"kind": "serving_request", "model": label,
               "t_unix": time.time(), "wall_seconds": wall,
               "buckets": clean, "trace_id": trace_id}
        if attrs:
            rec["attrs"] = dict(attrs)
        pct = float(_env.MXNET_TPU_TRACE_RETAIN_PCT)
        thr = _quantile_threshold(
            "mxnet_tpu_serving_request_latency_seconds", pct / 100.0,
            model=label)
        rec["retained"] = _offer_tail(trace_id, wall, thr, rec)
        with self._lock:
            self.last_request = rec
            self._records.append(rec)
        return rec

    def totals(self) -> Dict[str, Any]:
        fam = _REG.get("mxnet_tpu_goodput_serving_seconds_total")
        return {"bucket_seconds": dict(fam.sample_dict()) if fam else {}}


_TRAIN = TrainLedger()
_SERVING = ServingLedger()


def train() -> TrainLedger:
    """The process-global train-driver ledger."""
    return _TRAIN


def serving() -> ServingLedger:
    """The process-global serving ledger."""
    return _SERVING


def snapshot() -> Dict[str, Any]:
    """One machine-readable goodput view: cumulative train buckets, last
    step/window records, last serving request, and the retained-trace
    summaries (what ``GET /goodput`` renders)."""
    t = train()
    s = serving()
    return {
        "train": {"totals": t.totals(), "last_step": t.last_step,
                  "last_window": t.last_window},
        "serving": {"totals": s.totals(), "last_request": s.last_request},
        "tail": {"retain_pct": float(_env.MXNET_TPU_TRACE_RETAIN_PCT),
                 "offered": _M_OFFERED.value,
                 "retained": _M_RETAINED.value,
                 "traces": _tracing.retained_traces()},
    }
