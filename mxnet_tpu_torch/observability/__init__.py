"""``mxnet_tpu_torch.observability`` — metrics, causal tracing, flight
recorder, goodput and memory ledgers, and the serving numerics sentinel.

Counterpart of ``mxnet_tpu/observability/__init__.py``:

* :mod:`metrics` — typed Counter/Gauge/Histogram families in a
  process-global registry; Prometheus 0.0.4 and OpenMetrics text
  (``ModelServer`` serves ``GET /metrics``);
* :mod:`tracing` — trace/span trees with contextvar parenting and explicit
  cross-thread handoff, flow events, tail-based retention;
* :mod:`flight_recorder` — an always-on bounded ring of recent spans, log
  records and metric snapshots, dumped as a JSON post-mortem on a fatal
  resilience failure;
* :mod:`goodput` — per-request and per-step wall-time attribution that
  reconciles against measured wall;
* :mod:`memory` — the live-bytes ledger with a high-water mark;
* :mod:`health` — the training health sentinel (in-step watchpoints,
  NaN/Inf localization, divergence checksums, spike detection) and the
  serving decode-path sentinel.

Env knobs (declared in ``base.py``): ``MXNET_TPU_FLIGHT_CAPACITY``,
``MXNET_TPU_FLIGHT_DIR``, ``MXNET_TPU_TRACE_RETAIN_PCT``,
``MXNET_TPU_TRACE_RETAIN_CAP``, ``MXNET_TPU_TRACE_PENDING_CAP``,
``MXNET_TPU_GOODPUT_RECORDS``, ``MXNET_TPU_HEALTH``,
``MXNET_TPU_HEALTH_EVERY``, ``MXNET_TPU_HEALTH_ACTION``,
``MXNET_TPU_HEALTH_WINDOW``, ``MXNET_TPU_HEALTH_ZSCORE``,
``MXNET_TPU_HEALTH_CHECKSUM_EVERY``.
"""
from __future__ import annotations

from . import metrics, tracing, flight_recorder, goodput, memory, health
from .metrics import (Baselined, registry, render_prometheus, snapshot,
                      aggregate_all)
from .tracing import (Span, SpanContext, span, start_span, current_context,
                      flow_start, flow_end, retained_traces,
                      export_chrome_trace)
from .flight_recorder import get as get_flight_recorder, notify_fatal
from .goodput import train as train_ledger, serving as serving_ledger
from .memory import ledger as memory_ledger
from .health import NumericsError, ledger as health_ledger

__all__ = [
    "metrics", "tracing", "flight_recorder", "goodput", "memory", "health",
    "registry", "render_prometheus", "snapshot", "aggregate_all", "Baselined",
    "Span", "SpanContext", "span", "start_span", "current_context",
    "flow_start", "flow_end", "retained_traces", "export_chrome_trace",
    "get_flight_recorder", "notify_fatal",
    "train_ledger", "serving_ledger", "memory_ledger",
    "NumericsError", "health_ledger",
]
