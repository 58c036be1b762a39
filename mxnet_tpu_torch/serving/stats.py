"""Per-model serving statistics: completed, failed, shed and expired
requests, executed batches and their shapes (the occupancy and bucket-use
histograms), the queue depth, request latencies (nearest-rank percentiles
over a bounded recent window) and the exemplar that explains the p99.
``snapshot(cache_stats)`` adds the model's CachedOp counters.

Counterpart of ``mxnet_tpu/serving/stats.py``.  The scalar counts and the
latency distribution live in the process-global metrics registry as
``mxnet_tpu_serving_*`` families labelled by model (what ``GET /metrics``
scrapes, cumulative across server restarts as Prometheus requires); this
object reads them back through
:class:`~mxnet_tpu_torch.observability.metrics.Baselined`, so a fresh
instance starts at zero.  Each request's latency is observed with its
trace id as the OpenMetrics exemplar.  The percentile reservoir, the
histograms and the host seconds per batch stage stay instance-local.
When the profiler collects, requests and batches also land in its event
stream as counter samples.

Beyond the JAX package's keys, a snapshot carries ``queue_depth`` and the
batcher's host milliseconds per stage (``batch_stage_ms_mean`` /
``batch_stage_ms_max``: pack, execute, split).
"""
from __future__ import annotations

import threading
import time
from collections import Counter, deque
from typing import Dict, List, Optional

from ..observability import metrics as _metrics
from ..observability.metrics import Baselined

__all__ = ["ServingStats", "percentile"]

_REG = _metrics.registry()
_M_REQUESTS = _REG.counter(
    "mxnet_tpu_serving_requests_total",
    "Requests completed successfully (enqueue to future resolution).",
    labels=("model",))
_M_ERRORS = _REG.counter(
    "mxnet_tpu_serving_errors_total",
    "Requests that resolved with an exception.", labels=("model",))
_M_SHEDS = _REG.counter(
    "mxnet_tpu_serving_sheds_total",
    "Submissions rejected by admission control (queue full / open breaker).",
    labels=("model",))
_M_EXPIRED = _REG.counter(
    "mxnet_tpu_serving_expired_total",
    "Requests whose deadline passed while queued.", labels=("model",))
_M_BATCHES = _REG.counter(
    "mxnet_tpu_serving_batches_total",
    "Batches executed by the dynamic batcher.", labels=("model",))
_M_ROWS = _REG.counter(
    "mxnet_tpu_serving_rows_total",
    "Sample rows executed (pre-padding).", labels=("model",))
_M_LATENCY = _REG.histogram(
    "mxnet_tpu_serving_request_latency_seconds",
    "Request latency, enqueue to future resolution.  µs-resolved ladder "
    "(10µs doubling to ~84s): the host-staged warm path bounds per-request "
    "overhead in µs, which the default 100µs floor could not resolve.",
    labels=("model",), bucket_start=1e-5, bucket_factor=2.0,
    bucket_count=24)
_M_QUEUE_DEPTH = _REG.gauge(
    "mxnet_tpu_serving_queue_depth",
    "Requests currently pending in the batcher queue.", labels=("model",))


def percentile(sorted_values: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list (0 when empty)."""
    if not sorted_values:
        return 0.0
    rank = max(0, min(len(sorted_values) - 1,
                      int(round(q / 100.0 * (len(sorted_values) - 1)))))
    return float(sorted_values[rank])


class ServingStats:
    """Thread-safe rollup of one model's serving activity.  Two live
    instances for one model name (two servers in one process) share the
    registry's series, so each one's view includes the other's traffic."""

    WINDOW = 8192  # latency reservoir: percentiles describe recent traffic

    def __init__(self, model: str = ""):
        self.model = model
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        label = model or "default"
        self._m = {
            "requests": Baselined(_M_REQUESTS.labels(model=label)),
            "errors": Baselined(_M_ERRORS.labels(model=label)),
            "sheds": Baselined(_M_SHEDS.labels(model=label)),
            "expired": Baselined(_M_EXPIRED.labels(model=label)),
            "batches": Baselined(_M_BATCHES.labels(model=label)),
            "rows": Baselined(_M_ROWS.labels(model=label)),
        }
        self._m_latency = _M_LATENCY.labels(model=label)
        self.queue_depth_gauge = _M_QUEUE_DEPTH.labels(model=label)
        self._latencies_us: deque = deque(maxlen=self.WINDOW)
        self._occupancy: Counter = Counter()   # requests-per-batch histogram
        self._bucket_use: Counter = Counter()  # padded-shape histogram
        self._batch_s = Counter()  # host seconds per batch stage, summed
        self._batch_s_max: Dict[str, float] = {}
        self._counters = None  # profiler counters, made on first use

    def _profiler_counters(self):
        if self._counters is None:
            from .. import profiler
            dom = profiler.Domain(f"serving:{self.model}" if self.model
                                  else "serving")
            self._counters = (dom.new_counter("requests"),
                              dom.new_counter("batches"))
        return self._counters

    def record_request(self, latency_us: float,
                       trace_id: Optional[int] = None) -> None:
        with self._lock:
            self._m["requests"].inc()
            # the exemplar: each latency bucket remembers the most recent
            # trace that crossed it (GET /metrics, OpenMetrics dialect)
            self._m_latency.observe(
                float(latency_us) / 1e6,
                exemplar=({"trace_id": trace_id} if trace_id is not None
                          else None))
            self._latencies_us.append(float(latency_us))
        self._profiler_counters()[0].increment()

    def record_error(self) -> None:
        self._m["errors"].inc()

    def record_shed(self) -> None:
        self._m["sheds"].inc()

    def record_expired(self) -> None:
        self._m["expired"].inc()

    def record_batch(self, n_requests: int, rows: int, bucket: int,
                     **stage_s: float) -> None:
        """One executed batch; ``stage_s`` are its host seconds by stage
        (the batcher's ``pack``, ``execute`` and ``split``)."""
        with self._lock:
            self._m["batches"].inc()
            self._m["rows"].inc(int(rows))
            self._batch_s.update(stage_s)
            for k, v in stage_s.items():
                self._batch_s_max[k] = max(v, self._batch_s_max.get(k, 0.0))
            self._occupancy[int(n_requests)] += 1
            self._bucket_use[int(bucket)] += 1
        self._profiler_counters()[1].increment()

    def _p99_exemplar(self) -> Optional[Dict]:
        """The most recent trace observed at or above the p99 bucket of the
        latency histogram (None until one lands there).  The bucket comes
        from the same quantile scan the retention threshold uses, so its
        trace id resolves in the retained-trace store."""
        try:
            idx = self._m_latency.quantile_bucket_index(0.99)
            if idx is None:
                return None
            best = None
            for i, (le, ex) in enumerate(self._m_latency.exemplars()):
                if i >= idx and ex is not None:
                    labels, v, ts = ex
                    best = {"le": None if le == float("inf") else le,
                            "value_seconds": v, "t_unix": ts, **labels}
            return best
        except Exception:  # noqa: BLE001 - reporting must never break /stats
            return None

    def snapshot(self, cache_stats: Optional[Dict] = None) -> Dict:
        """The counters, percentiles and histograms; with ``cache_stats``
        (a CachedOp's), also ``compile_cache``, its signatures as
        strings."""
        with self._lock:
            elapsed = max(1e-9, time.monotonic() - self._t0)
            lat = sorted(self._latencies_us)
            requests = int(self._m["requests"].value)
            batches = int(self._m["batches"].value)
            snap = {
                "model": self.model,
                "requests": requests,
                "errors": int(self._m["errors"].value),
                "sheds": int(self._m["sheds"].value),
                "expired": int(self._m["expired"].value),
                "queue_depth": int(self.queue_depth_gauge.value),
                "batches": batches,
                "rows": int(self._m["rows"].value),
                "qps": requests / elapsed,
                "latency_us_p50": percentile(lat, 50),
                "latency_us_p95": percentile(lat, 95),
                "latency_us_p99": percentile(lat, 99),
                "batch_occupancy": dict(self._occupancy),
                "bucket_use": dict(self._bucket_use),
                "mean_requests_per_batch": (
                    requests / batches if batches else 0.0),
                "batch_stage_ms_mean": {
                    k: 1e3 * v / batches
                    for k, v in self._batch_s.items()} if batches else {},
                "batch_stage_ms_max": {
                    k: 1e3 * v for k, v in self._batch_s_max.items()},
                "p99_exemplar": self._p99_exemplar(),
            }
        if cache_stats is not None:
            snap["compile_cache"] = {k: v for k, v in cache_stats.items()
                                     if k != "signatures"}
            snap["compile_cache"]["signatures"] = [
                repr(sig) for sig in cache_stats.get("signatures", [])]
        return snap

    def reset(self) -> None:
        with self._lock:
            self._t0 = time.monotonic()
            for b in self._m.values():
                b.rebase()
            self._latencies_us.clear()
            self._occupancy.clear()
            self._bucket_use.clear()
            self._batch_s.clear()
            self._batch_s_max.clear()
