"""Per-model serving statistics: completed, failed, shed and expired
requests, executed batches and their shapes (the occupancy and bucket-use
histograms), the queue depth, and request latencies (nearest-rank
percentiles over a bounded recent window).  ``snapshot(cache_stats)`` adds
the model's CachedOp counters.

Counterpart of ``mxnet_tpu/serving/stats.py`` without the metrics
registry, exemplars and profiler counters, which wait for the
observability slice.
"""
from __future__ import annotations

import threading
import time
from collections import Counter, deque
from typing import Dict, List, Optional

__all__ = ["ServingStats", "percentile"]


def percentile(sorted_values: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list (0 when empty)."""
    if not sorted_values:
        return 0.0
    rank = max(0, min(len(sorted_values) - 1,
                      int(round(q / 100.0 * (len(sorted_values) - 1)))))
    return float(sorted_values[rank])


class ServingStats:
    """Thread-safe rollup of one model's serving activity."""

    WINDOW = 8192  # latency reservoir: percentiles describe recent traffic

    def __init__(self, model: str):
        self.model = model
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self.requests = 0
        self.errors = 0
        self.sheds = 0
        self.expired = 0
        self.batches = 0
        self.rows = 0
        self.queue_depth = 0
        self._latencies_us: deque = deque(maxlen=self.WINDOW)
        self._occupancy: Counter = Counter()   # requests-per-batch histogram
        self._bucket_use: Counter = Counter()  # padded-shape histogram
        self._batch_s = Counter()  # host seconds per batch stage, summed
        self._batch_s_max: Dict[str, float] = {}

    def record_request(self, latency_us: float) -> None:
        with self._lock:
            self.requests += 1
            self._latencies_us.append(float(latency_us))

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    def record_shed(self) -> None:
        with self._lock:
            self.sheds += 1

    def record_expired(self) -> None:
        with self._lock:
            self.expired += 1

    def record_batch(self, n_requests: int, rows: int, bucket: int,
                     **stage_s: float) -> None:
        """One executed batch; ``stage_s`` are its host seconds by stage
        (the batcher's ``pack``, ``execute`` and ``split``)."""
        with self._lock:
            self._batch_s.update(stage_s)
            for k, v in stage_s.items():
                self._batch_s_max[k] = max(v, self._batch_s_max.get(k, 0.0))
            self.batches += 1
            self.rows += int(rows)
            self._occupancy[int(n_requests)] += 1
            self._bucket_use[int(bucket)] += 1

    def snapshot(self, cache_stats: Optional[Dict] = None) -> Dict:
        """The counters, percentiles and histograms; with
        ``cache_stats`` (a CachedOp's), also ``compile_cache``, its
        signatures as strings."""
        with self._lock:
            elapsed = max(1e-9, time.monotonic() - self._t0)
            lat = sorted(self._latencies_us)
            snap = {
                "model": self.model,
                "requests": self.requests,
                "errors": self.errors,
                "sheds": self.sheds,
                "expired": self.expired,
                "queue_depth": self.queue_depth,
                "batches": self.batches,
                "rows": self.rows,
                "qps": self.requests / elapsed,
                "latency_us_p50": percentile(lat, 50),
                "latency_us_p95": percentile(lat, 95),
                "latency_us_p99": percentile(lat, 99),
                "batch_occupancy": dict(self._occupancy),
                "bucket_use": dict(self._bucket_use),
                "mean_requests_per_batch": (
                    self.requests / self.batches if self.batches else 0.0),
                "batch_stage_ms_mean": {
                    k: 1e3 * v / self.batches
                    for k, v in self._batch_s.items()} if self.batches
                else {},
                "batch_stage_ms_max": {
                    k: 1e3 * v for k, v in self._batch_s_max.items()},
            }
        if cache_stats is not None:
            snap["compile_cache"] = {k: v for k, v in cache_stats.items()
                                     if k != "signatures"}
            snap["compile_cache"]["signatures"] = [
                repr(sig) for sig in cache_stats.get("signatures", [])]
        return snap
