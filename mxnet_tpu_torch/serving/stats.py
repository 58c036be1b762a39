"""Per-model serving statistics: completed requests, executed
batches and their shapes, and request latencies (nearest-rank percentiles
over a bounded recent window).

Counterpart of ``mxnet_tpu/serving/stats.py`` without the metrics
registry, exemplars and profiler counters, which wait for the
observability slice.
"""
from __future__ import annotations

import threading
import time
from collections import Counter, deque
from typing import Dict, List

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
        self.batches = 0
        self.rows = 0
        self._latencies_us: deque = deque(maxlen=self.WINDOW)
        self._occupancy: Counter = Counter()   # requests-per-batch histogram
        self._bucket_use: Counter = Counter()  # padded-shape histogram

    def record_request(self, latency_us: float) -> None:
        with self._lock:
            self.requests += 1
            self._latencies_us.append(float(latency_us))

    def record_batch(self, n_requests: int, rows: int, bucket: int) -> None:
        with self._lock:
            self.batches += 1
            self.rows += int(rows)
            self._occupancy[int(n_requests)] += 1
            self._bucket_use[int(bucket)] += 1

    def snapshot(self) -> Dict:
        with self._lock:
            elapsed = max(1e-9, time.monotonic() - self._t0)
            lat = sorted(self._latencies_us)
            return {
                "model": self.model,
                "requests": self.requests,
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
            }
