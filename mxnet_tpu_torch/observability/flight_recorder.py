"""Crash flight recorder: an always-on bounded ring of recent telemetry.

Counterpart of ``mxnet_tpu/observability/flight_recorder.py``.  It keeps
the last ``MXNET_TPU_FLIGHT_CAPACITY`` records — ended spans (fed by
:mod:`.tracing`), warning/error log records of the ``mxnet_tpu_torch``
logger, metric snapshots, and free-form events — in a lock-guarded ring
that costs one deque append per record.

When resilience gives up (:class:`~mxnet_tpu_torch.resilience.
BackendUnavailableError` from the backend gate, or a fault site firing
``fatal``), :func:`notify_fatal` records the crash (exception, failing
span, ring tail) in memory and, when ``MXNET_TPU_FLIGHT_DIR`` is set,
dumps a timestamped JSON artifact::

    {dir}/flight-{pid}-{yyyymmdd-hhmmss}-{seq}.json
    {
      "version": 1, "reason": ..., "time_unix": ..., "pid": ..., "rank": ...,
      "exception": {"type": ..., "message": ..., "site": ...},
      "failing_span": {"trace_id": ..., "span_id": ..., "name": ...},
      "events": [ ...ring contents, oldest first... ],
      "metrics": { ...registry snapshot... },
      "memory": ..., "goodput": ..., "health": ...,
      "env": { ...MXNET_* vars... }
    }
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..base import env

__all__ = ["FlightRecorder", "get", "record_event", "notify_fatal"]


class _RingLogHandler(logging.Handler):
    """Feeds WARNING+ log records into the ring (never raises upstream).

    Attached to the ``mxnet_tpu_torch`` logger, NOT the root logger: a handler on
    root would make ``logging.lastResort`` consider the host application
    "configured" and silently swallow its WARNING+ stderr output the moment
    it imports this library.  Host apps that want their own records in the
    ring can ``addHandler`` this themselves."""

    def __init__(self, recorder: "FlightRecorder"):
        super().__init__(level=logging.WARNING)
        self._recorder = recorder

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self._recorder.record("log", {
                "level": record.levelname, "logger": record.name,
                "message": record.getMessage(),
            })
        except Exception:  # pragma: no cover — telemetry must never break
            pass


class FlightRecorder:
    def __init__(self, capacity: Optional[int] = None):
        cap = int(capacity if capacity is not None
                  else env.MXNET_TPU_FLIGHT_CAPACITY)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(16, cap))
        self._dump_seq = 0
        self._last_auto_dump = ("", 0.0)  # (type@site, t_unix) rate limit
        self.last_crash: Optional[Dict[str, Any]] = None
        self.dumps_written: List[str] = []

    # ------------------------------------------------------------- recording
    def record(self, kind: str, payload: Dict[str, Any]) -> None:
        entry = {"t_unix": time.time(), "kind": kind}
        entry.update(payload)
        with self._lock:
            self._ring.append(entry)

    def record_span(self, span_record: Dict[str, Any]) -> None:
        # hot path (every ended span): stamp the freshly-built record in
        # place instead of copying it into a wrapper
        span_record["t_unix"] = time.time()
        span_record["kind"] = "span"
        with self._lock:
            self._ring.append(span_record)

    def record_metrics_snapshot(self) -> None:
        """Push a full metrics snapshot into the ring (called at dump time
        and by anyone wanting a periodic metrics heartbeat in the ring)."""
        from . import metrics
        self.record("metrics", {"metrics": metrics.snapshot()})

    def events(self, last: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            evs = list(self._ring)
        return evs if last is None else evs[-last:]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # ------------------------------------------------------------- crash path
    def notify_fatal(self, exc: BaseException, site: Optional[str] = None,
                     context: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Record a fatal failure; dump an artifact when a flight dir is
        configured.  ``context`` is caller-supplied forensics (the dist
        kvstore's stuck-collective bucket/key description and per-rank
        progress counters ride here).  Never raises — a broken recorder
        must not mask the real error on its way up."""
        try:
            from . import tracing
            crash = {
                "time_unix": time.time(),
                "exception": {"type": type(exc).__name__,
                              "message": str(exc),
                              "site": site},
                "failing_span": tracing.current_span_info(),
                "context": context,
            }
            with self._lock:
                self.last_crash = crash
            # rate-limit repeated identical crashes for BOTH the ring record
            # and the artifact: an open breaker raises on every call, and a
            # crash record per call would evict in seconds the pre-failure
            # spans/logs the ring exists to preserve (one per storm is the
            # useful number; last_crash above still tracks every occurrence)
            key = f"{type(exc).__name__}@{site}"
            now = time.time()
            with self._lock:
                last_key, last_t = self._last_auto_dump
                if key == last_key and now - last_t < 5.0:
                    return None
                self._last_auto_dump = (key, now)
            self.record("crash", dict(crash))
            flight_dir = str(env.MXNET_TPU_FLIGHT_DIR or "").strip()
            if not flight_dir:
                return None
            return self.dump(directory=flight_dir,
                             reason=f"{type(exc).__name__}"
                                    + (f" at site {site!r}" if site else ""))
        except Exception:  # pragma: no cover — see docstring
            return None

    def dump(self, directory: Optional[str] = None,
             reason: str = "manual") -> str:
        """Write the artifact described in the module docstring; returns the
        path.  Usable by hand as well as from the crash hook."""
        from . import metrics
        directory = directory or str(env.MXNET_TPU_FLIGHT_DIR or ".") or "."
        os.makedirs(directory, exist_ok=True)
        with self._lock:
            self._dump_seq += 1
            seq = self._dump_seq
            crash = dict(self.last_crash) if self.last_crash else None
        rank = 0
        try:
            from .. import distributed
            rank = distributed.process_index()
        except Exception:
            pass
        # pool/memory state and the last goodput attribution at crash time:
        # a post-mortem that can't say what held the device memory or where
        # the last request's wall went answers only half the question
        mem = good = None
        try:
            from . import memory as _memory
            mem = _memory.ledger().snapshot()
        except Exception:  # pragma: no cover — telemetry must never break
            pass
        try:
            from . import goodput as _goodput
            good = {
                "last_train_step": _goodput.train().last_step,
                "last_train_window": _goodput.train().last_window,
                "last_serving_request": _goodput.serving().last_request,
            }
        except Exception:  # pragma: no cover — see above
            pass
        # numerics health at crash time (the last watchpoint fetch, trips
        # with their localization, spikes, checksum rounds), the third leg
        # of the post-mortem beside "memory" and "goodput"
        hlth = None
        try:
            from . import health as _health
            hlth = _health.snapshot()
        except Exception:  # pragma: no cover — see above
            pass
        artifact = {
            "version": 1,
            "reason": reason,
            "time_unix": time.time(),
            "pid": os.getpid(),
            "rank": rank,
            "exception": (crash or {}).get("exception"),
            "failing_span": (crash or {}).get("failing_span"),
            "context": (crash or {}).get("context"),
            "events": self.events(),
            "metrics": metrics.snapshot(),
            "memory": mem,
            "goodput": good,
            "health": hlth,
            "env": {k: v for k, v in sorted(os.environ.items())
                    if k.startswith("MXNET_")},
        }
        stamp = time.strftime("%Y%m%d-%H%M%S")
        path = os.path.join(
            directory, f"flight-{os.getpid()}-{stamp}-{seq:03d}.json")
        with open(path, "w") as f:
            json.dump(artifact, f, default=repr)
        with self._lock:
            self.dumps_written.append(path)
        return path


_GLOBAL = FlightRecorder()
_LOG_HANDLER = _RingLogHandler(_GLOBAL)
logging.getLogger("mxnet_tpu_torch").addHandler(_LOG_HANDLER)


def get() -> FlightRecorder:
    """The process-global recorder (spans, logs, crashes all land here)."""
    return _GLOBAL


def record_event(message: str, **attrs) -> None:
    """Drop a free-form breadcrumb into the ring."""
    _GLOBAL.record("event", {"message": message, **attrs})


def notify_fatal(exc: BaseException, site: Optional[str] = None,
                 context: Optional[Dict[str, Any]] = None) -> Optional[str]:
    return _GLOBAL.notify_fatal(exc, site=site, context=context)
