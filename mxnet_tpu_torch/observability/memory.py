"""Memory ledger: one live-bytes registry across every pool and cache.

Counterpart of ``mxnet_tpu/observability/memory.py``.  Every component
(the KV page pool, the host staging buffers, a training step's
parameters and optimizer state) registers a zero-argument callback
returning its CURRENT live bytes, and the ledger

* exports each as ``mxnet_tpu_memory_live_bytes{component=...}`` (collect-
  time callbacks, so a scrape is always live);
* tracks the process **high-water mark** (total and the per-component
  split at the peak), sampled at every :meth:`MemoryLedger.poll` or
  :meth:`~MemoryLedger.snapshot`;
* renders one JSON snapshot for the ``/goodput`` serving route and every
  flight-recorder post-mortem.

Registration by :meth:`MemoryLedger.register_object` holds a weak
reference: a collected component reports 0 and is dropped at the next
walk.
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Callable, Dict, Optional

from . import metrics as _metrics

__all__ = ["MemoryLedger", "ledger"]

_REG = _metrics.registry()
_M_LIVE = _REG.gauge(
    "mxnet_tpu_memory_live_bytes",
    "Live bytes per registered memory component (page pools, optimizer "
    "shards, prefetch staging, executor buffers, host pools).",
    labels=("component",))
_M_HWM = _REG.gauge(
    "mxnet_tpu_memory_high_water_bytes",
    "High-water mark of the summed live bytes across all registered "
    "components (sampled at every ledger poll/snapshot).")


class MemoryLedger:
    """Process-global registry of live-bytes callbacks (see module doc)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._components: Dict[str, Callable[[], float]] = {}
        self._refs: Dict[str, weakref.ref] = {}
        self._hwm = 0.0
        self._hwm_components: Dict[str, float] = {}
        self._hwm_unix = 0.0

    # ------------------------------------------------------------- intake
    def register(self, component: str, fn: Callable[[], float]) -> None:
        """Register (or replace) a component's live-bytes callback."""
        with self._lock:
            self._components[component] = fn
            self._refs.pop(component, None)
        _M_LIVE.labels(component=component).set_function(
            lambda c=component: self._read(c))

    def register_object(self, component: str, obj: Any,
                        fn: Callable[[Any], float]) -> None:
        """Register ``fn(obj)`` without pinning ``obj``: once it is
        collected the component reports 0 and unregisters itself."""
        ref = weakref.ref(obj)

        def cb() -> float:
            o = ref()
            return 0.0 if o is None else float(fn(o))

        with self._lock:
            self._components[component] = cb
            self._refs[component] = ref
        _M_LIVE.labels(component=component).set_function(
            lambda c=component: self._read(c))

    def unregister(self, component: str) -> None:
        with self._lock:
            self._components.pop(component, None)
            self._refs.pop(component, None)
        child = _M_LIVE.labels(component=component)
        child.set_function(None)
        child.set(0.0)

    # ------------------------------------------------------------- reading
    def _read(self, component: str) -> float:
        with self._lock:
            fn = self._components.get(component)
        if fn is None:
            return 0.0
        try:
            return float(fn())
        except Exception:  # noqa: BLE001 — accounting must never break hot paths
            return 0.0

    def components(self) -> Dict[str, float]:
        """Current live bytes per component (dead weakrefs dropped)."""
        with self._lock:
            names = list(self._components)
            dead = [n for n, r in self._refs.items() if r() is None]
        for n in dead:
            self.unregister(n)
        return {n: self._read(n) for n in names if n not in dead}

    def _advance_hwm(self, comp: Dict[str, float]) -> float:
        total = float(sum(comp.values()))
        with self._lock:
            if total > self._hwm:
                self._hwm = total
                self._hwm_components = dict(comp)
                self._hwm_unix = time.time()
            hwm = self._hwm
        _M_HWM.set(hwm)
        return total

    def poll(self) -> float:
        """Sample the total and advance the high-water mark; returns the
        current total live bytes.  Cheap (a few Python callbacks) — hot
        drivers call this once per step."""
        return self._advance_hwm(self.components())

    def snapshot(self) -> Dict[str, Any]:
        """The post-mortem and /goodput view: live split, total, and the peak —
        all derived from ONE callback walk, so the reported total and the
        peak it may have just set are consistent."""
        comp = self.components()
        total = self._advance_hwm(comp)
        with self._lock:
            return {"components": comp, "total_bytes": total,
                    "high_water_bytes": self._hwm,
                    "high_water_components": dict(self._hwm_components),
                    "high_water_unix": self._hwm_unix or None}

    def _reset(self) -> None:
        """Test isolation: drop every registration and the high-water mark."""
        with self._lock:
            names = list(self._components)
        for n in names:
            self.unregister(n)
        with self._lock:
            self._hwm = 0.0
            self._hwm_components = {}
            self._hwm_unix = 0.0
        _M_HWM.set(0.0)


_GLOBAL = MemoryLedger()


def ledger() -> MemoryLedger:
    """The process-global memory ledger every component registers into."""
    return _GLOBAL
