"""Deterministic fault injection at named sites.

Counterpart of ``mxnet_tpu/resilience/faults.py``.  The code carries
**named injection sites**:

==========  ==============================================================
site        where it fires in the port
==========  ==============================================================
compile     CachedOp / CompiledTrainStep capturing a signature's CUDA graph
execute     replaying a graph (on the CPU: running the entry eagerly)
allreduce   dist kvstore collectives (every `_collective` round)
decode      the generation scheduler's forward
http        the serving HTTP predict handler, before dispatch
route       the fleet Router, before it picks a replica
relay       the Router's SSE relay, between forwarded events (transient:
            the relay leg is lost and the stream migrates)
prefill_handoff  the Router's disaggregation K/V handoff (any failure
                 falls back to one mixed hop)
replica_exec     a replica's /generate and /prefill handlers, before
                 dispatch
==========  ==============================================================

A :class:`FaultPlan` maps sites to an ordered list of fault *kinds*; each
hit at a site consumes the next entry.  Kinds:

* ``unavailable`` / ``deadline`` / ``connrefused`` — raise a transient
  :class:`FaultInjected` (classified retryable);
* ``fatal`` — raise a non-transient :class:`FaultInjected`;
* ``hang`` / ``hang:<seconds>`` — sleep (default 30s) then raise
  ``unavailable``;
* ``ok`` — explicitly pass (lets a plan target the Nth hit of a site).

``kind*N`` expands to N entries; an exhausted (or absent) site list
passes.  Activate with the context manager::

    with FaultPlan({"execute": ["unavailable"]}):
        net(x)        # first execute fails UNAVAILABLE, retry succeeds

or process-wide via ``MXNET_TPU_FAULT_PLAN`` (the same mapping as JSON).
``maybe_fault(site)`` with no plan active is one list check and one
environment lookup.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..base import MXNetError

__all__ = ["FaultInjected", "FaultPlan", "maybe_fault", "SITES"]

SITES = ("compile", "execute", "allreduce", "decode", "http",
         "route", "relay", "prefill_handoff", "replica_exec")

_TRANSIENT_KINDS = {
    "unavailable": "UNAVAILABLE: injected fault",
    "deadline": "DEADLINE_EXCEEDED: injected fault",
    "connrefused": "failed to connect to all addresses; Connection refused "
                   "(injected fault)",
}


class FaultInjected(MXNetError):
    """An injected fault.  ``transient`` mirrors the classification the real
    error would get, so retry/breaker logic treats injected and organic
    failures alike."""

    def __init__(self, site: str, kind: str, msg: str, transient: bool):
        super().__init__(f"[fault:{site}] {msg}")
        self.site = site
        self.kind = kind
        self.transient = transient


def _expand(spec: Union[str, Sequence[str]]) -> List[str]:
    if isinstance(spec, str):
        spec = [spec]
    out: List[str] = []
    for entry in spec:
        if "*" in entry:
            kind, _, n = entry.partition("*")
            out.extend([kind.strip()] * int(n))
        else:
            out.append(entry.strip())
    return out


class FaultPlan:
    """Ordered, consumable fault schedule per site.  Thread-safe: sites are
    hit from worker threads (batcher, generation loop)."""

    def __init__(self, plan: Dict[str, Union[str, Sequence[str]]]):
        unknown = set(plan) - set(SITES)
        if unknown:
            raise ValueError(f"unknown fault sites {sorted(unknown)}; "
                             f"valid: {SITES}")
        self._lock = threading.Lock()
        self._queues = {site: _expand(spec) for site, spec in plan.items()}
        self.triggered: List[Tuple[str, str]] = []  # (site, kind) audit log

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        raw = os.environ.get("MXNET_TPU_FAULT_PLAN", "").strip()
        if not raw:
            return None
        return cls(json.loads(raw))

    def fire(self, site: str) -> Optional[str]:
        """Consume and return the next kind scheduled for ``site`` (None when
        nothing is scheduled)."""
        with self._lock:
            q = self._queues.get(site)
            if not q:
                return None
            kind = q.pop(0)
            self.triggered.append((site, kind))
            return kind

    def pending(self, site: Optional[str] = None) -> int:
        with self._lock:
            if site is not None:
                return len(self._queues.get(site, ()))
            return sum(len(q) for q in self._queues.values())

    def __enter__(self) -> "FaultPlan":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return False


# Active plans: a process-global stack, not a thread-local one, because the
# faults fire on OTHER threads (the batcher worker, the generation loop).
_ACTIVE: List[FaultPlan] = []
_ENV_CACHE: Tuple[str, Optional[FaultPlan]] = ("", None)
_ENV_LOCK = threading.Lock()


def _active_plan() -> Optional[FaultPlan]:
    if _ACTIVE:
        return _ACTIVE[-1]
    raw = os.environ.get("MXNET_TPU_FAULT_PLAN", "")
    if not raw:
        return None
    global _ENV_CACHE
    with _ENV_LOCK:
        if _ENV_CACHE[0] != raw:
            _ENV_CACHE = (raw, FaultPlan.from_env())
        return _ENV_CACHE[1]


def maybe_fault(site: str) -> None:
    """The injection point.  No active plan: a no-op.  With a plan: consume
    the site's next scheduled kind and act it out."""
    if not _ACTIVE and not os.environ.get("MXNET_TPU_FAULT_PLAN"):
        return
    plan = _active_plan()
    if plan is None:
        return
    kind = plan.fire(site)
    if kind is None or kind == "ok":
        return
    from . import counters
    counters.faults_injected += 1
    if kind.startswith("hang"):
        _, _, secs = kind.partition(":")
        time.sleep(float(secs) if secs else 30.0)
        raise FaultInjected(site, kind,
                            "UNAVAILABLE: injected hang elapsed", True)
    if kind == "fatal":
        exc = FaultInjected(site, kind, "injected non-transient fault", False)
        # the injected rendering of an unrecoverable backend failure:
        # record the post-mortem as the organic path would
        from . import _flight_notify
        _flight_notify(exc, site)
        raise exc
    msg = _TRANSIENT_KINDS.get(kind)
    if msg is None:
        raise ValueError(f"unknown fault kind {kind!r} for site {site!r}")
    raise FaultInjected(site, kind, msg, True)
