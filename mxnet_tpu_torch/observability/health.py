"""Numerics health: the serving decode-path sentinel.

Counterpart of the serving part of ``mxnet_tpu/observability/health.py``
(``NumericsError`` :126-140, the ledger and the response policy
:464-567, the sentinel :1256-1283).  With ``MXNET_TPU_HEALTH`` set, the
generation scheduler copies each forward's logits to the host and
:func:`check_logits` sweeps them: a non-finite batch increments
``mxnet_tpu_health_nonfinite_total{where="logits"}``, is recorded as a
trip in the :class:`HealthLedger`, drops a flight-recorder breadcrumb and
acts by ``MXNET_TPU_HEALTH_ACTION`` (``log``, ``dump`` a post-mortem, or
``raise`` :class:`NumericsError`, which fails the request and frees its
pages).  Unset (the default), the decode path copies only the rows it
samples.

The training monitor (in-graph watchpoints, NaN localization, divergence
checksums, spike detectors) is not ported.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np

from ..base import MXNetError, env as _env
from . import metrics as _metrics

__all__ = ["NumericsError", "HealthLedger", "ledger", "snapshot",
           "serving_sentinel_enabled", "check_logits", "ACTIONS"]

_log = logging.getLogger("mxnet_tpu_torch.health")

ACTIONS = ("log", "dump", "raise", "skip")

_REG = _metrics.registry()
_M_NONFINITE = _REG.counter(
    "mxnet_tpu_health_nonfinite_total",
    "Non-finite values detected by the health sentinel, by surface "
    "(grad: in-graph gradient watchpoint; loss: in-graph loss watchpoint; "
    "logits: serving decode-path sentinel).", labels=("where",))


class NumericsError(MXNetError):
    """A numerics health violation the response policy chose to raise on
    (here: non-finite logits on the decode path; ``where``/``detail`` name
    the surface)."""

    def __init__(self, msg: str, where: str = "",
                 detail: Optional[Dict] = None,
                 diverging_rank: Optional[int] = None,
                 keys: Optional[List[str]] = None):
        super().__init__(msg)
        self.where = where
        self.detail = detail or {}
        self.diverging_rank = diverging_rank
        self.keys = list(keys or [])


class HealthLedger:
    """Process-global health state; flight post-mortems embed
    :meth:`snapshot`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._trips: deque = deque(maxlen=32)

    def record_trip(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            self._trips.append(rec)

    @property
    def trips(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._trips)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out = {"trips": list(self._trips)}
        out["counters"] = {"nonfinite": _M_NONFINITE.sample_dict()}
        return out

    def _reset(self) -> None:
        with self._lock:
            self._trips.clear()


_LEDGER = HealthLedger()


def ledger() -> HealthLedger:
    """The process-global health ledger."""
    return _LEDGER


def snapshot() -> Dict[str, Any]:
    return _LEDGER.snapshot()


def _respond(action: str, rec: Dict[str, Any], msg: str,
             where: str = "") -> str:
    """Flight-ring breadcrumb always; then act per policy.  Returns the
    action taken (``raise`` raises)."""
    from . import flight_recorder as _fr
    _fr.record_event("health." + rec.get("kind", "event"), **{
        k: v for k, v in rec.items()
        if isinstance(v, (str, int, float, bool, type(None)))})
    if action == "raise":
        exc = NumericsError(msg, where=where, detail=rec,
                            diverging_rank=rec.get("diverging_rank"),
                            keys=rec.get("keys"))
        _fr.notify_fatal(exc, site="health")
        raise exc
    if action == "dump":
        try:
            _fr.get().dump(reason=f"health: {msg}")
        except Exception:  # noqa: BLE001 - telemetry must never break
            _log.warning("health flight dump failed", exc_info=True)
    else:
        _log.warning("health: %s", msg)
    return action


_serving_warned_tags: set = set()


def serving_sentinel_enabled() -> bool:
    return bool(_env.MXNET_TPU_HEALTH)


def check_logits(tag: str, arr, action: Optional[str] = None) -> None:
    """Decode-path sentinel over host logits ``arr``; gate the host copy
    with :func:`serving_sentinel_enabled` before calling.  ``action``
    defaults to ``MXNET_TPU_HEALTH_ACTION``."""
    a = np.asarray(arr)
    bad = int(a.size - np.isfinite(a).sum())
    if not bad:
        return
    _M_NONFINITE.labels(where="logits").inc(bad)
    rec = {"kind": "nonfinite_logits", "tag": tag, "count": bad,
           "t_unix": time.time()}
    _LEDGER.record_trip(rec)
    act = (action or str(_env.MXNET_TPU_HEALTH_ACTION)).strip().lower()
    if act == "skip":  # a training policy; degrades to log here
        act = "log"
    # the once-per-tag dedup fights log spam only: every raise raises and
    # every dump writes its post-mortem
    if act != "log" or tag not in _serving_warned_tags:
        _serving_warned_tags.add(tag)
        _respond(act, rec,
                 f"non-finite logits ({bad} values) on the {tag} path")
