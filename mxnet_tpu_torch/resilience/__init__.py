"""``mxnet_tpu_torch.resilience`` — retry/deadline/circuit-breaker policies
with deterministic fault injection.

Counterpart of ``mxnet_tpu/resilience/__init__.py``:

* :mod:`policy` — :class:`RetryPolicy`, :class:`Deadline`,
  :class:`CircuitBreaker`, :func:`call_with_timeout`, the typed errors and
  :func:`is_transient`;
* :mod:`faults` — named injection sites driven by a deterministic
  :class:`FaultPlan`;
* :func:`backend_call` — the one gate every device touch of a compiled
  entry goes through: a CUDA graph's capture (site ``compile``) and its
  replay (site ``execute``), in ``CachedOp`` and ``CompiledTrainStep``.
  Shared retry policy, shared breaker, a clear
  :class:`BackendUnavailableError` when the backend is gone.

Where the JAX package's ``MXNET_TPU_DEGRADE_TO_CPU=1`` pins the CPU
platform when the breaker is open, the port never falls back to the CPU:
with the knob set, :func:`backend_call` raises :class:`MXNetError`.  A
CUDA error is not transient (:func:`is_transient`), so it passes through
untouched and does not move the breaker; an injected fault fires before
the call, so a retried replay never follows a half-run one.

* :mod:`training` — :class:`FaultTolerantStep` and
  :class:`TrainerSnapshot`: snapshot-replay, with device copies restored
  in place (the step's graphs replay with no new capture);
* :mod:`elastic` — :class:`AsyncCheckpointer` (device copies on a side
  stream, written off the train thread, published atomically with an
  integrity manifest), :func:`~elastic.load_elastic_checkpoint`, and
  :class:`ElasticTrainStep` (with :class:`ElasticConfig`), which reforms
  the ``dp`` mesh on the survivors after a rank loss and replays from the
  last durable checkpoint.

The counters export through ``profiler.register_stats_provider`` as the
``resilience`` section, and as ``mxnet_tpu_resilience_*`` metrics.
"""
from __future__ import annotations

from typing import Callable, Optional

from ..base import MXNetError, env


class _Counters:
    """Process-wide resilience counters, stored in the metrics registry
    (``mxnet_tpu_resilience_<field>_total``) and read back as ints through
    :class:`~mxnet_tpu_torch.observability.metrics.Baselined`, so
    ``counters.retries += 1`` works and ``reset()`` rebases without ever
    decreasing a scraped counter."""

    FIELDS = ("retries", "faults_injected", "breaker_short_circuits",
              "deadline_hits", "timeouts", "replays", "degrades")

    _DOCS = {
        "retries": "Transient backend failures retried under RetryPolicy.",
        "faults_injected": "FaultPlan faults fired at any site.",
        "breaker_short_circuits": "Calls denied instantly by an open breaker.",
        "deadline_hits": "Retry ladders preempted by an expired Deadline.",
        "timeouts": "call_with_timeout gave up waiting on a wedged call.",
        "replays": "Training steps replayed from snapshot after a fault.",
        "degrades": "Backend-breaker falls back to the CPU platform (never, "
                    "in the PyTorch port).",
    }

    def __init__(self):
        from ..observability import metrics as _metrics
        reg = _metrics.registry()
        object.__setattr__(self, "_bound", {
            f: _metrics.Baselined(
                reg.counter(f"mxnet_tpu_resilience_{f}_total",
                            self._DOCS[f])._one())
            for f in self.FIELDS})
        gauge = reg.gauge(
            "mxnet_tpu_resilience_breaker_state",
            "Backend circuit breaker: 0 closed, 1 half-open, 2 open.")
        gauge.set_function(lambda: {
            CircuitBreaker.CLOSED: 0, CircuitBreaker.HALF_OPEN: 1,
            CircuitBreaker.OPEN: 2}[backend_breaker().state])

    def __getattr__(self, name):
        bound = self.__dict__.get("_bound") or {}
        if name in bound:
            return int(bound[name].value)
        raise AttributeError(name)

    def __setattr__(self, name, value):
        # `counters.f += 1` arrives as a read then a set: growth becomes
        # inc(delta), a shrink (reset) a rebase
        bound = self.__dict__.get("_bound") or {}
        b = bound.get(name)
        if b is None:
            object.__setattr__(self, name, value)
            return
        cur = b.value
        if value >= cur:
            if value > cur:
                b.inc(value - cur)
        else:
            b.rebase()
            if value:
                b.inc(value)

    def reset(self):
        for f in self.FIELDS:
            setattr(self, f, 0)

    def snapshot(self) -> dict:
        snap = {f: getattr(self, f) for f in self.FIELDS}
        br = _BACKEND_BREAKER
        if not any(snap.values()) and br.state == CircuitBreaker.CLOSED \
                and not br.open_events:
            return {}  # pristine: the profiler section stays silent
        snap["backend_breaker_state"] = br.state
        snap["backend_breaker_open_events"] = br.open_events
        return snap


counters = _Counters()


def _flight_notify(exc: BaseException, site: str, context=None) -> None:
    """Hand a fatal resilience failure to the flight recorder.  Never
    raises: telemetry must not mask the error it records."""
    try:
        from ..observability import flight_recorder as _fr
        _fr.notify_fatal(exc, site=site, context=context)
    except Exception:  # pragma: no cover
        pass


from . import faults  # noqa: E402  (needs `counters` defined)
from . import policy  # noqa: E402
from .faults import FaultInjected, FaultPlan, maybe_fault  # noqa: E402
from .policy import (  # noqa: E402
    BackendUnavailableError, CircuitBreaker, Deadline, DeadlineExceededError,
    OverloadedError, RankFailureError, RequestCancelledError, RetryPolicy,
    ServerClosedError, call_with_timeout, current_deadline, deadline_scope,
    is_cuda_error, is_transient,
)

__all__ = [
    "RetryPolicy", "Deadline", "CircuitBreaker", "FaultPlan", "FaultInjected",
    "maybe_fault", "backend_call", "backend_breaker", "call_with_timeout",
    "deadline_scope", "current_deadline", "is_transient", "is_cuda_error",
    "counters", "reset_backend_state", "BackendUnavailableError",
    "DeadlineExceededError", "RankFailureError", "OverloadedError",
    "ServerClosedError", "RequestCancelledError", "faults", "policy",
    "training", "elastic", "FaultTolerantStep", "TrainerSnapshot",
    "AsyncCheckpointer", "ElasticConfig", "ElasticTrainStep",
]

# ---------------------------------------------------------------------------
# the shared backend gate
# ---------------------------------------------------------------------------
_BACKEND_BREAKER = CircuitBreaker(name="backend")
# the default policy, rebuilt only when the knobs' raw strings change:
# backend_call runs on every replay
_POLICY_CACHE: dict = {"key": None, "policy": None}


def _default_retry_policy() -> RetryPolicy:
    import os
    key = (os.environ.get("MXNET_TPU_RETRY_MAX"),
           os.environ.get("MXNET_TPU_RETRY_BACKOFF"))
    if _POLICY_CACHE["policy"] is None or _POLICY_CACHE["key"] != key:
        _POLICY_CACHE["key"] = key
        _POLICY_CACHE["policy"] = RetryPolicy()
    return _POLICY_CACHE["policy"]


def backend_breaker() -> CircuitBreaker:
    """The process-wide breaker guarding the device backend."""
    return _BACKEND_BREAKER


def reset_backend_state() -> None:
    """Fresh breaker and zeroed counters (test isolation, or re-arming
    after an operator fixed the backend)."""
    global _BACKEND_BREAKER
    _BACKEND_BREAKER = CircuitBreaker(name="backend")
    _POLICY_CACHE["key"] = _POLICY_CACHE["policy"] = None
    counters.reset()


def backend_call(site: str, fn: Callable, *,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 deadline: Optional[Deadline] = None):
    """Run one backend-touching operation under the shared policy.

    ``site`` is the fault-injection site (``compile``/``execute``).  The
    breaker short-circuits at once when open (:class:`BackendUnavailable
    Error`); otherwise each attempt first consults the active
    :class:`FaultPlan`, then calls ``fn``; transient failures retry under
    the shared :class:`RetryPolicy` (each failed attempt feeds the breaker)
    and, once the budget is spent, surface as
    :class:`BackendUnavailableError` with the original error chained.
    Non-transient errors (a CUDA error among them) pass through untouched
    and do not move the breaker.  ``MXNET_TPU_DEGRADE_TO_CPU`` set raises
    :class:`MXNetError`: the port never falls back to the CPU.
    """
    if env.MXNET_TPU_DEGRADE_TO_CPU:
        raise MXNetError(
            "MXNET_TPU_DEGRADE_TO_CPU is set, but the PyTorch port never "
            "falls back to the CPU when the backend breaker opens (a card "
            "path that silently ran 100x slower would be worse than a loud "
            "failure); unset it")
    br = breaker or _BACKEND_BREAKER
    if not br.allow():
        counters.breaker_short_circuits += 1
        exc = BackendUnavailableError(
            f"backend circuit breaker is open (site {site!r}); cooling down "
            f"{br.cooldown:g}s")
        _flight_notify(exc, site)
        raise exc
    pol = retry or _default_retry_policy()

    def attempt():
        try:
            faults.maybe_fault(site)
            return fn()
        except Exception as e:  # noqa: BLE001 - classified below
            if is_transient(e):
                br.record_failure()
            raise

    try:
        out = pol.call(attempt, site=site, deadline=deadline)
    except DeadlineExceededError:
        # the budget preempted a retry: the transient failure before it
        # already fed the breaker inside attempt()
        raise
    except Exception as e:  # noqa: BLE001
        if is_transient(e):
            exc = BackendUnavailableError(
                f"backend {site} failed after {pol.max_attempts} attempts: "
                f"{e}")
            _flight_notify(exc, site)
            raise exc from e
        # non-transient: the backend answered, which says nothing about its
        # availability; give back any half-open probe slot
        br.release_probe()
        raise
    br.record_success()
    return out


def _stats_provider() -> dict:
    return counters.snapshot()


from .. import profiler as _profiler  # noqa: E402

_profiler.register_stats_provider("resilience", _stats_provider)

from . import training  # noqa: E402  (imports policy/faults above)
from .training import FaultTolerantStep, TrainerSnapshot  # noqa: E402
from . import elastic  # noqa: E402
from .elastic import (AsyncCheckpointer, ElasticConfig,  # noqa: E402
                      ElasticTrainStep)
