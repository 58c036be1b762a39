"""Resilience policies: retry, deadline, circuit breaker, bounded blocking.

Counterpart of ``mxnet_tpu/resilience/policy.py``, the one implementation
every layer shares:

* :class:`RetryPolicy` — bounded attempts with exponential backoff and
  decorrelated jitter (each delay is ``uniform(base, prev * 3)`` capped at
  ``max_delay``), gated on a retryable-error classifier so programming
  errors never burn the budget;
* :class:`Deadline` — an absolute wall-clock budget threaded through nested
  calls (an inner scope can never outlive its enclosing one);
* :class:`CircuitBreaker` — closed → open → half-open with a bounded probe,
  so a dead dependency fails fast instead of paying the full retry ladder
  on every call;
* :func:`call_with_timeout` — run a possibly-hanging callable on a worker
  thread and bound the wait.

The typed errors are the very classes of :mod:`mxnet_tpu_torch.error` and
:mod:`mxnet_tpu_torch.base`, re-exported here: the batcher, the server and
a caller all catch the same objects.  :func:`is_transient` keeps the JAX
package's markers and treats no CUDA error as transient: a launch failure
or an illegal address is sticky for the whole context, so a retry would
launch again on a broken context.

Everything takes injectable ``clock``/``sleep``/``rng`` hooks so the tests
exercise real policy decisions deterministically.
"""
from __future__ import annotations

import random as _random_mod
import threading
import time
from typing import Callable, List, Optional

import torch

from ..base import MXNetError, RequestCancelledError, ServerClosedError, env
from ..error import (BackendUnavailableError, DeadlineExceededError,
                     OverloadedError, RankFailureError)

__all__ = [
    "RetryPolicy", "Deadline", "CircuitBreaker", "call_with_timeout",
    "is_transient", "is_cuda_error", "deadline_scope", "current_deadline",
    "BackendUnavailableError", "DeadlineExceededError", "RankFailureError",
    "OverloadedError", "ServerClosedError", "RequestCancelledError",
]


# ---------------------------------------------------------------------------
# error taxonomy
# ---------------------------------------------------------------------------
_TRANSIENT_MARKERS = (
    "unavailable", "deadline_exceeded", "deadline exceeded",
    "connection refused", "connection reset", "failed to connect",
    "broken pipe", "socket closed", "too many pings", "connection closed",
)

# the text torch gives an error raised by the CUDA runtime or a CUDA
# library ("CUDA error: an illegal memory access was encountered",
# "CUBLAS_STATUS_EXECUTION_FAILED", "CUDA out of memory")
_CUDA_MARKERS = ("cuda error", "cuda driver error", "cudnn_status",
                 "cublas_status", "cuda out of memory", "cudaerror")


def is_cuda_error(exc: BaseException) -> bool:
    """An error of the CUDA runtime, driver or a CUDA library."""
    accel = getattr(torch, "AcceleratorError", None)
    if isinstance(exc, torch.cuda.OutOfMemoryError) or (
            accel is not None and isinstance(exc, accel)):
        return True
    msg = str(exc).lower()
    return any(m in msg for m in _CUDA_MARKERS)


def is_transient(exc: BaseException) -> bool:
    """Retryable-error classification for the backend path.

    Transient: injected transient faults, OS-level connection errors, and
    errors whose text carries the gRPC/absl status markers
    (``UNAVAILABLE``, ``DEADLINE_EXCEEDED``, ``Connection refused``).  NOT
    transient: exhausted budgets (:class:`DeadlineExceededError`,
    :class:`BackendUnavailableError`), any CUDA error (even one whose text
    says "unavailable"), and everything else — shape errors, OOM, type
    errors raise at once.
    """
    from .faults import FaultInjected
    if isinstance(exc, FaultInjected):
        return exc.transient
    if isinstance(exc, (BackendUnavailableError, DeadlineExceededError,
                        RankFailureError, OverloadedError, ServerClosedError,
                        RequestCancelledError)):
        return False
    if is_cuda_error(exc):
        return False
    if isinstance(exc, ConnectionError):
        return True
    msg = str(exc).lower()
    return any(m in msg for m in _TRANSIENT_MARKERS)


# ---------------------------------------------------------------------------
# Deadline: absolute budget threaded through nested calls
# ---------------------------------------------------------------------------
_tls = threading.local()


class Deadline:
    """Absolute wall-clock budget.

    Created from a relative ``seconds`` but stored as an absolute instant,
    so passing one Deadline down a call tree shares ONE budget across every
    nested retry loop.
    """

    def __init__(self, seconds: float,
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._expires = clock() + float(seconds)

    @classmethod
    def after(cls, seconds: float, **kw) -> "Deadline":
        return cls(seconds, **kw)

    def remaining(self) -> float:
        return self._expires - self._clock()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0

    def check(self, what: str = "operation") -> None:
        if self.expired:
            raise DeadlineExceededError(
                f"deadline expired {-self.remaining():.3f}s ago before {what} "
                "completed")

    def __repr__(self):
        return f"Deadline(remaining={self.remaining():.3f}s)"


class deadline_scope:
    """``with deadline_scope(5.0):`` — ambient deadline for the enclosed
    calls; nested scopes are clamped to the tightest enclosing budget."""

    def __init__(self, seconds: float,
                 clock: Callable[[], float] = time.monotonic):
        self._seconds = seconds
        self._clock = clock

    def __enter__(self) -> Deadline:
        outer = current_deadline()
        seconds = self._seconds
        if outer is not None:
            seconds = min(seconds, max(0.0, outer.remaining()))
        d = Deadline(seconds, clock=self._clock)
        stack = getattr(_tls, "deadlines", None)
        if stack is None:
            stack = _tls.deadlines = []
        stack.append(d)
        return d

    def __exit__(self, *exc):
        _tls.deadlines.pop()
        return False


def current_deadline() -> Optional[Deadline]:
    stack = getattr(_tls, "deadlines", None)
    return stack[-1] if stack else None


# ---------------------------------------------------------------------------
# RetryPolicy: exponential backoff + decorrelated jitter
# ---------------------------------------------------------------------------
class RetryPolicy:
    """Bounded retry with exponential backoff and decorrelated jitter.

    ``max_attempts`` counts the first attempt (default
    ``MXNET_TPU_RETRY_MAX``); ``base_delay`` floors every backoff sleep
    (default ``MXNET_TPU_RETRY_BACKOFF``); ``max_delay`` caps it.
    ``jitter=True`` draws each delay from ``uniform(base, prev_delay * 3)``;
    False doubles deterministically.  ``retryable`` classifies (default
    :func:`is_transient`); ``on_retry(attempt, exc, delay)`` observes each
    backoff.  ``sleep`` and ``rng_seed`` are injectable; ``rng_seed=None``
    seeds each call from system entropy, so a fleet's retries after a
    shared blip do not march in lockstep.
    """

    def __init__(self, max_attempts: Optional[int] = None,
                 base_delay: Optional[float] = None, max_delay: float = 30.0,
                 jitter: bool = True,
                 retryable: Callable[[BaseException], bool] = is_transient,
                 on_retry: Optional[Callable] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 rng_seed: Optional[int] = None):
        self.max_attempts = max(1, int(env.MXNET_TPU_RETRY_MAX
                                       if max_attempts is None
                                       else max_attempts))
        self.base_delay = float(env.MXNET_TPU_RETRY_BACKOFF
                                if base_delay is None else base_delay)
        self.max_delay = float(max_delay)
        self.jitter = jitter
        self.retryable = retryable
        self.on_retry = on_retry
        self._sleep = sleep
        self._rng_seed = rng_seed

    def delays(self) -> List[float]:
        """The backoff schedule this policy would use (one entry per retry);
        equal to :meth:`call`'s sleeps under a fixed ``rng_seed``."""
        rng = _random_mod.Random(self._rng_seed)
        out, prev = [], self.base_delay
        for _ in range(self.max_attempts - 1):
            if self.jitter:
                prev = min(self.max_delay,
                           rng.uniform(self.base_delay,
                                       max(self.base_delay, prev * 3)))
            else:
                prev = min(self.max_delay, prev)
            out.append(prev)
            if not self.jitter:
                prev *= 2
        return out

    def call(self, fn: Callable, *args, site: str = "",
             deadline: Optional[Deadline] = None, **kwargs):
        """Run ``fn`` under the policy.  Retries only classifier-approved
        errors; an expired ``deadline`` (the ambient scope when none is
        given) raises :class:`DeadlineExceededError` chained to the last
        real failure instead of sleeping into a dead backend."""
        from . import counters
        if deadline is None:
            deadline = current_deadline()
        rng = _random_mod.Random(self._rng_seed)
        delay = self.base_delay
        for attempt in range(self.max_attempts):
            try:
                return fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 - the classifier decides
                if not self.retryable(e) or attempt == self.max_attempts - 1:
                    raise
                if self.jitter:
                    delay = min(self.max_delay,
                                rng.uniform(self.base_delay,
                                            max(self.base_delay, delay * 3)))
                else:
                    delay = min(self.max_delay,
                                self.base_delay * (2 ** attempt))
                if deadline is not None and deadline.remaining() <= delay:
                    counters.deadline_hits += 1
                    raise DeadlineExceededError(
                        f"retry budget for {site or fn!r} exhausted by "
                        f"deadline (attempt {attempt + 1}/"
                        f"{self.max_attempts}): {e}") from e
                counters.retries += 1
                if self.on_retry is not None:
                    self.on_retry(attempt, e, delay)
                self._sleep(delay)
        raise AssertionError("unreachable")  # pragma: no cover

    def wrap(self, fn: Callable, site: str = "") -> Callable:
        def wrapped(*args, **kwargs):
            return self.call(fn, *args,
                             site=site or getattr(fn, "__name__", ""),
                             **kwargs)
        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        return wrapped


# ---------------------------------------------------------------------------
# CircuitBreaker: closed -> open -> half-open with probe
# ---------------------------------------------------------------------------
class CircuitBreaker:
    """Three-state breaker guarding one dependency (the backend, one served
    model).

    * ``closed`` — traffic flows; ``failure_threshold`` consecutive failures
      trip to ``open``.
    * ``open`` — :meth:`allow` denies at once until ``cooldown`` elapses.
    * ``half-open`` — after cooldown, up to ``half_open_probes`` calls are
      let through; one success closes the breaker, one failure re-opens it
      and restarts the cooldown.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: Optional[int] = None,
                 cooldown: Optional[float] = None, half_open_probes: int = 1,
                 clock: Callable[[], float] = time.monotonic, name: str = ""):
        self.failure_threshold = max(1, int(
            env.MXNET_TPU_BREAKER_THRESHOLD if failure_threshold is None
            else failure_threshold))
        self.cooldown = float(env.MXNET_TPU_BREAKER_COOLDOWN
                              if cooldown is None else cooldown)
        self.half_open_probes = max(1, int(half_open_probes))
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probes_in_flight = 0
        self.open_events = 0  # lifetime trips, exported via counters

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        if (self._state == self.OPEN
                and self._clock() - self._opened_at >= self.cooldown):
            self._state = self.HALF_OPEN
            self._probes_in_flight = 0
        return self._state

    def allow(self) -> bool:
        """May a call proceed now?  In half-open, consumes a probe slot."""
        return self.acquire()[0]

    def acquire(self):
        """``(allowed, consumed_probe)`` decided atomically under the lock,
        for callers that must later :meth:`release_probe` exactly when a
        slot was taken."""
        with self._lock:
            st = self._state_locked()
            if st == self.CLOSED:
                return True, False
            if st == self.HALF_OPEN and \
                    self._probes_in_flight < self.half_open_probes:
                self._probes_in_flight += 1
                return True, True
            return False, False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probes_in_flight = 0
            self._state = self.CLOSED

    def record_failure(self) -> None:
        with self._lock:
            st = self._state_locked()
            if st == self.HALF_OPEN:
                self._trip_locked()  # the probe failed: straight back open
                return
            self._failures += 1
            if st == self.CLOSED and self._failures >= self.failure_threshold:
                self._trip_locked()

    def release_probe(self) -> None:
        """Return a half-open probe slot without recording an outcome (the
        call never reached the dependency, or failed in a way that says
        nothing about its health); without it the breaker would wedge
        half-open."""
        with self._lock:
            if self._probes_in_flight > 0:
                self._probes_in_flight -= 1

    def _trip_locked(self) -> None:
        self._state = self.OPEN
        self._opened_at = self._clock()
        self._failures = 0
        self._probes_in_flight = 0
        self.open_events += 1

    def __repr__(self):
        return (f"CircuitBreaker({self.name or 'anon'}, state={self.state}, "
                f"threshold={self.failure_threshold})")


# ---------------------------------------------------------------------------
# bounded blocking for possibly-hanging calls
# ---------------------------------------------------------------------------
def call_with_timeout(fn: Callable, timeout: Optional[float],
                      what: str = "operation",
                      error: Optional[Callable[[str], BaseException]] = None):
    """Run ``fn()`` bounded by ``timeout`` seconds, on a fresh daemon
    thread: a wedged call is leaked (it cannot be killed) but the caller
    gets a clean error instead of hanging.  ``timeout`` of None/0/negative
    runs ``fn`` inline."""
    if not timeout or timeout <= 0:
        return fn()
    box: dict = {}
    done = threading.Event()

    def runner():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - ferried to the caller
            box["error"] = e
        done.set()

    t = threading.Thread(target=runner, daemon=True,
                         name=f"mx-timeout-{what[:32]}")
    t.start()
    if not done.wait(timeout):
        from . import counters
        counters.timeouts += 1
        make = error or (lambda m: DeadlineExceededError(m))
        raise make(f"{what} did not complete within {timeout:g}s")
    if "error" in box:
        raise box["error"]
    return box["value"]
