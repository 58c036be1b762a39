"""Port parity: ``mxnet_tpu_torch.resilience`` against
``mxnet_tpu.resilience`` on the same inputs, on the CPU.

Both packages get the same seeds, the same scripted event lists (an
injected clock, no sleeping) and the same fault plans; their outputs must
be equal: retry delays (floats from the same ``random.Random`` draws,
compared exactly), breaker state sequences, fault-plan expansion and the
raised kinds, ``is_transient`` over one exception set, and
``backend_call``'s counters and breaker moves.  Port-only: the typed
errors are one set of objects across ``error``, ``base`` and
``resilience``; ``MXNET_TPU_DEGRADE_TO_CPU`` raises; a CUDA error is
never transient, never retried and never moves the breaker.
"""
import pytest

import mxnet_tpu.resilience as jres
from mxnet_tpu.resilience import faults as jfaults

import mxnet_tpu_torch.base as tbase
import mxnet_tpu_torch.error as terror
import mxnet_tpu_torch.resilience as tres
from mxnet_tpu_torch.resilience import faults as tfaults, policy as tpolicy

PKGS = {"jax": jres, "torch": tres}


@pytest.fixture(autouse=True)
def _fresh_backend():
    for r in PKGS.values():
        r.reset_backend_state()
    yield
    for r in PKGS.values():
        r.reset_backend_state()


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


# ------------------------------------------------------------- RetryPolicy
@pytest.mark.parametrize("kw", [
    dict(max_attempts=6, base_delay=0.1, max_delay=2.0, rng_seed=7),
    dict(max_attempts=5, base_delay=0.25, max_delay=30.0, rng_seed=123),
    dict(max_attempts=4, base_delay=0.5, max_delay=1.0, jitter=False),
])
def test_retry_delays_match(kw):
    got = {k: r.RetryPolicy(**kw).delays() for k, r in PKGS.items()}
    assert got["torch"] == got["jax"]
    assert len(got["torch"]) == kw["max_attempts"] - 1


@pytest.mark.parametrize("jitter", [True, False])
def test_retry_call_sleeps_and_outcome_match(jitter):
    """The sleeps ``call`` takes before succeeding on the 4th attempt, and
    the retry counter's advance, are equal."""
    out = {}
    for k, r in PKGS.items():
        sleeps, calls = [], [0]

        def flaky():
            calls[0] += 1
            if calls[0] < 4:
                raise ConnectionResetError("connection reset by peer")
            return "ok"
        before = r.counters.retries
        pol = r.RetryPolicy(max_attempts=5, base_delay=0.2, max_delay=3.0,
                            jitter=jitter, sleep=sleeps.append, rng_seed=11)
        out[k] = (pol.call(flaky), sleeps, calls[0],
                  r.counters.retries - before)
    assert out["torch"] == out["jax"]
    assert out["torch"][2] == 4


def test_retry_deadline_and_nonretryable_match():
    out = {}
    for k, r in PKGS.items():
        clock = _Clock()
        seen = []

        def fail():
            seen.append(1)
            raise RuntimeError("UNAVAILABLE: tunnel down")
        pol = r.RetryPolicy(max_attempts=10, base_delay=1.0, jitter=False,
                            sleep=lambda d: setattr(clock, "t", clock.t + d))
        with pytest.raises(r.DeadlineExceededError) as ei:
            pol.call(fail, deadline=r.Deadline(2.5, clock=clock))
        with pytest.raises(ValueError):
            pol.call(lambda: (_ for _ in ()).throw(ValueError("shape")))
        out[k] = (len(seen), type(ei.value.__cause__).__name__,
                  "exhausted by deadline" in str(ei.value))
    assert out["torch"] == out["jax"]


def test_deadline_scope_nesting_matches():
    out = {}
    for k, r in PKGS.items():
        clock = _Clock()
        with r.deadline_scope(5.0, clock=clock) as outer:
            clock.t += 1.0
            with r.deadline_scope(60.0, clock=clock) as inner:
                rem = (outer.remaining(), inner.remaining(),
                       r.current_deadline() is inner)
            after = r.current_deadline() is outer
        out[k] = rem + (after, r.current_deadline())
    assert out["torch"] == out["jax"] == ((4.0, 4.0, True, True, None))


def test_call_with_timeout_matches():
    import threading
    out = {}
    for k, r in PKGS.items():
        gate = threading.Event()
        with pytest.raises(r.DeadlineExceededError) as ei:
            r.call_with_timeout(gate.wait, 0.05, what="collective")
        gate.set()
        out[k] = (r.call_with_timeout(lambda: 3, 1.0), str(ei.value),
                  r.call_with_timeout(lambda: 4, None))
    assert out["torch"] == out["jax"]


# ---------------------------------------------------------- CircuitBreaker
SCRIPT = (["fail", "fail", "acquire", "fail", "state", "acquire", "tick:2",
           "state", "acquire", "acquire", "fail", "state", "tick:3",
           "acquire", "release", "acquire", "succ", "state", "acquire",
           "fail", "fail", "fail", "tick:10", "acquire", "succ", "state"])


@pytest.mark.parametrize("probes", [1, 2])
def test_breaker_state_sequence_matches(probes):
    """One scripted event list against each package's breaker on an
    injected clock: the state after every event, each acquire's
    ``(allowed, probe)`` and the trip count are equal."""
    out = {}
    for k, r in PKGS.items():
        clock = _Clock()
        br = r.CircuitBreaker(failure_threshold=3, cooldown=4.0,
                              half_open_probes=probes, clock=clock)
        trace = []
        for ev in SCRIPT:
            if ev.startswith("tick:"):
                clock.t += float(ev[5:])
            elif ev == "fail":
                br.record_failure()
            elif ev == "succ":
                br.record_success()
            elif ev == "release":
                br.release_probe()
            elif ev == "acquire":
                trace.append(br.acquire())
            trace.append(br.state)
        out[k] = (trace, br.open_events)
    assert out["torch"] == out["jax"]
    assert "open" in out["torch"][0] and "half_open" in out["torch"][0]


# ------------------------------------------------------------- fault plans
PLANS = [
    {"execute": ["unavailable*2", "ok", "fatal"], "http": "deadline"},
    {"decode": ["connrefused", "ok*3", "unavailable"]},
    {"compile": "fatal*3", "replica_exec": ["ok", "fatal"]},
]


@pytest.mark.parametrize("plan", PLANS)
def test_fault_plan_expansion_and_kinds_match(plan):
    """The expanded queues, and what each hit raises (class, transient,
    message), site by site until every queue is spent."""
    out = {}
    for k, f in (("jax", jfaults), ("torch", tfaults)):
        fp = f.FaultPlan(plan)
        queues = {s: list(q) for s, q in fp._queues.items()}
        hits = []
        with fp:
            for site in sorted(plan):
                for _ in range(len(queues[site]) + 1):
                    try:
                        f.maybe_fault(site)
                        hits.append((site, None))
                    except f.FaultInjected as e:
                        hits.append((site, e.kind, e.transient, str(e)))
        out[k] = (queues, hits, fp.triggered, fp.pending())
    assert out["torch"] == out["jax"]
    with pytest.raises(ValueError):
        tfaults.FaultPlan({"nowhere": "fatal"})


def test_fault_plan_from_env_matches(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_FAULT_PLAN",
                       '{"execute": ["unavailable", "ok", "fatal"]}')
    out = {}
    for k, f in (("jax", jfaults), ("torch", tfaults)):
        kinds = []
        for _ in range(4):
            try:
                f.maybe_fault("execute")
                kinds.append(None)
            except f.FaultInjected as e:
                kinds.append((e.kind, e.transient))
        out[k] = kinds
    assert out["torch"] == out["jax"] == [("unavailable", True), None,
                                          ("fatal", False), None]


def _exceptions(r, f):
    """The same exception set built from one package's classes."""
    return [
        f.FaultInjected("execute", "unavailable", "UNAVAILABLE: x", True),
        f.FaultInjected("execute", "fatal", "UNAVAILABLE but fatal", False),
        r.BackendUnavailableError("UNAVAILABLE: gave up"),
        r.DeadlineExceededError("deadline exceeded"),
        r.RankFailureError("connection reset while reducing"),
        r.OverloadedError("unavailable: queue full"),
        r.ServerClosedError("connection closed"),
        r.RequestCancelledError("connection reset"),
        ConnectionRefusedError("nope"), ConnectionResetError(),
        BrokenPipeError(), RuntimeError("UNAVAILABLE: tunnel down"),
        RuntimeError("DEADLINE_EXCEEDED"), RuntimeError("Broken pipe"),
        RuntimeError("failed to connect to all addresses"),
        RuntimeError("Socket closed"), RuntimeError("too many pings"),
        ValueError("shape mismatch"), TypeError("bad dtype"),
        MemoryError(), TimeoutError("timed out"), KeyError("x"),
    ]


def test_is_transient_matches_over_one_set():
    got = {k: [r.is_transient(e) for e in _exceptions(r, f)]
           for (k, r), f in zip(PKGS.items(), (jfaults, tfaults))}
    assert got["torch"] == got["jax"]
    assert any(got["torch"]) and not all(got["torch"])


# ------------------------------------------------------------ backend_call
SCENARIOS = [
    ({"execute": ["unavailable", "unavailable"]}, 3),
    ({"execute": ["unavailable*3"]}, 1),
    ({"execute": ["fatal"]}, 2),
    ({"execute": ["unavailable*3", "unavailable*3", "ok"]}, 4),
    ({"execute": ["deadline", "ok", "connrefused"]}, 3),
]


@pytest.mark.parametrize("plan,calls", SCENARIOS)
def test_backend_call_counters_and_breaker_match(plan, calls):
    """``calls`` calls of ``backend_call('execute', fn)`` under one plan and
    one retry policy (no sleeping): each call's outcome, the fn's runs,
    the counters and the breaker's state and trips are equal."""
    out = {}
    for (k, r), f in zip(PKGS.items(), (jfaults, tfaults)):
        br = r.CircuitBreaker(failure_threshold=4, cooldown=60.0,
                              clock=_Clock())
        pol = r.RetryPolicy(max_attempts=3, base_delay=0.0, jitter=False,
                            sleep=lambda d: None)
        ran = [0]

        def fn():
            ran[0] += 1
            return ran[0]
        trace = []
        with f.FaultPlan(plan):
            for _ in range(calls):
                try:
                    trace.append(("ok", r.backend_call("execute", fn,
                                                       retry=pol,
                                                       breaker=br)))
                except Exception as e:  # noqa: BLE001 - the outcome
                    trace.append((type(e).__name__,
                                  type(e.__cause__).__name__))
                trace.append(br.state)
        snap = {c: getattr(r.counters, c) for c in
                ("retries", "faults_injected", "breaker_short_circuits")}
        out[k] = (trace, ran[0], snap, br.open_events)
    assert out["torch"] == out["jax"]


def test_backend_breaker_opens_and_short_circuits_alike():
    """The shared backend breaker: enough exhausted calls trip it, the
    next call short-circuits with BackendUnavailableError, and the
    counters' snapshot (the profiler section) agrees."""
    out = {}
    for (k, r), f in zip(PKGS.items(), (jfaults, tfaults)):
        pol = r.RetryPolicy(max_attempts=1, sleep=lambda d: None)
        names = []
        with f.FaultPlan({"execute": ["unavailable*5"]}):
            for _ in range(6):
                try:
                    r.backend_call("execute", lambda: 1, retry=pol)
                except Exception as e:  # noqa: BLE001 - the outcome
                    names.append(type(e).__name__)
        out[k] = (names, r.counters.snapshot())
    assert out["torch"] == out["jax"]
    assert out["torch"][1]["backend_breaker_state"] == "open"


# --------------------------------------------------------------- port only
def test_error_classes_are_one_set_of_objects():
    for name in ("BackendUnavailableError", "DeadlineExceededError",
                 "OverloadedError", "RankFailureError"):
        assert getattr(tres, name) is getattr(terror, name) \
            is getattr(tpolicy, name)
    for name in ("ServerClosedError", "RequestCancelledError"):
        assert getattr(tres, name) is getattr(tbase, name) \
            is getattr(terror, name) is getattr(tpolicy, name)
    from mxnet_tpu_torch.serving import batcher, server
    assert batcher.OverloadedError is tres.OverloadedError
    assert server.BackendUnavailableError is tres.BackendUnavailableError
    assert terror.get_error_class("RankFailureError") is tres.RankFailureError


def test_degrade_to_cpu_raises(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_DEGRADE_TO_CPU", "1")
    ran = []
    with pytest.raises(tbase.MXNetError, match="never falls back to the CPU"):
        tres.backend_call("execute", lambda: ran.append(1))
    assert not ran and tres.counters.degrades == 0


@pytest.mark.parametrize("msg", [
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: unspecified launch failure",
    "CUDA error: CUDA-capable device(s) is/are busy or unavailable",
    "CUBLAS_STATUS_EXECUTION_FAILED when calling cublasSgemm (unavailable)",
])
def test_cuda_error_is_never_retried(msg):
    """A CUDA error (even one whose text says unavailable) is not
    transient: backend_call runs the call once, passes the error through
    and leaves the breaker closed."""
    import torch
    exc = RuntimeError(msg)
    assert not tres.is_transient(exc) and tres.is_cuda_error(exc)
    assert not tres.is_transient(torch.cuda.OutOfMemoryError("CUDA out of "
                                                             "memory"))
    ran = [0]

    def broken():
        ran[0] += 1
        raise RuntimeError(msg)
    br = tres.CircuitBreaker(failure_threshold=1)
    with pytest.raises(RuntimeError, match="CUDA|CUBLAS"):
        tres.backend_call("execute", broken, breaker=br,
                          retry=tres.RetryPolicy(max_attempts=5,
                                                 sleep=lambda d: None))
    assert ran[0] == 1 and br.state == "closed"
    assert tres.counters.retries == 0
