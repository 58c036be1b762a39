"""Replica lifecycle: spawn, readiness, monitoring, teardown.

Counterpart of ``mxnet_tpu/fleet/manager.py``.  The
:class:`ReplicaManager` turns a role spec (``["mixed", "mixed"]`` or
``["prefill", "decode", "decode"]``) into N engine processes, each running
a :class:`~mxnet_tpu_torch.serving.server.ModelServer` with its HTTP
surface on a freshly picked loopback port.  The manager does NOT know how
to build a model: the caller supplies ``command_for(role, port) -> argv``
(in practice ``tools/serve_torch.py`` with ``--role``/``--port``, which
warms the role's CUDA graph family before it binds).  Readiness is
observed the way the router observes health: ``GET /ping`` answering
SERVING, retried through the serving
:class:`~mxnet_tpu_torch.serving.server.Client`'s connection-refused retry
policy while the child warms up.

Teardown follows the ``tools/launch.py`` straggler discipline: SIGTERM
first (the replica drains: ``/ping`` flips to DRAINING with the remaining
in-flight count), SIGKILL whatever outlives the grace window.

**Supervision** (:meth:`ReplicaManager.start_supervisor`): a daemon loop
re-checks every replica on a ``MXNET_FLEET_SUPERVISE_S`` cadence.  A dead
process is definitive and respawned immediately (same role, same port, so
the Router's endpoint identity is stable); a live process whose ``/ping``
fails or reports DEGRADED for ``MXNET_FLEET_DEAD_AFTER`` *consecutive*
checks is killed and respawned (one bad ping is a blip, not a death).
Respawns back off exponentially per replica
(:class:`~mxnet_tpu_torch.resilience.RetryPolicy` schedule, jitter-free so
tests can assert the intervals) while the replica keeps crash-looping; the
count resets once it stays up past the stability window.  CUDA graphs do
not outlive their process, so a respawned replica captures its role's
graph family again before it answers ``/ping`` (the readiness grace
covers that warmup), then re-advertises its prefix digests through the
Router's ``/fleet/state`` poll before it takes traffic.  On one card each
child holds its own CUDA context and weights; a SIGKILLed child's device
memory returns to the card with its process.
"""
from __future__ import annotations

import signal
import socket
import subprocess
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..base import MXNetError, env as _env
from ..observability import metrics as _metrics
from ..resilience import RetryPolicy, is_transient

__all__ = ["ManagedReplica", "ReplicaManager", "free_port"]

_M_RESTARTS = _metrics.registry().counter(
    "mxnet_tpu_fleet_restarts_total",
    "Replica processes respawned by the ReplicaManager supervisor (dead "
    "process, or MXNET_FLEET_DEAD_AFTER consecutive failed/DEGRADED "
    "control-plane pings)",
    labels=("role",))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ManagedReplica:
    """One spawned engine process and where to reach it."""

    __slots__ = ("role", "host", "port", "proc")

    def __init__(self, role: str, host: str, port: int,
                 proc: subprocess.Popen):
        self.role = role
        self.host = host
        self.port = port
        self.proc = proc

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def alive(self) -> bool:
        return self.proc.poll() is None

    def describe(self) -> Dict[str, Any]:
        return {"url": self.url, "role": self.role, "pid": self.proc.pid,
                "returncode": self.proc.poll()}


class ReplicaManager:
    """Spawn and watch one replica per role in ``roles``.

    ``command_for(role, port)`` must return the argv of a process that
    serves the ModelServer HTTP surface on ``127.0.0.1:<port>`` with the
    given disaggregation role and answers ``GET /ping`` once ready."""

    def __init__(self, command_for: Callable[[str, int], Sequence[str]],
                 roles: Sequence[str], host: str = "127.0.0.1",
                 ready_timeout: float = 180.0, env: Optional[Dict] = None):
        for role in roles:
            if role not in ("mixed", "prefill", "decode"):
                raise MXNetError(f"replica role must be "
                                 f"mixed/prefill/decode, got {role!r}")
        self._command_for = command_for
        self._roles = list(roles)
        self._host = host
        self._ready_timeout = float(ready_timeout)
        self._env = env
        self.replicas: List[ManagedReplica] = []
        # supervisor state
        self._sup_thread: Optional[threading.Thread] = None
        self._sup_stop = threading.Event()
        self._sup_lock = threading.Lock()
        self._crash_counts: Dict[int, int] = {}   # consecutive respawns
        self._bad_pings: Dict[int, int] = {}      # consecutive failed pings
        self._alive_since: Dict[int, float] = {}  # for stability reset
        self._seen_serving: Dict[int, bool] = {}  # answered SERVING yet?
        self._restart_log: List[Dict[str, Any]] = []
        self.restarts = 0

    # -------------------------------------------------------------- spawn
    def start(self, wait_ready: bool = True) -> List[ManagedReplica]:
        import os
        for role in self._roles:
            port = free_port()
            argv = list(self._command_for(role, port))
            env = None
            if self._env is not None:
                env = dict(os.environ)
                env.update(self._env)
            proc = subprocess.Popen(argv, env=env)
            self.replicas.append(ManagedReplica(role, self._host, port,
                                                proc))
        if wait_ready:
            self.wait_ready()
        return self.replicas

    def wait_ready(self) -> None:
        """Block until every replica answers ``GET /ping`` (replicas warm
        their graph families before binding, so this rides the same
        connection-refused retry classification the serving Client uses)."""
        deadline = time.monotonic() + self._ready_timeout
        for rep in self.replicas:
            self._wait_one(rep, deadline)

    def _wait_one(self, rep: ManagedReplica, deadline: float) -> None:
        from ..serving.server import Client
        while True:
            if not rep.alive():
                raise MXNetError(
                    f"replica {rep.url} ({rep.role}) exited rc="
                    f"{rep.proc.poll()} before becoming ready")
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise MXNetError(
                    f"replica {rep.url} ({rep.role}) not ready within "
                    f"{self._ready_timeout:g}s")
            client = Client(rep.url, retry=RetryPolicy(
                max_attempts=8, base_delay=0.25,
                max_delay=min(2.0, max(0.25, remaining / 8)),
                retryable=is_transient))
            try:
                client.ping()
                return
            except Exception:  # noqa: BLE001 — still warming; loop re-checks liveness
                time.sleep(0.25)

    # ------------------------------------------------------------ observe
    def endpoints(self) -> List:
        """``(url, role)`` pairs in spawn order — the Router's ctor input."""
        return [(r.url, r.role) for r in self.replicas]

    def dead(self) -> List[ManagedReplica]:
        return [r for r in self.replicas if not r.alive()]

    def describe(self) -> Dict[str, Any]:
        return {"replicas": [r.describe() for r in self.replicas]}

    # ---------------------------------------------------------- supervision
    def start_supervisor(self, poll_s: Optional[float] = None,
                         dead_after: Optional[int] = None,
                         base_backoff: float = 0.5,
                         max_backoff: float = 30.0,
                         stable_s: float = 30.0,
                         ready_timeout: Optional[float] = None) -> None:
        """Start the self-healing daemon loop (idempotent).

        * **dead process** -> respawned immediately on the same port, with
          per-replica crash-loop exponential backoff (``base_backoff``
          doubling to ``max_backoff``) while it keeps dying; the count
          resets after ``stable_s`` seconds of uninterrupted life.
        * **failed / DEGRADED ping** -> respawned only after
          ``dead_after`` (default ``MXNET_FLEET_DEAD_AFTER``) consecutive
          bad checks — one slow or unlucky poll never bounces a healthy
          replica.  A replica that has not yet answered SERVING since its
          (re)spawn gets a **readiness grace** of ``ready_timeout``
          seconds for unanswered pings (it is still warming its ladder
          before binding); DEGRADED answers are never graced.
        """
        if self._sup_thread is not None:
            return
        self._sup_poll_s = float(_env.MXNET_FLEET_SUPERVISE_S
                                 if poll_s is None else poll_s)
        self._sup_dead_after = max(1, int(_env.MXNET_FLEET_DEAD_AFTER
                                          if dead_after is None
                                          else dead_after))
        self._sup_backoff = RetryPolicy(
            max_attempts=64, base_delay=float(base_backoff),
            max_delay=float(max_backoff), jitter=False).delays()
        self._sup_stable_s = float(stable_s)
        self._sup_ready_timeout = (self._ready_timeout if ready_timeout
                                   is None else float(ready_timeout))
        self._sup_stop.clear()
        now = time.monotonic()
        for i in range(len(self.replicas)):
            self._alive_since.setdefault(i, now)
        self._sup_thread = threading.Thread(target=self._sup_loop,
                                            name="fleet-supervisor",
                                            daemon=True)
        self._sup_thread.start()

    def stop_supervisor(self, timeout: float = 5.0) -> None:
        self._sup_stop.set()
        if self._sup_thread is not None:
            self._sup_thread.join(timeout)
            self._sup_thread = None

    def _sup_loop(self) -> None:
        while not self._sup_stop.wait(self._sup_poll_s):
            for i in range(len(self.replicas)):
                if self._sup_stop.is_set():
                    return
                try:
                    self._sup_check(i)
                except Exception:  # noqa: BLE001 — supervisor never dies
                    pass

    def _ping_status(self, rep: ManagedReplica) -> Optional[str]:
        """One un-retried control-plane check: the /ping status string, or
        None when the endpoint did not answer."""
        import json as _json
        import urllib.request
        try:
            with urllib.request.urlopen(
                    rep.url + "/ping",
                    timeout=max(1.0, self._sup_poll_s)) as resp:
                return _json.loads(resp.read() or b"{}").get("status")
        except Exception:  # noqa: BLE001 — includes the 503 DRAINING reply
            return None

    def _sup_check(self, i: int) -> None:
        rep = self.replicas[i]
        if not rep.alive():
            self._respawn(i, f"process exited rc={rep.proc.poll()}")
            return
        status = self._ping_status(rep)
        if status in ("SERVING", "DRAINING"):
            # DRAINING is a deliberate state (planned drain), never bounced
            self._seen_serving[i] = True
            self._bad_pings[i] = 0
            if (time.monotonic() - self._alive_since.get(i, 0.0)
                    > self._sup_stable_s):
                self._crash_counts[i] = 0  # survived the stability window
            return
        if status is None and not self._seen_serving.get(i) and (
                time.monotonic() - self._alive_since.get(i, 0.0)
                < self._sup_ready_timeout):
            # readiness grace: a (re)spawned replica warms its graph
            # ladder before binding, so an unanswered ping during boot is
            # progress, not failure — without this the supervisor would
            # kill every respawn after dead_after*poll_s and crash-loop a
            # perfectly healthy replica forever
            return
        self._bad_pings[i] = self._bad_pings.get(i, 0) + 1
        if self._bad_pings[i] < self._sup_dead_after:
            return  # damped: a blip, not a death
        reason = ("health sentinel DEGRADED" if status == "DEGRADED"
                  else f"control-plane ping failed x{self._bad_pings[i]}")
        if rep.alive():
            rep.proc.kill()
            rep.proc.wait()
        self._respawn(i, reason)

    def _respawn(self, i: int, reason: str) -> None:
        """Replace replica ``i``'s process on the SAME port, after this
        replica's current crash-loop backoff delay."""
        import os
        rep = self.replicas[i]
        count = self._crash_counts.get(i, 0)
        delay = (self._sup_backoff[min(count, len(self._sup_backoff) - 1)]
                 if count > 0 else 0.0)
        if delay > 0 and self._sup_stop.wait(delay):
            return  # shutdown won the race: leave it down
        argv = list(self._command_for(rep.role, rep.port))
        env = None
        if self._env is not None:
            env = dict(os.environ)
            env.update(self._env)
        proc = subprocess.Popen(argv, env=env)
        with self._sup_lock:
            self.replicas[i] = ManagedReplica(rep.role, rep.host, rep.port,
                                              proc)
            self._crash_counts[i] = count + 1
            self._bad_pings[i] = 0
            self._seen_serving[i] = False  # re-arm the readiness grace
            self._alive_since[i] = time.monotonic()
            self.restarts += 1
            self._restart_log.append({
                "index": i, "role": rep.role, "port": rep.port,
                "reason": reason, "respawn": count + 1,
                "backoff_s": round(delay, 3)})
            if len(self._restart_log) > 256:
                del self._restart_log[:-256]
        _M_RESTARTS.labels(role=rep.role).inc()

    def supervisor_stats(self) -> Dict[str, Any]:
        """Restart totals + per-replica crash-loop view (the Router
        surfaces this under ``describe()["supervisor"]``; diagnose.py
        --fleet renders it)."""
        with self._sup_lock:
            return {
                "running": self._sup_thread is not None,
                "restarts": self.restarts,
                "crash_counts": dict(self._crash_counts),
                "recent": list(self._restart_log[-16:]),
            }

    # ----------------------------------------------------------- teardown
    def kill(self, index: int) -> None:
        """Hard-kill one replica (fault-injection surface for the
        reroute-on-death tests and the fleet bench)."""
        self.replicas[index].proc.kill()
        self.replicas[index].proc.wait()

    def stop(self, grace: float = 10.0) -> List[Optional[int]]:
        """SIGTERM everyone (graceful drain), SIGKILL stragglers after
        ``grace`` seconds; returns the exit codes in spawn order.  The
        supervisor is stopped FIRST so it cannot resurrect a replica the
        teardown just killed."""
        self.stop_supervisor()
        for rep in self.replicas:
            if rep.alive():
                rep.proc.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + max(grace, 0.0)
        for rep in self.replicas:
            if rep.proc.poll() is None:
                try:
                    rep.proc.wait(timeout=max(0.0,
                                              deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    rep.proc.kill()
                    rep.proc.wait()
        return [r.proc.poll() for r in self.replicas]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
