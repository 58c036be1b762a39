"""Fleet front door: a prefix-aware, self-healing HTTP router over N
engine replicas.

Counterpart of ``mxnet_tpu/fleet/router.py``; host code, the same wire as
the JAX package's, so it routes over replicas of either package.  The
Router speaks the SAME wire surface as a single
:class:`~mxnet_tpu_torch.serving.server.ModelServer` (``POST /generate/<model>``,
``POST /predict/<model>``, ``GET /ping`` / ``/stats`` / ``/metrics``), so
clients point at the router URL and are none the wiser — but behind it:

* **control-plane poll** — a daemon thread polls each replica's
  ``GET /fleet/state`` every ``MXNET_FLEET_POLL_S`` seconds: health
  (SERVING / DEGRADED / DRAINING), live load (in-flight count), role, and
  each paged model's **prefix-page digest** (the chain hashes currently
  materialized in its :class:`~mxnet_tpu_torch.serving.paged_cache.PagePool`).
  Replicas are polled **in parallel with a deadline**, so one wedged
  replica cannot stall the view of the rest, and a previously-healthy
  replica is only declared DEAD after ``MXNET_FLEET_DEAD_AFTER``
  *consecutive* poll failures (one slow poll = SUSPECT, still routed on
  last-known-good state; data-plane connection failures still kill it
  instantly — that evidence is definitive).

* **prefix-cache-aware routing** — the request prompt is chain-hashed with
  :func:`~mxnet_tpu_torch.serving.paged_cache.page_hash_chain` and matched
  against each candidate's advertised digest; the replica with the longest
  prefix match wins (its pool replays those pages instead of recomputing
  prefill), ties and no-match fall back to least in-flight.

* **retry on replica death** — connection failures and 503s re-route to
  the next-best replica through a :class:`~mxnet_tpu_torch.resilience.RetryPolicy`
  (``MXNET_FLEET_REROUTES`` attempts); DRAINING replicas are excluded from
  admission while their accepted work finishes.

* **live migration of in-flight streams** — every streaming request keeps
  a per-request **resume journal** (tokens relayed so far, plus cadenced
  K/V snapshots via ``POST /export`` every
  ``MXNET_FLEET_MIGRATE_SNAPSHOT_TOKENS`` generated tokens).  When the
  serving replica dies mid-stream the router re-admits the request on a
  survivor — snapshot K/V attaches through the same ``ext_kv`` wire leg
  disaggregation uses; without a snapshot the survivor re-prefills the
  prompt + generated-so-far prefix.  Greedy decoding is deterministic, so
  the resumed stream's overlap tokens are asserted equal to the journal
  and deduplicated: the client's SSE stream continues with **zero gaps
  and zero duplicates**, token-identical to an uninterrupted run.  The
  same mechanism powers :meth:`Router.rolling_restart` (zero-drop planned
  drain, one replica at a time).

* **hedged requests** — when a stream's first token has not arrived
  within the per-model p99-derived threshold (``MXNET_FLEET_HEDGE_PCTL``
  over observed first-token latencies), the router launches a secondary
  attempt on the next-best replica; whichever yields a first token wins
  and the loser is cancelled (``POST /cancel`` frees its pages
  immediately).

* **prefill/decode disaggregation** — when the fleet has at least one
  alive ``prefill`` replica AND one alive ``decode`` replica, a generate
  request is split: the prefill replica runs the ``[1, L]`` chunked
  prompt forward (``POST /prefill``) and exports the per-layer K/V page
  slices + chain hashes + first token; the router hands that payload to a
  decode replica's ``/generate``.  A failed handoff leg now **falls back
  to single-hop routing** instead of failing the request.

* **one causal trace** — the router opens a ``fleet.route`` span and
  stamps its context into ``X-Mxtpu-Trace-Id`` / ``X-Mxtpu-Parent-Id``;
  replicas reconstruct it, so router hop, replica HTTP span, and scheduler
  decode spans share one trace id across process boundaries.

Chaos sites (:mod:`mxnet_tpu_torch.resilience.faults`): ``route`` fires before
replica selection, ``relay`` between forwarded SSE events (transient =
relay-leg loss, exercised as a migration), ``prefill_handoff`` on the
disaggregation leg (any failure falls back to single-hop).
"""
from __future__ import annotations

import json
import queue as _queue
import threading
import time
import uuid
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError, env as _env
from ..observability import metrics as _metrics, tracing as _tracing
from ..resilience import (FaultInjected, OverloadedError, RetryPolicy,
                          maybe_fault)
from ..serving.paged_cache import page_hash_chain
from ..serving.server import (ReplicaDeadError, next_sse_event,
                              trace_headers)

__all__ = ["Router", "ReplicaEndpoint", "ReplicaDeadError"]

_M_REQUESTS = _metrics.registry().counter(
    "mxnet_tpu_fleet_requests_total",
    "Requests through the fleet Router by terminal outcome",
    labels=("model", "outcome"))
_M_PREFIX_ROUTED = _metrics.registry().counter(
    "mxnet_tpu_fleet_prefix_routed_total",
    "Requests routed by a non-empty prefix-digest match (vs least-loaded)",
    labels=("model",))
_M_REROUTES = _metrics.registry().counter(
    "mxnet_tpu_fleet_reroutes_total",
    "Re-route attempts after a replica refused, shed, or died",
    labels=("model",))
_M_HANDOFF_BYTES = _metrics.registry().counter(
    "mxnet_tpu_fleet_handoff_bytes_total",
    "K/V bytes shipped prefill replica -> decode replica (disaggregation)",
    labels=("model",))
_M_REPLICAS = _metrics.registry().gauge(
    "mxnet_tpu_fleet_replicas",
    "Replica count by observed state at the last control-plane poll",
    labels=("state",))
_M_ROUTE_SECONDS = _metrics.registry().histogram(
    "mxnet_tpu_fleet_route_seconds",
    "End-to-end router time per request (routing + replica round trip)",
    labels=("model",),
    buckets=_metrics.exponential_buckets(1e-4, 2.0, 20))
_M_MIGRATIONS = _metrics.registry().counter(
    "mxnet_tpu_fleet_migrations_total",
    "Live migrations of in-flight streams to a survivor replica, by "
    "outcome (ok: resumed and deduped against the journal; failed: no "
    "survivor could take the request)",
    labels=("model", "outcome"))
_M_MIGRATION_SECONDS = _metrics.registry().histogram(
    "mxnet_tpu_fleet_migration_seconds",
    "Wall time from detecting a dead stream to the survivor's stream "
    "being open (snapshot attach or re-prefill included)",
    labels=("model",),
    buckets=_metrics.exponential_buckets(1e-3, 2.0, 16))
_M_HEDGES = _metrics.registry().counter(
    "mxnet_tpu_fleet_hedges_total",
    "Hedged (secondary) stream attempts by outcome: won = the hedge "
    "delivered the first token, lost = the primary did and the hedge was "
    "cancelled",
    labels=("model", "outcome"))
_M_CANCELLED = _metrics.registry().counter(
    "mxnet_tpu_fleet_cancelled_total",
    "Upstream generations the Router cancelled to free replica pages, by "
    "reason (hedge_loser, client_disconnect, rolling_restart)",
    labels=("model", "reason"))

# SSE error-event types the relay treats as a dead/drained replica and
# therefore migratable; anything else is a terminal request error.
_MIGRATABLE = (ReplicaDeadError.__name__, "ServerClosedError")


class ReplicaEndpoint:
    """One replica as the router sees it: static identity (url, role) plus
    the mutable view from the last control-plane poll."""

    __slots__ = ("url", "role", "alive", "status", "in_flight", "digests",
                 "page_tokens", "last_error", "poll_failures", "cordoned")

    def __init__(self, url: str, role: str = "mixed"):
        if role not in ("mixed", "prefill", "decode"):
            raise MXNetError(f"replica role must be mixed/prefill/decode, "
                             f"got {role!r}")
        self.url = url.rstrip("/")
        self.role = role
        self.alive = False
        self.status = "UNKNOWN"
        self.in_flight = 0
        self.digests: Dict[str, frozenset] = {}
        self.page_tokens: Dict[str, int] = {}
        self.last_error: Optional[str] = None
        self.poll_failures = 0   # consecutive control-plane poll failures
        self.cordoned = False    # planned drain: no new admissions

    def admittable(self) -> bool:
        return self.alive and self.status != "DRAINING" and not self.cordoned

    def describe(self) -> Dict[str, Any]:
        return {"url": self.url, "role": self.role, "alive": self.alive,
                "status": self.status, "in_flight": self.in_flight,
                "digest_pages": {m: len(d) for m, d in self.digests.items()},
                "poll_failures": self.poll_failures,
                "cordoned": self.cordoned,
                "last_error": self.last_error}


class _StreamJob:
    """One live streaming request's resume journal: everything the router
    needs to re-admit the request on a survivor if its replica dies
    mid-stream — the original prompt/budget, every token already relayed
    to the client, and the latest cadenced K/V snapshot."""

    __slots__ = ("key", "model", "prompt", "max_new", "base", "roles",
                 "rep", "conn", "cur_rid", "relayed", "snapshot", "snap_at",
                 "migrations", "evacuating")

    def __init__(self, key: str, model: str, prompt: List[int],
                 max_new: int, base: Dict[str, Any],
                 roles: Tuple[str, ...], rep: ReplicaEndpoint, conn,
                 cur_rid: str):
        self.key = key            # client-visible request id (journal key)
        self.model = model
        self.prompt = prompt      # ORIGINAL prompt, never the resume prompt
        self.max_new = max_new    # ORIGINAL budget
        self.base = base          # payload sans prompt/max_new/kv/rid
        self.roles = roles
        self.rep = rep            # replica currently serving the stream
        self.conn = conn          # its live connection (closed to force-migrate)
        self.cur_rid = cur_rid    # rid on the CURRENT replica (changes per hop)
        self.relayed: List[int] = []   # tokens already delivered downstream
        self.snapshot: Optional[Dict[str, Any]] = None  # last /export body
        self.snap_at = 0          # len(relayed) at the last snapshot attempt
        self.migrations = 0
        self.evacuating = False   # planned drain in progress (see _evacuate)


def _get_json(url: str, timeout: float) -> Dict[str, Any]:
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read() or b"{}")


class Router:
    """The fleet front door.  ``replicas`` is a list of URLs, ``(url,
    role)`` pairs, or :class:`ReplicaEndpoint` objects."""

    def __init__(self, replicas: Sequence, poll_s: Optional[float] = None,
                 prefix_routing: Optional[bool] = None,
                 reroutes: Optional[int] = None,
                 request_timeout: float = 120.0,
                 dead_after: Optional[int] = None,
                 snapshot_tokens: Optional[int] = None,
                 hedge_pctl: Optional[float] = None):
        self.replicas: List[ReplicaEndpoint] = []
        for r in replicas:
            if isinstance(r, ReplicaEndpoint):
                self.replicas.append(r)
            elif isinstance(r, str):
                self.replicas.append(ReplicaEndpoint(r))
            else:
                self.replicas.append(ReplicaEndpoint(*r))
        if not self.replicas:
            raise MXNetError("Router needs at least one replica")
        self.poll_s = float(_env.MXNET_FLEET_POLL_S
                            if poll_s is None else poll_s)
        self.prefix_routing = bool(_env.MXNET_FLEET_PREFIX_ROUTING
                                   if prefix_routing is None
                                   else prefix_routing)
        self.reroutes = int(_env.MXNET_FLEET_REROUTES
                            if reroutes is None else reroutes)
        self.dead_after = max(1, int(_env.MXNET_FLEET_DEAD_AFTER
                                     if dead_after is None else dead_after))
        self.snapshot_tokens = int(_env.MXNET_FLEET_MIGRATE_SNAPSHOT_TOKENS
                                   if snapshot_tokens is None
                                   else snapshot_tokens)
        self.hedge_pctl = float(_env.MXNET_FLEET_HEDGE_PCTL
                                if hedge_pctl is None else hedge_pctl)
        self.request_timeout = float(request_timeout)
        self._lock = threading.Lock()
        self._closed = threading.Event()
        self._poller: Optional[threading.Thread] = None
        self._httpd = None
        self._http_thread = None
        # self-healing bookkeeping (plain ints mirror the metric families
        # so describe() needs no registry scrape)
        self._jobs: Dict[str, _StreamJob] = {}
        self.migrations = 0
        self.hedges_won = 0
        self.hedges_lost = 0
        self.cancelled = 0
        self._ft_samples: Dict[str, deque] = {}  # first-token latencies
        self._supervisor_stats: Optional[Callable[[], Dict[str, Any]]] = None
        self.refresh()

    # ------------------------------------------------------- control plane
    def refresh(self) -> None:
        """One poll pass over every replica (the poller calls this on a
        cadence; tests call it directly to skip the sleep).  Replicas are
        polled in parallel, each under the pass's deadline, so one wedged
        ``/fleet/state`` cannot stall the others or the caller.  Failure
        damping: a replica that has answered before survives up to
        ``dead_after - 1`` consecutive bad polls as SUSPECT (still routed
        on its last-known-good state); a replica never seen alive is DEAD
        on its first failure."""
        deadline = max(1.0, self.poll_s)
        results: Dict[int, Any] = {}

        def poll_one(rep: ReplicaEndpoint):
            try:
                results[id(rep)] = _get_json(rep.url + "/fleet/state",
                                             timeout=deadline)
            except Exception as e:  # noqa: BLE001 — recorded, damped below
                results[id(rep)] = e

        threads = []
        for rep in self.replicas:
            t = threading.Thread(target=poll_one, args=(rep,), daemon=True,
                                 name="fleet-poll-one")
            t.start()
            threads.append(t)
        t_end = time.monotonic() + deadline + 0.1
        for t in threads:
            t.join(max(0.0, t_end - time.monotonic()))

        counts = {"alive": 0, "dead": 0, "draining": 0, "suspect": 0}
        for rep in self.replicas:
            got = results.get(id(rep))
            if got is None or isinstance(got, Exception):
                rep.poll_failures += 1
                rep.last_error = (repr(got) if got is not None else
                                  f"/fleet/state poll exceeded "
                                  f"{deadline:.1f}s")
                if rep.poll_failures >= self.dead_after or not rep.alive:
                    rep.alive = False
                    rep.status = "DEAD"
                    counts["dead"] += 1
                else:
                    counts["suspect"] += 1  # keep last-known-good view
                continue
            state = got
            rep.poll_failures = 0
            rep.alive = True
            rep.last_error = None
            rep.status = state.get("status", "SERVING")
            rep.in_flight = int(state.get("in_flight", 0))
            digests, ptoks = {}, {}
            for name, m in state.get("models", {}).items():
                if m.get("kind") == "generation" and "prefix_digest" in m:
                    digests[name] = frozenset(m["prefix_digest"])
                    ptoks[name] = int(m.get("page_tokens", 0))
            rep.digests = digests
            rep.page_tokens = ptoks
            counts["draining" if rep.status == "DRAINING" else "alive"] += 1
        for state_name, n in counts.items():
            _M_REPLICAS.labels(state=state_name).set(n)

    def _mark_dead(self, rep: ReplicaEndpoint, err) -> None:
        """Data-plane death evidence (connection refused/reset mid-request)
        is definitive: no damping, the replica is DEAD now."""
        rep.alive = False
        rep.status = "DEAD"
        rep.poll_failures = max(rep.poll_failures, self.dead_after)
        rep.last_error = err if isinstance(err, str) else repr(err)

    def _poll_loop(self):
        while not self._closed.wait(self.poll_s):
            self.refresh()

    def start_poller(self) -> None:
        if self._poller is None:
            self._poller = threading.Thread(target=self._poll_loop,
                                            name="fleet-router-poll",
                                            daemon=True)
            self._poller.start()

    # ------------------------------------------------------------- routing
    def _candidates(self, roles: Tuple[str, ...],
                    exclude: frozenset) -> List[ReplicaEndpoint]:
        return [r for r in self.replicas
                if r.admittable() and r.role in roles
                and r.url not in exclude]

    def _disaggregated(self) -> bool:
        """Disaggregation policy is active iff the fleet has BOTH an
        admittable prefill replica and an admittable decode replica;
        otherwise every request takes the mixed path on whatever is up."""
        return (bool(self._candidates(("prefill",), frozenset()))
                and bool(self._candidates(("decode",), frozenset())))

    def _pick(self, model: str, prompt: Optional[Sequence[int]],
              roles: Tuple[str, ...], exclude: frozenset
              ) -> Optional[ReplicaEndpoint]:
        """Longest-advertised-prefix match first, least in-flight as the
        tie-break and the no-match fallback."""
        cands = self._candidates(roles, exclude)
        if not cands:
            return None
        best, best_match = None, 0
        if self.prefix_routing and prompt:
            for rep in cands:
                digest = rep.digests.get(model)
                ptok = rep.page_tokens.get(model, 0)
                if not digest or ptok <= 0:
                    continue
                match = 0
                for h in page_hash_chain([int(t) for t in prompt], ptok):
                    if h not in digest:
                        break
                    match += 1
                if match > best_match or (match == best_match and match > 0
                                          and best is not None
                                          and rep.in_flight
                                          < best.in_flight):
                    best, best_match = rep, match
        if best is not None and best_match > 0:
            _M_PREFIX_ROUTED.labels(model=model).inc()
            return best
        return min(cands, key=lambda r: r.in_flight)

    # ------------------------------------------------------ replica calls
    def _post_replica(self, rep: ReplicaEndpoint, path: str,
                      payload: Dict[str, Any],
                      timeout: Optional[float] = None
                      ) -> Tuple[int, Dict[str, Any]]:
        """One POST to one replica -> ``(status, body)``.  Connection-level
        failures raise (the reroute loop catches them); HTTP error statuses
        return normally so the caller can distinguish reroutable 503 from
        terminal 400/404."""
        import urllib.error
        import urllib.request
        req = urllib.request.Request(
            rep.url + path, data=json.dumps(payload).encode(),
            method="POST", headers={"Content-Type": "application/json",
                                    **trace_headers()})
        try:
            with urllib.request.urlopen(
                    req, timeout=self.request_timeout
                    if timeout is None else timeout) as r:
                return r.status, json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                body = json.loads(e.read() or b"{}")
            except Exception:  # noqa: BLE001 — non-JSON error body
                body = {"error": str(e)}
            return e.code, body

    def _routed_post(self, model: str, path_for: str, payload: Dict[str, Any],
                     prompt: Optional[Sequence[int]],
                     roles: Tuple[str, ...]) -> Tuple[int, Dict[str, Any]]:
        """The reroute loop: pick -> POST -> on connection failure or 503,
        exclude the replica and try the next-best, up to
        ``MXNET_FLEET_REROUTES`` re-picks (RetryPolicy drives the loop so
        backoff/jitter/counters match every other retry site)."""
        tried: set = set()
        state: Dict[str, Any] = {}

        def attempt():
            rep = self._pick(model, prompt, roles, frozenset(tried))
            if rep is None:
                raise OverloadedError(
                    f"no admittable replica for {model!r} "
                    f"(roles {roles}, {len(tried)} excluded)",
                    retry_after_s=self.poll_s)
            tried.add(rep.url)
            try:
                code, body = self._post_replica(rep, path_for, payload)
            except Exception as e:  # connection refused/reset/timeout
                self._mark_dead(rep, e)
                _M_REROUTES.labels(model=model).inc()
                raise OverloadedError(
                    f"replica {rep.url} died: {e!r}") from e
            if code == 503:
                _M_REROUTES.labels(model=model).inc()
                raise OverloadedError(
                    body.get("error", f"replica {rep.url} shed"),
                    retry_after_s=float(body.get("retry_after_s", 0.1)))
            state["result"] = (code, body)
            return state["result"]

        policy = RetryPolicy(max_attempts=1 + self.reroutes, base_delay=0.05,
                             max_delay=1.0,
                             retryable=lambda e: isinstance(e,
                                                            OverloadedError))
        try:
            return policy.call(attempt, site=f"fleet:{path_for}")
        except OverloadedError as e:
            return 503, {"error": str(e),
                         "retry_after_s": getattr(e, "retry_after_s", 1.0)}

    # ----------------------------------------------------- request surface
    def _route_fault(self, model: str
                     ) -> Optional[Tuple[int, Dict[str, Any]]]:
        """The ``route`` chaos site: fires before replica selection.
        ``(status, body)`` when a fault was injected, None to proceed."""
        try:
            maybe_fault("route")
        except Exception as e:  # noqa: BLE001 — injected fault only
            _M_REQUESTS.labels(model=model, outcome="error").inc()
            if isinstance(e, FaultInjected) and e.transient:
                return 503, {"error": str(e), "retry_after_s": 0.5}
            return 500, {"error": str(e)}
        return None

    def route_predict(self, model: str, payload: Dict[str, Any]
                      ) -> Tuple[int, Dict[str, Any]]:
        hurt = self._route_fault(model)
        if hurt is not None:
            return hurt
        t0 = time.monotonic()
        with _tracing.span("fleet.route",
                           attrs={"model": model, "kind": "predict"}) as sp:
            code, body = self._routed_post(
                model, f"/predict/{model}", payload, None,
                ("mixed", "prefill", "decode"))
            sp.set_attr("status", code)
        _M_ROUTE_SECONDS.labels(model=model).observe(time.monotonic() - t0)
        _M_REQUESTS.labels(model=model,
                           outcome="ok" if code == 200 else "error").inc()
        return code, body

    def _prefill_handoff(self, model: str, payload: Dict[str, Any]
                         ) -> Tuple[int, Dict[str, Any]]:
        """Disaggregation first leg: run /prefill on a prefill replica and
        graft the exported K/V into the decode-leg payload.  ANY failure
        (injected ``prefill_handoff`` fault or an organic non-200) returns
        ``(-1, body)`` — the callers fall back to single-hop routing
        rather than failing a request over an optimization leg."""
        try:
            maybe_fault("prefill_handoff")
        except Exception as e:  # noqa: BLE001 — injected handoff fault
            return -1, {"error": str(e)}
        prompt = payload.get("prompt") or []
        code, body = self._routed_post(
            model, f"/prefill/{model}",
            {"prompt": prompt,
             "max_new_tokens": payload.get("max_new_tokens", 16)},
            prompt, ("prefill",))
        if code != 200:
            return -1, body
        wire = body["kv"]
        layers, toks, units = (int(d) for d in wire["shape"])
        _M_HANDOFF_BYTES.labels(model=model).inc(2 * 4 * layers * toks
                                                 * units)
        out = dict(payload)
        out["kv"] = wire
        return 200, out

    def route_generate(self, model: str, payload: Dict[str, Any]
                       ) -> Tuple[int, Dict[str, Any]]:
        """Non-streaming generate: disaggregated prefill->decode when the
        fleet topology supports it (falling back to a single mixed hop if
        the handoff leg fails), single mixed hop otherwise."""
        hurt = self._route_fault(model)
        if hurt is not None:
            return hurt
        t0 = time.monotonic()
        prompt = payload.get("prompt") or []
        with _tracing.span("fleet.route",
                           attrs={"model": model, "kind": "generate",
                                  "prompt_tokens": len(prompt)}) as sp:
            disagg = self._disaggregated()
            sp.set_attr("disaggregated", disagg)
            code = -1
            if disagg:
                code, decode_payload = self._prefill_handoff(model, payload)
                if code == 200:
                    code, body = self._routed_post(
                        model, f"/generate/{model}", decode_payload,
                        prompt, ("decode",))
            if code != 200:
                if disagg:  # handoff leg failed: single-hop fallback
                    _M_REROUTES.labels(model=model).inc()
                code, body = self._routed_post(
                    model, f"/generate/{model}", payload, prompt,
                    ("mixed", "prefill", "decode"))
            sp.set_attr("status", code)
        _M_ROUTE_SECONDS.labels(model=model).observe(time.monotonic() - t0)
        _M_REQUESTS.labels(model=model,
                           outcome="ok" if code == 200 else "error").inc()
        return code, body

    # --------------------------------------------------------- streaming
    def _open_replica_stream(self, rep: ReplicaEndpoint, model: str,
                             payload: Dict[str, Any]):
        """Open the SSE leg on one replica.  Raises on connection failure;
        returns ``(conn, resp)`` on HTTP 200, ``(code, body)`` tuple on an
        HTTP error status (conn already closed)."""
        import http.client
        import urllib.parse
        u = urllib.parse.urlsplit(rep.url)
        conn = http.client.HTTPConnection(u.hostname, u.port,
                                          timeout=self.request_timeout)
        try:
            conn.request("POST", f"/generate/{model}",
                         body=json.dumps(payload),
                         headers={"Content-Type": "application/json",
                                  "Accept": "text/event-stream",
                                  **trace_headers()})
            resp = conn.getresponse()
        except Exception:
            conn.close()
            raise
        if resp.status != 200:
            try:
                body = json.loads(resp.read() or b"{}")
            except Exception:  # noqa: BLE001 — non-JSON error body
                body = {"error": f"HTTP {resp.status}"}
            conn.close()
            return (resp.status, body)
        return (conn, resp)

    # ------------------------------------------------------------ hedging
    def _hedge_threshold(self, model: str) -> Optional[float]:
        """Seconds to wait for a first token before hedging, derived as
        the ``MXNET_FLEET_HEDGE_PCTL`` percentile of this model's observed
        first-token latencies.  None (no hedging) until 16 samples exist
        or when the knob is 0; floored at 50ms so a burst of cache-hot
        samples cannot trigger a hedge storm."""
        if self.hedge_pctl <= 0:
            return None
        samples = self._ft_samples.get(model)
        if samples is None or len(samples) < 16:
            return None
        xs = sorted(samples)
        idx = min(len(xs) - 1, int(len(xs) * self.hedge_pctl / 100.0))
        return max(xs[idx], 0.05)

    def _cancel_replica_rid(self, rep: ReplicaEndpoint, model: str,
                            rid: str, reason: str) -> None:
        """Best-effort async upstream cancel: frees the loser's slot and
        pages without blocking the winner's relay."""
        self.cancelled += 1
        _M_CANCELLED.labels(model=model, reason=reason).inc()

        def _do():
            try:
                self._post_replica(rep, f"/cancel/{model}", {"rid": rid},
                                   timeout=5.0)
            except Exception:  # noqa: BLE001 — loser may be dead too
                pass

        threading.Thread(target=_do, daemon=True,
                         name="fleet-cancel").start()

    def _first_event_maybe_hedged(self, model: str, prompt: List[int],
                                  roles: Tuple[str, ...], tried: set,
                                  payload: Dict[str, Any],
                                  rep: ReplicaEndpoint, conn, resp):
        """Wait for the opened stream's first event; if it does not land
        within the hedge threshold, race a secondary attempt on the
        next-best replica.  Returns ``(first_event, conn, resp, rid, rep)``
        for whichever leg won; the loser is closed and cancelled."""
        rid = payload["rid"]
        threshold = self._hedge_threshold(model)
        if threshold is None:
            return self._next_event(resp), conn, resp, rid, rep
        q: _queue.Queue = _queue.Queue()

        def fetch(tag, r):
            q.put((tag, self._next_event(r)))

        threading.Thread(target=fetch, args=("primary", resp), daemon=True,
                         name="fleet-first-event").start()
        try:
            _tag, ev = q.get(timeout=threshold)
            return ev, conn, resp, rid, rep
        except _queue.Empty:
            pass
        # primary is slow: launch the hedge on the next-best replica
        hrep = self._pick(model, prompt, roles, frozenset(tried | {rep.url}))
        hopened = None
        hrid = rid + "-h"
        if hrep is not None:
            hpayload = dict(payload)
            hpayload["rid"] = hrid
            try:
                o = self._open_replica_stream(hrep, model, hpayload)
                if not isinstance(o[0], int):
                    hopened = o
            except Exception:  # noqa: BLE001 — hedge target dead: no hedge
                hopened = None
        if hopened is None:
            _tag, ev = q.get()   # no hedge possible: wait out the primary
            return ev, conn, resp, rid, rep
        hconn, hresp = hopened
        threading.Thread(target=fetch, args=("hedge", hresp), daemon=True,
                         name="fleet-first-event").start()
        outstanding = {"primary", "hedge"}
        while True:
            tag, ev = q.get()
            outstanding.discard(tag)
            usable = ev is not None and not ("error" in ev
                                             and "token" not in ev)
            if usable or not outstanding:
                break
        if tag == "hedge":
            if usable:
                self.hedges_won += 1
                _M_HEDGES.labels(model=model, outcome="won").inc()
            self._cancel_replica_rid(rep, model, rid, "hedge_loser")
            try:
                conn.close()
            except Exception:  # noqa: BLE001
                pass
            return ev, hconn, hresp, hrid, hrep
        if usable:
            self.hedges_lost += 1
            _M_HEDGES.labels(model=model, outcome="lost").inc()
        self._cancel_replica_rid(hrep, model, hrid, "hedge_loser")
        try:
            hconn.close()
        except Exception:  # noqa: BLE001
            pass
        return ev, conn, resp, rid, rep

    # ---------------------------------------------------------- migration
    def _maybe_snapshot(self, job: _StreamJob) -> None:
        """Cadenced journal deepening: every ``snapshot_tokens`` relayed
        tokens, pull a K/V snapshot of the live request so a later
        migration attaches pages instead of re-prefilling."""
        cad = self.snapshot_tokens
        if cad <= 0 or len(job.relayed) - job.snap_at < cad:
            return
        job.snap_at = len(job.relayed)
        self._snapshot_now(job)

    def _snapshot_now(self, job: _StreamJob) -> bool:
        try:
            code, body = self._post_replica(
                job.rep, f"/export/{job.model}", {"rid": job.cur_rid},
                timeout=max(5.0, self.poll_s))
        except Exception:  # noqa: BLE001 — snapshot is best-effort
            return False
        if code == 200 and body.get("generated"):
            job.snapshot = body
            return True
        return False

    def _migrate(self, job: _StreamJob):
        """Re-admit one dead (or force-drained) stream on a survivor.

        Resume recipe — ``known`` is the snapshot's generated list when a
        K/V snapshot exists, else the journal's relayed list:

        * prompt = original_prompt + known[:-1], budget = original_budget
          - len(known) + 1; with a snapshot the K/V rides along as
          ``ext_kv`` (no recompute), without one the survivor re-prefills.
        * greedy decoding makes the resumed stream reproduce the overlap
          — its first tokens duplicate ``known[len(relayed)-?..]`` — so
          the relay replays any snapshot-ahead-of-relay tokens from the
          journal, then consumes the duplicated overlap, asserting each
          equals the journal (divergence = determinism bug, surfaced
          loudly, never silently relayed).

        Returns ``(conn, resp, replay, dup)`` — tokens to relay from the
        journal immediately, then expected duplicates to consume — or
        None when no survivor could take the request."""
        t0 = time.monotonic()
        src = job.rep
        if not src.cordoned:  # planned drain keeps the source healthy
            self._mark_dead(src, "died mid-stream (relay leg lost)")
        g = len(job.relayed)
        snap = job.snapshot
        if snap is not None and not (snap.get("kv") and snap.get("generated")):
            snap = None
        tried = {src.url}
        for _ in range(1 + self.reroutes + len(self.replicas)):
            rep = self._pick(job.model, job.prompt, job.roles,
                             frozenset(tried))
            if rep is None:
                break
            tried.add(rep.url)
            base = dict(job.base)
            base["stream"] = True
            rid2 = f"{job.key}-m{job.migrations + 1}"
            base["rid"] = rid2
            if snap is not None:
                # a snapshot taken on an already-migrated leg reports its
                # "generated" against the leg's EXTENDED prompt — rebase
                # onto the original prompt so the recipe is hop-count
                # independent: full history = snapshot prompt + generated
                hist = ([int(t) for t in snap.get("prompt") or job.prompt]
                        + [int(t) for t in snap["generated"]])
                known = hist[len(job.prompt):]
                s = len(known)
                full = list(job.prompt) + known
                base["prompt"] = full[:-1]
                base["kv"] = snap["kv"]
                base["max_new_tokens"] = job.max_new - s + 1
                replay = known[g:] if s > g else []
                dup = (job.relayed + replay)[s - 1:]
            else:
                known = [int(t) for t in job.relayed]
                base["prompt"] = list(job.prompt) + known[:-1]
                base["max_new_tokens"] = job.max_new - max(g, 1) + 1
                replay, dup = [], known[-1:]
                if job.roles == ("decode",):
                    # disaggregated fleet: a decode survivor cannot
                    # prefill — re-run the handoff leg on the extended
                    # prompt (its first_token IS the expected duplicate)
                    hcode, hp = self._prefill_handoff(job.model, base)
                    if hcode == 200:
                        base = hp
            try:
                opened = self._open_replica_stream(rep, job.model, base)
            except Exception as e:  # noqa: BLE001 — survivor died too
                self._mark_dead(rep, e)
                continue
            if isinstance(opened[0], int):
                continue  # shed/rejected: try the next survivor
            conn, resp = opened
            job.rep = rep
            job.conn = conn
            job.cur_rid = rid2
            job.evacuating = False
            job.migrations += 1
            with self._lock:
                self.migrations += 1
            _M_MIGRATIONS.labels(model=job.model, outcome="ok").inc()
            _M_MIGRATION_SECONDS.labels(model=job.model).observe(
                time.monotonic() - t0)
            return conn, resp, replay, dup
        _M_MIGRATIONS.labels(model=job.model, outcome="failed").inc()
        return None

    def route_generate_stream(self, model: str, payload: Dict[str, Any]):
        """Streaming generate.  Returns ``(code, dict)`` on terminal error
        or ``(200, events)`` where ``events`` is a generator of SSE event
        dicts.  The router commits to a replica only once its FIRST event
        arrives — until then a dead or shedding replica is transparently
        re-routed (the request was queued, never started, nothing was
        delivered).  After the first token the request carries a resume
        journal: a replica death mid-stream is **migrated** to a survivor
        and the stream continues with zero gaps or duplicates; only when
        no survivor exists does the death surface as a typed error event
        (the client saw output, a silent re-run could contradict it)."""
        hurt = self._route_fault(model)
        if hurt is not None:
            return hurt
        t0 = time.monotonic()
        prompt = [int(t) for t in payload.get("prompt") or []]
        rid = str(payload.get("rid") or uuid.uuid4().hex)
        root = _tracing.span("fleet.route",
                             attrs={"model": model, "kind": "generate",
                                    "stream": True,
                                    "prompt_tokens": len(prompt)})
        with root as sp:
            disagg = self._disaggregated()
            sp.set_attr("disaggregated", disagg)
            stream_payload = dict(payload)
            stream_payload["stream"] = True
            stream_payload["rid"] = rid
            roles: Tuple[str, ...] = ("mixed", "prefill", "decode")
            if disagg:
                code, decode_payload = self._prefill_handoff(
                    model, stream_payload)
                if code == 200:
                    stream_payload = decode_payload
                    roles = ("decode",)
                else:  # handoff leg failed: single-hop fallback
                    _M_REROUTES.labels(model=model).inc()

            tried: set = set()
            committed = None  # (rep, conn, resp, rid_used, first_event)
            terminal = None   # (code, body)
            for _ in range(1 + self.reroutes + len(self.replicas)):
                rep = self._pick(model, prompt, roles, frozenset(tried))
                if rep is None:
                    terminal = (503, {
                        "error": f"no admittable replica for {model!r}",
                        "retry_after_s": self.poll_s})
                    break
                tried.add(rep.url)
                try:
                    opened = self._open_replica_stream(rep, model,
                                                       stream_payload)
                except Exception as e:  # connection-level death
                    self._mark_dead(rep, e)
                    _M_REROUTES.labels(model=model).inc()
                    continue
                if isinstance(opened[0], int):  # HTTP error status
                    code, body = opened
                    if code == 503:
                        _M_REROUTES.labels(model=model).inc()
                        continue
                    terminal = (code, body)
                    break
                conn, resp = opened
                t_open = time.monotonic()
                first, conn, resp, rid_used, rep = \
                    self._first_event_maybe_hedged(
                        model, prompt, roles, tried, stream_payload,
                        rep, conn, resp)
                if first is None or (first.get("error") is not None
                                     and "token" not in first):
                    # died or errored before producing ANYTHING: the
                    # request never started — safe to re-route
                    conn.close()
                    _M_REROUTES.labels(model=model).inc()
                    continue
                self._ft_samples.setdefault(
                    model, deque(maxlen=512)).append(
                    time.monotonic() - t_open)
                committed = (rep, conn, resp, rid_used, first)
                break
            if committed is None and terminal is None:
                terminal = (503, {"error": "replicas exhausted for "
                                           f"{model!r}",
                                  "retry_after_s": self.poll_s})
            if terminal is not None:
                sp.set_attr("status", terminal[0])
                _M_ROUTE_SECONDS.labels(model=model).observe(
                    time.monotonic() - t0)
                _M_REQUESTS.labels(model=model, outcome="error").inc()
                return terminal
            sp.set_attr("status", 200)

        rep, conn, resp, rid_used, first = committed
        job = _StreamJob(
            key=rid, model=model, prompt=prompt,
            max_new=int(payload.get("max_new_tokens", 16)),
            base={k: v for k, v in stream_payload.items()
                  if k not in ("prompt", "max_new_tokens", "kv", "rid")},
            roles=roles, rep=rep, conn=conn, cur_rid=rid_used)
        with self._lock:
            self._jobs[job.key] = job

        def _migratable_event(ev) -> bool:
            if ev is None or ev.get("error") is None:
                return ev is None
            if ev.get("type") in _MIGRATABLE:
                return True
            # an evacuation races its own replica-side cancel: the cancel
            # event may already sit in the relay's read buffer when the
            # leg is torn down — for an evacuating job that event MEANS
            # "migrate", not "fail"
            return (ev.get("type") == "RequestCancelledError"
                    and (job.evacuating or job.rep.cordoned))

        def relay():
            outcome = "error"
            conn_, resp_ = conn, resp
            ev = first
            try:
                while True:
                    if _migratable_event(ev):
                        try:
                            conn_.close()
                        except Exception:  # noqa: BLE001
                            pass
                        res = self._migrate(job)
                        if res is None:
                            # no survivor: surface the ORIGINAL event so
                            # single-replica death semantics are unchanged
                            yield (ev if ev is not None else
                                   {"error": "replica died mid-stream "
                                             "(connection closed before "
                                             "completion)",
                                    "type": ReplicaDeadError.__name__})
                            return
                        conn_, resp_, replay, dup = res
                        for t in replay:  # journal is ahead of the relay
                            job.relayed.append(int(t))
                            yield {"token": int(t)}
                        diverged = want = None
                        for want in dup:
                            ev2 = self._next_event(resp_)
                            if _migratable_event(ev2):
                                break  # survivor died too: migrate again
                            if "token" not in ev2 \
                                    or int(ev2["token"]) != int(want):
                                diverged = ev2
                                break
                        else:
                            ev = self._next_event(resp_)
                            continue
                        if diverged is not None:
                            yield {"error":
                                   "migration resume diverged from the "
                                   f"journal (expected token {want}, got "
                                   f"{diverged}) — greedy determinism "
                                   "violated", "type": "MXNetError"}
                            return
                        ev = None
                        continue
                    if ev.get("error") is not None:
                        yield ev  # terminal typed error: not migratable
                        return
                    if ev.get("done"):
                        # a resumed replica only knows ITS leg; the done
                        # event's token list is rewritten from the journal
                        yield {"done": True,
                               "tokens": [int(t) for t in job.relayed]}
                        outcome = "ok"
                        return
                    if "token" in ev:
                        tok = int(ev["token"])
                        job.relayed.append(tok)
                        yield {"token": tok}
                        self._maybe_snapshot(job)
                    try:
                        maybe_fault("relay")
                    except FaultInjected as e:
                        if e.transient:
                            ev = None  # injected relay-leg loss: migrate
                            continue
                        yield {"error": str(e), "type": type(e).__name__}
                        return
                    ev = self._next_event(resp_)
            except GeneratorExit:
                # downstream client walked away: cancel upstream so the
                # replica frees the slot + pages instead of generating
                # tokens nobody will read
                self._cancel_replica_rid(job.rep, job.model, job.cur_rid,
                                         "client_disconnect")
                outcome = "cancelled"
                raise
            finally:
                try:
                    conn_.close()
                except Exception:  # noqa: BLE001
                    pass
                with self._lock:
                    self._jobs.pop(job.key, None)
                _M_ROUTE_SECONDS.labels(model=model).observe(
                    time.monotonic() - t0)
                _M_REQUESTS.labels(model=model, outcome=outcome).inc()

        return 200, relay()

    @staticmethod
    def _next_event(resp) -> Optional[Dict[str, Any]]:
        """Next ``data:`` event off one SSE response; None on EOF, a torn
        final chunk, or a broken connection (the migratable signals)."""
        try:
            return next_sse_event(resp)
        except Exception:  # noqa: BLE001 — connection reset mid-read
            return None

    # ------------------------------------------------------ rolling restart
    def rolling_restart(self, restart_fn: Callable[[int, ReplicaEndpoint],
                                                   Any],
                        ready_timeout: float = 60.0,
                        drain_timeout: float = 30.0,
                        evac_timeout: float = 15.0) -> List[Dict[str, Any]]:
        """Zero-drop rolling restart: one replica at a time — cordon (no
        new admissions), snapshot + force-migrate its live streams to
        survivors, wait for residual in-flight work to drain, call
        ``restart_fn(index, endpoint)`` (which must bring a server back up
        on the same URL), wait for ``/ping`` to report SERVING, uncordon,
        and re-poll so the fresh replica re-advertises its prefix digests
        before the next replica goes down."""
        results = []
        for i, rep in enumerate(self.replicas):
            rep.cordoned = True
            try:
                moved = self._evacuate(rep, evac_timeout)
                t_end = time.monotonic() + drain_timeout
                while time.monotonic() < t_end:
                    try:
                        state = _get_json(rep.url + "/fleet/state",
                                          timeout=2.0)
                    except Exception:  # noqa: BLE001 — already down
                        break
                    if int(state.get("in_flight", 0)) == 0:
                        break
                    time.sleep(0.05)
                restart_fn(i, rep)
                t_end = time.monotonic() + ready_timeout
                back = False
                while time.monotonic() < t_end:
                    try:
                        p = _get_json(rep.url + "/ping", timeout=2.0)
                        if p.get("status") == "SERVING":
                            back = True
                            break
                    except Exception:  # noqa: BLE001 — still booting
                        pass
                    time.sleep(0.05)
                if not back:
                    raise MXNetError(
                        f"rolling restart: replica {rep.url} did not "
                        f"report SERVING within {ready_timeout}s")
                rep.poll_failures = 0
            finally:
                rep.cordoned = False
            self.refresh()  # fresh digests advertised before next round
            results.append({"url": rep.url, "migrated_streams": moved})
        return results

    def _evacuate(self, rep: ReplicaEndpoint, timeout: float = 15.0) -> int:
        """Force-migrate every live stream currently relayed off ``rep``:
        take a fresh snapshot (so migration attaches K/V instead of
        re-prefilling), then close the relay leg — the relay loop sees EOF
        and runs the normal migration path.  Returns the stream count;
        waits until each has either moved off ``rep`` or finished."""
        with self._lock:
            jobs = [j for j in self._jobs.values() if j.rep is rep]
        for job in jobs:
            job.evacuating = True  # cleared by _migrate on the new leg
            self._snapshot_now(job)
            # close the relay leg FIRST (EOF drives the migration path),
            # THEN reap the replica-side request — the reverse order can
            # slip the cancel's error event into the relay's buffer
            try:
                job.conn.close()
            except Exception:  # noqa: BLE001
                pass
            self._cancel_replica_rid(rep, job.model, job.cur_rid,
                                     "rolling_restart")
        t_end = time.monotonic() + timeout
        while time.monotonic() < t_end:
            with self._lock:
                pending = [j for j in jobs
                           if self._jobs.get(j.key) is j and j.rep is rep]
            if not pending:
                break
            time.sleep(0.02)
        return len(jobs)

    # ------------------------------------------------------- observability
    def attach_supervisor(self, stats_fn: Callable[[], Dict[str, Any]]
                          ) -> None:
        """Hook a :class:`~mxnet_tpu_torch.fleet.manager.ReplicaManager`
        supervisor's stats into ``describe()`` (diagnose.py --fleet)."""
        self._supervisor_stats = stats_fn

    def describe(self) -> Dict[str, Any]:
        """``GET /fleet`` body: topology + last-poll view of every
        replica + self-healing counters (diagnose.py --fleet renders
        this)."""
        with self._lock:
            healing = {
                "migrations": self.migrations,
                "hedges_won": self.hedges_won,
                "hedges_lost": self.hedges_lost,
                "cancelled": self.cancelled,
                "journal_depth": len(self._jobs),
                "dead_after": self.dead_after,
                "snapshot_tokens": self.snapshot_tokens,
                "hedge_pctl": self.hedge_pctl,
            }
        out = {"replicas": [r.describe() for r in self.replicas],
               "disaggregated": self._disaggregated(),
               "prefix_routing": self.prefix_routing,
               "poll_s": self.poll_s,
               "reroutes": self.reroutes,
               "self_healing": healing}
        if self._supervisor_stats is not None:
            try:
                out["supervisor"] = self._supervisor_stats()
            except Exception as e:  # noqa: BLE001 — telemetry never fails
                out["supervisor"] = {"error": repr(e)}
        return out

    # ------------------------------------------------------------- server
    def start_http(self, host: str = "127.0.0.1", port: int = 8080,
                   poll: bool = True):
        """Serve the front door (daemon thread), optionally starting the
        control-plane poller.  Returns ``(host, port)``."""
        from http.server import ThreadingHTTPServer
        if poll:
            self.start_poller()
        self._httpd = ThreadingHTTPServer((host, port),
                                          _make_router_handler(self))
        host, port = self._httpd.server_address[:2]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="fleet-router-http",
            daemon=True)
        self._http_thread.start()
        return host, port

    def stop(self, timeout: float = 5.0):
        self._closed.set()
        if self._poller is not None:
            self._poller.join(timeout)
            self._poller = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._http_thread.join(timeout)
            self._httpd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def _make_router_handler(router: Router):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet by default
            pass

        def _reply(self, code: int, payload: Dict[str, Any]):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if code == 503:
                self.send_header("Retry-After", str(max(1, int(round(
                    payload.get("retry_after_s", 1.0))))))
            self.end_headers()
            self.wfile.write(body)

        def _reply_stream(self, events):
            self.protocol_version = "HTTP/1.0"
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            try:
                for event in events:
                    self.wfile.write(b"data: " + json.dumps(event).encode()
                                     + b"\n\n")
                    self.wfile.flush()
            except OSError:
                # client walked away mid-stream: close the relay generator
                # (GeneratorExit inside relay() cancels the upstream
                # request and frees its pages)
                close = getattr(events, "close", None)
                if close is not None:
                    close()

        def do_GET(self):
            if self.path == "/ping":
                self._reply(200, {"status": "SERVING",
                                  "role": "router"})
            elif self.path == "/fleet":
                self._reply(200, router.describe())
            elif self.path == "/stats":
                self._reply(200, router.describe())
            elif self.path == "/metrics":
                text = _metrics.render_prometheus()
                body = text.encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("request body must be a JSON object, "
                                     f"got {type(req).__name__}")
            except Exception as e:  # noqa: BLE001 — malformed body
                self._reply(400, {"error": repr(e)})
                return
            if self.path.startswith("/generate/"):
                name = self.path[len("/generate/"):]
                if req.get("stream"):
                    code, out = router.route_generate_stream(name, req)
                    if code == 200 and not isinstance(out, dict):
                        self._reply_stream(out)
                    else:
                        self._reply(code, out)
                    return
                code, out = router.route_generate(name, req)
                self._reply(code, out)
            elif self.path.startswith("/predict/"):
                name = self.path[len("/predict/"):]
                code, out = router.route_predict(name, req)
                self._reply(code, out)
            else:
                self._reply(404, {"error": f"no route {self.path}"})

    return Handler
