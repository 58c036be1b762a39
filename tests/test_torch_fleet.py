"""Port parity: the fleet tier of ``mxnet_tpu_torch`` (``fleet.Router``,
``fleet.ReplicaManager`` and the replica surfaces under them) against the
JAX package's greedy decode, on the CPU.

Replicas are the port's ModelServers behind real loopback sockets
(threads, not processes) over the port's float32 ``llama_tiny`` (vocab
53, max_length 64, 4-token pages, 2 slots), whose weights are the JAX
package's carried across by ``convert.llama_state_dict_from_mxnet``.
Every stream through the Router, whether disaggregated, migrated, hedged
or restarted, must hold the JAX package's solo ``greedy_decode`` tokens
under tests/test_torch_generation.py's near-tie rule, with no gap and no
duplicate.  Mirrors tests/test_fleet.py; its near-duplicate cases are
parametrised cases here.  The multi-process fleet is in
tests/test_torch_fleet_multiproc.py.
"""
import json
import socket
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import deque

import numpy as np
import pytest
import torch

from mxnet_tpu.serving import GenerationScheduler as JaxScheduler
from mxnet_tpu.serving import ModelServer as JaxServer
from mxnet_tpu.serving import greedy_decode as jax_greedy_decode
from mxnet_tpu_torch import profiler
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.fleet import ReplicaManager, Router, free_port
from mxnet_tpu_torch.observability import metrics
from mxnet_tpu_torch.resilience import (FaultPlan, OverloadedError,
                                        RequestCancelledError,
                                        ServerClosedError)
from mxnet_tpu_torch.serving import Client, ModelServer, TokenStream
from mxnet_tpu_torch.serving.server import (ReplicaDeadError, _remote_error,
                                            decode_kv, encode_kv,
                                            next_sse_event, sse_events)
from test_torch_generation import (MAXLEN, PAGE, VOCAB, _assert_tokens,
                                   _pair, _sched)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def llama():
    """(JAX llama_tiny, the port's on the same weights)."""
    return _pair(0)


_ORACLE = {}


def _want(jnet, prompt, max_new):
    key = (id(jnet), tuple(prompt), max_new)
    if key not in _ORACLE:
        _ORACLE[key] = jax_greedy_decode(jnet, prompt, max_new_tokens=max_new,
                                         min_bucket=8, max_length=MAXLEN)
    return _ORACLE[key]


def _check(jnet, prompt, got, max_new):
    _assert_tokens(jnet, [prompt], [got], [_want(jnet, prompt, max_new)])


def _lm(tnet, name, **kw):
    return _sched(tnet, name=name, max_slots=2, **kw)


def _serve(tnet, name, role="mixed", delay=0.0, port=0, **kw):
    """A ModelServer over a paged scheduler of ``tnet`` on a loopback
    port; ``delay`` slows every step so that events land mid-stream."""
    srv = ModelServer(role=role)
    sched = _lm(tnet, name, **kw)
    if delay:
        orig = sched.step

        def slow_step():
            time.sleep(delay)
            return orig()
        sched.step = slow_step
    srv.register_generation("lm", None, scheduler=sched, warmup=False)
    bound = srv.start_http("127.0.0.1", port)
    return srv, sched, f"http://127.0.0.1:{bound}"


@pytest.fixture(scope="module")
def replicas(llama):
    """Two mixed replicas serving the same weights as ``lm`` (scheduler
    names distinct so their metric series do not collide)."""
    out = [_serve(llama[1], f"lm@r{i}") for i in range(2)]
    yield out
    for srv, _, _ in out:
        srv.stop(timeout=10)


def _counter(name, **labels):
    fam = metrics.registry().get(name)
    return fam.labels(**labels).value if fam is not None else 0.0


def _tokens(events):
    """(tokens, the done event): asserts no error event and that the done
    event repeats exactly the relayed tokens."""
    assert not any("error" in e for e in events), events[-3:]
    toks = [e["token"] for e in events if "token" in e]
    assert events[-1] == {"done": True, "tokens": toks}
    return toks


def _wait(cond, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not cond():
        time.sleep(0.05)
    return cond()


# ===========================================================================
# streaming and the SSE wire
# ===========================================================================
def test_stream_first_token_before_completion(llama):
    """After one scheduler step the stream already holds the prefill
    token while the request is mid-flight."""
    jnet, tnet = llama
    sched = _lm(tnet, "stream-incr")
    prompt = np.random.RandomState(11).randint(1, VOCAB, 5).tolist()
    stream = TokenStream()
    fut = sched.submit(prompt, max_new_tokens=6, stream=stream)
    sched.step()
    assert stream._q.qsize() >= 1 and not fut.done()
    it = stream.events(timeout=30)
    first = next(it)
    sched.run()
    tokens = [first] + list(it)
    assert tokens == fut.result(timeout=0)
    _check(jnet, prompt, tokens, 6)


def test_sse_stream_matches_blocking_byte_for_byte(llama, replicas):
    _, _, url = replicas[0]
    prompt = np.random.RandomState(12).randint(1, VOCAB, 7).tolist()
    blocking = Client(url).generate("lm", prompt, max_new_tokens=6)
    assert list(Client(url).generate_stream("lm", prompt,
                                            max_new_tokens=6)) == blocking
    req = urllib.request.Request(
        f"{url}/generate/lm", method="POST",
        data=json.dumps({"prompt": prompt, "max_new_tokens": 6,
                         "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert resp.headers["Content-Type"].startswith("text/event-stream")
        for raw in resp:
            line = raw.decode().strip()
            if line.startswith("data:"):
                events.append(json.loads(line[len("data:"):]))
    assert _tokens(events) == blocking
    _check(llama[0], prompt, blocking, 6)


def test_stream_replica_death_mid_stream_is_typed_error(llama):
    """A lone replica that stops after tokens were delivered: the Router
    has no survivor, so the stream ends with the typed error event, and
    the client's SSE decoder raises the typed exception."""
    srv, _, url = _serve(llama[1], "lm@dying", delay=0.05)
    router = Router([url], poll_s=999)
    try:
        prompt = np.random.RandomState(13).randint(1, VOCAB, 4).tolist()
        code, events = router.route_generate_stream(
            "lm", {"prompt": prompt, "max_new_tokens": 40})
        assert code == 200
        it = iter(events)
        first = next(it)
        assert "token" in first
        stopper = threading.Thread(target=srv.stop, kwargs={"timeout": 30})
        stopper.start()
        tail = list(it)
        stopper.join(60)
        assert tail[-1].get("type") == "ServerClosedError", tail[-3:]
        with pytest.raises(ServerClosedError):
            list(sse_events(_Dribble(
                [f"data: {json.dumps(e)}\n".encode()
                 for e in [first] + tail])))
    finally:
        router.stop()
        srv.stop(timeout=10)


class _Dribble:
    """An SSE response whose ``readline()`` returns scripted byte pieces,
    partial lines included (what a socket gives when its peer dies
    mid-write)."""

    def __init__(self, pieces):
        self._pieces = list(pieces)

    def readline(self):
        return self._pieces.pop(0) if self._pieces else b""

    def close(self):
        pass


def test_sse_reader_reassembles_dribbled_bytes():
    resp = _Dribble([b"data: {\"tok", b"en\": 5}\n", b"\n", b": keepalive\n",
                     b"data: {\"done\": true, \"tokens\": [5]}\n"])
    assert next_sse_event(resp) == {"token": 5}
    assert next_sse_event(resp) == {"done": True, "tokens": [5]}
    assert next_sse_event(resp) is None
    assert next_sse_event(_Dribble([b"data: {\"token\": 7\n"])) is None
    assert next_sse_event(_Dribble([b"data: {\"tok"])) is None


def test_sse_reader_mid_event_eof_is_typed_replica_death():
    it = sse_events(_Dribble([b"data: {\"token\": 5}\n", b"\n",
                              b"data: {\"done\": true, \"tok"]))
    assert next(it) == 5
    with pytest.raises(ReplicaDeadError) as ei:
        next(it)
    assert isinstance(ei.value, ConnectionError)
    assert isinstance(ei.value, MXNetError)


# ===========================================================================
# the Router: re-route, affinity, draining, overload, faults
# ===========================================================================
@pytest.mark.parametrize("stream", [False, True], ids=["blocking", "sse"])
def test_router_reroutes_around_dead_replica(llama, replicas, stream):
    """A connection-refused replica faked as the best pick: the request is
    re-routed to the survivor (never started, so transparently), the dead
    replica is marked DEAD with its error, the reroute counter moves."""
    _, _, url0 = replicas[0]
    router = Router([f"http://127.0.0.1:{free_port()}", url0], poll_s=999)
    dead = router.replicas[0]
    assert dead.status == "DEAD"   # the constructor's poll noticed
    dead.alive, dead.status, dead.in_flight = True, "SERVING", -1
    before = _counter("mxnet_tpu_fleet_reroutes_total", model="lm")
    # a prompt of its own: no replica advertises its pages, so the pick
    # falls to the least loaded (the dead one)
    prompt = np.random.RandomState(22 + stream).randint(1, VOCAB, 6).tolist()
    payload = {"prompt": prompt, "max_new_tokens": 5}
    if stream:
        code, events = router.route_generate_stream("lm", payload)
        assert code == 200
        toks = _tokens(list(events))
    else:
        code, body = router.route_generate("lm", payload)
        assert code == 200
        toks = body["tokens"]
    _check(llama[0], prompt, toks, 5)
    assert _counter("mxnet_tpu_fleet_reroutes_total", model="lm") > before
    assert dead.status == "DEAD" and dead.last_error


def test_router_prefix_affinity_reuses_cached_pages(llama, replicas):
    """Two requests sharing a 24-token system prompt go through the
    Router's HTTP front door to the same replica, whose prefill maps the
    six shared pages from its prefix cache."""
    (_, s0, url0), (_, s1, url1) = replicas
    router = Router([url0, url1], poll_s=999)
    host, port = router.start_http("127.0.0.1", 0)
    try:
        client = Client(f"http://{host}:{port}")
        rng = np.random.RandomState(21)
        system = rng.randint(1, VOCAB, 24).tolist()
        p1 = system + rng.randint(1, VOCAB, 2).tolist()
        p2 = system + rng.randint(1, VOCAB, 2).tolist()
        admitted = [s0.admitted, s1.admitted]
        routed = _counter("mxnet_tpu_fleet_prefix_routed_total", model="lm")
        t1 = client.generate("lm", p1, max_new_tokens=4)
        router.refresh()   # the digest the first request registered
        target = s0 if s0.admitted > admitted[0] else s1
        hits = target.stats_snapshot()["page_pool"]["prefix_hits"]
        served = target.admitted
        t2 = client.generate("lm", p2, max_new_tokens=4)
        assert target.admitted == served + 1
        assert _counter("mxnet_tpu_fleet_prefix_routed_total",
                        model="lm") > routed
        assert target.stats_snapshot()["page_pool"]["prefix_hits"] \
            >= hits + 6
        _check(llama[0], p1, t1, 4)
        _check(llama[0], p2, t2, 4)
    finally:
        router.stop()


def test_router_excludes_draining_replica(replicas):
    (srv0, _, url0), (_, s1, url1) = replicas
    router = Router([url0, url1], poll_s=999)
    srv0._stopped = True   # the drain begins: health flips, nothing stops
    try:
        router.refresh()
        r0 = router.replicas[0]
        assert r0.status == "DRAINING" and not r0.admittable()
        before = s1.admitted
        prompt = np.random.RandomState(23).randint(1, VOCAB, 5).tolist()
        code, _ = router.route_generate("lm", {"prompt": prompt,
                                               "max_new_tokens": 3})
        assert code == 200 and s1.admitted == before + 1
    finally:
        srv0._stopped = False


def test_ping_exposes_drain_progress(replicas):
    srv0, _, url0 = replicas[0]
    srv0._stopped = True
    try:
        assert srv0.ping_payload()["status"] == "DRAINING"
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{url0}/ping", timeout=10)
        assert ei.value.code == 503
        body = json.loads(ei.value.read())
        assert body["status"] == "DRAINING" and "in_flight" in body
    finally:
        srv0._stopped = False
    assert json.loads(urllib.request.urlopen(
        f"{url0}/ping", timeout=10).read())["status"] == "SERVING"


def test_fleet_state_advertises_digest_and_load(llama, replicas):
    """``GET /fleet/state`` carries the JAX package's keys, at every
    level, for the same configuration; the digest is the pool's chain
    hashes, which are the JAX package's."""
    srv0, s0, url0 = replicas[0]
    state = json.loads(urllib.request.urlopen(
        f"{url0}/fleet/state", timeout=10).read())
    jsrv = JaxServer()
    try:
        jsrv.register_generation("lm", None, warmup=False,
                                 scheduler=JaxScheduler(
                                     llama[0], name="jax-state", max_slots=2,
                                     min_bucket=8, max_length=MAXLEN,
                                     page_tokens=PAGE))
        jstate = jsrv.fleet_state()
    finally:
        jsrv.stop(timeout=10)
    assert set(state) == set(jstate)
    assert set(state["models"]["lm"]) == set(jstate["models"]["lm"])
    # the port's pool statistics add its prefix-cache counters
    assert set(jstate["models"]["lm"]["page_pool"]) \
        <= set(state["models"]["lm"]["page_pool"])
    assert state["role"] == "mixed"
    lm = state["models"]["lm"]
    assert lm["engine"] == "paged" and lm["page_tokens"] == PAGE
    assert lm["prefix_digest"] == s0._target.pool.prefix_digest(512)
    desc = Router([url0], poll_s=999).describe()
    assert desc["disaggregated"] is False
    assert desc["replicas"][0]["role"] == "mixed"


def test_router_overload_surfaces_retry_after(replicas):
    _, _, url0 = replicas[0]
    router = Router([url0], poll_s=999)
    router.replicas[0].alive = False
    router.replicas[0].status = "DEAD"
    code, body = router.route_generate("lm", {"prompt": [1, 2, 3],
                                              "max_new_tokens": 2})
    assert code == 503 and body["retry_after_s"] > 0
    assert isinstance(_remote_error(code, body), OverloadedError)


@pytest.mark.parametrize("kind,code", [("unavailable", 503), ("fatal", 500)])
def test_route_fault_site(replicas, kind, code):
    """The ``route`` site fires before replica selection: a transient
    fault sheds with 503, a fatal one answers 500; the next request
    routes."""
    _, _, url0 = replicas[0]
    router = Router([url0], poll_s=999)
    with FaultPlan({"route": [kind]}) as plan:
        got, body = router.route_generate("lm", {"prompt": [1, 2],
                                                 "max_new_tokens": 2})
        assert got == code and "error" in body
        assert router.route_generate("lm", {"prompt": [1, 2],
                                            "max_new_tokens": 2})[0] == 200
    assert plan.triggered[0] == ("route", kind)


def test_router_describe_reports_self_healing(replicas):
    _, _, url0 = replicas[0]
    router = Router([url0], poll_s=999)
    router.attach_supervisor(lambda: {"running": True, "restarts": 7,
                                      "crash_counts": {}, "recent": []})
    desc = router.describe()
    for key in ("migrations", "hedges_won", "hedges_lost", "cancelled",
                "journal_depth", "dead_after", "snapshot_tokens",
                "hedge_pctl"):
        assert key in desc["self_healing"], key
    assert desc["supervisor"]["restarts"] == 7
    router.attach_supervisor(lambda: 1 / 0)
    assert "error" in router.describe()["supervisor"]
    host, port = router.start_http("127.0.0.1", 0)
    try:
        for path in ("/fleet", "/stats"):
            got = json.loads(urllib.request.urlopen(
                f"http://{host}:{port}{path}", timeout=10).read())
            assert got["replicas"][0]["url"] == url0
        assert json.loads(urllib.request.urlopen(
            f"http://{host}:{port}/ping", timeout=10).read()) == {
            "status": "SERVING", "role": "router"}
        text = urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                      timeout=10).read().decode()
        assert "mxnet_tpu_fleet_replicas" in text
    finally:
        router.stop()


# ===========================================================================
# prefill/decode disaggregation, export and import
# ===========================================================================
def test_disaggregation_parity_scheduler_level(llama):
    """prefill_only -> the wire -> submit(ext_kv=) on another scheduler
    gives the JAX greedy tokens, across page-straddling prompts; the
    decode scheduler runs no prefill (width-1 signatures only), and the
    prefill scheduler's pages park in its prefix cache."""
    jnet, tnet = llama
    pre, dec = _lm(tnet, "disagg-pre"), _lm(tnet, "disagg-dec")
    rng = np.random.RandomState(31)
    for n, m in ((3, 5), (8, 4), (13, 6)):
        prompt = rng.randint(1, VOCAB, n).tolist()
        out = pre.prefill_only(prompt, max_new_tokens=m)
        assert out["k"].dtype == np.float32
        assert out["k"].shape == (2, n, 64)
        kv = decode_kv({"kv": encode_kv(out["k"], out["v"],
                                        out["first_token"])})
        np.testing.assert_array_equal(kv["k"], out["k"])
        fut = dec.submit(prompt, max_new_tokens=m, ext_kv=kv)
        dec.run()
        _check(jnet, prompt, fut.result(timeout=0), m)
    assert {sig[0][0][0][1] for sig in dec.cache_stats["signatures"]} == {1}
    assert pre.stats_snapshot()["page_pool"]["active"] == 0


def test_ext_kv_checks_and_prefill_overload(llama):
    """submit(ext_kv=) refuses what the JAX package refuses; prefill_only
    with no free page raises OverloadedError (503 at /prefill)."""
    _, tnet = llama
    sched = _lm(tnet, "ext-checks")
    k = np.zeros((2, 3, 64), np.float32)
    with pytest.raises(MXNetError, match="shaped"):
        sched.submit([1, 2, 3], ext_kv={"k": k[:, :2], "v": k,
                                        "first_token": 1})
    with pytest.raises(MXNetError, match="first_token"):
        sched.submit([1, 2, 3], ext_kv={"k": k, "v": k})
    dense = _lm(tnet, "ext-dense", kv_cache=False)
    with pytest.raises(MXNetError, match="paged engine"):
        dense.submit([1, 2, 3], ext_kv={"k": k, "v": k, "first_token": 1})
    with pytest.raises(MXNetError, match="paged engine"):
        dense.prefill_only([1, 2, 3])
    tiny = _lm(tnet, "ext-tiny", num_pages=3)   # two allocatable pages
    hold = tiny.submit([1] * 5, max_new_tokens=3)
    tiny.step()                                 # holds both pages
    with pytest.raises(OverloadedError) as ei:
        tiny.prefill_only([2] * 5, max_new_tokens=1)
    assert ei.value.retry_after_s > 0
    srv = ModelServer(role="prefill")
    srv.register_generation("lm", None, scheduler=tiny, warmup=False)
    try:
        code, body = srv.handle_prefill("lm", {"prompt": [2] * 5,
                                               "max_new_tokens": 1})
        assert code == 503 and body["retry_after_s"] > 0
    finally:
        srv.stop(timeout=10)
    assert hold.done()


@pytest.mark.parametrize("stream", [False, True], ids=["blocking", "sse"])
def test_disaggregation_parity_through_router(llama, stream):
    """A generate through the Router over a prefill and a decode replica
    (the K/V crosses HTTP) gives the JAX greedy tokens; the handoff bytes
    counter moves."""
    jnet, tnet = llama
    pre_srv, _, pre_url = _serve(tnet, f"lm@pre-{stream}", role="prefill")
    dec_srv, dec, dec_url = _serve(tnet, f"lm@dec-{stream}", role="decode")
    try:
        router = Router([(pre_url, "prefill"), (dec_url, "decode")],
                        poll_s=999)
        assert router._disaggregated()
        prompt = np.random.RandomState(32).randint(1, VOCAB, 9).tolist()
        before = _counter("mxnet_tpu_fleet_handoff_bytes_total", model="lm")
        payload = {"prompt": prompt, "max_new_tokens": 6}
        if stream:
            code, events = router.route_generate_stream("lm", payload)
            assert code == 200
            toks = _tokens(list(events))
        else:
            code, body = router.route_generate("lm", payload)
            assert code == 200
            toks = body["tokens"]
        _check(jnet, prompt, toks, 6)
        assert _counter("mxnet_tpu_fleet_handoff_bytes_total",
                        model="lm") == before + 2 * 4 * 2 * 9 * 64
        assert {sig[0][0][0][1]
                for sig in dec.cache_stats["signatures"]} == {1}
    finally:
        pre_srv.stop(timeout=10)
        dec_srv.stop(timeout=10)


def test_prefill_handoff_fault_falls_back_to_single_hop(llama, replicas):
    """A failed handoff leg (the ``prefill_handoff`` site) falls back to
    one mixed hop instead of failing the request."""
    jnet, tnet = llama
    pre_srv, _, pre_url = _serve(tnet, "lm@pre-fault", role="prefill")
    dec_srv, _, dec_url = _serve(tnet, "lm@dec-fault", role="decode")
    _, mixed, mixed_url = replicas[0]
    try:
        router = Router([(pre_url, "prefill"), (dec_url, "decode"),
                         (mixed_url, "mixed")], poll_s=999)
        prompt = np.random.RandomState(33).randint(1, VOCAB, 7).tolist()
        with FaultPlan({"prefill_handoff": ["fatal"]}) as plan:
            code, body = router.route_generate(
                "lm", {"prompt": prompt, "max_new_tokens": 4})
        assert plan.triggered == [("prefill_handoff", "fatal")]
        assert code == 200
        _check(jnet, prompt, body["tokens"], 4)
    finally:
        pre_srv.stop(timeout=10)
        dec_srv.stop(timeout=10)


def test_export_request_resume_parity_scheduler_level(llama):
    """export_request mid-flight (a read: the request goes on), re-admit
    the snapshot on another scheduler through ext_kv: the stitched tokens
    are the JAX greedy tokens; /export answers the same snapshot."""
    jnet, tnet = llama
    sched = _lm(tnet, "export-src")
    prompt = np.random.RandomState(64).randint(1, VOCAB, 6).tolist()
    sched.submit(prompt, max_new_tokens=8, rid="x1")
    for _ in range(3):
        sched.step()
    snap = sched.export_request("x1")
    assert snap["rid"] == "x1" and snap["prompt"] == prompt
    assert snap["sampling"] == "greedy" and snap["max_new_tokens"] == 8
    gen = snap["generated"]
    assert 1 <= len(gen) < 8 and snap["page_tokens"] == PAGE
    assert len(snap["hashes"]) >= 1
    assert snap["k"].shape == (2, len(prompt) + len(gen) - 1, 64)
    with pytest.raises(MXNetError):
        sched.export_request("no-such-rid")
    srv = ModelServer()
    srv.register_generation("lm", None, scheduler=sched, warmup=False)
    try:
        code, body = srv.handle_export("lm", {"rid": "x1"})
        assert code == 200 and body["generated"][:len(gen)] == gen
        assert srv.handle_export("lm", {})[0] == 400
        assert srv.handle_export("lm", {"rid": "nope"})[0] == 404
        assert srv.handle_export("nope", {"rid": "x1"})[0] == 404
        assert sched.cancel("x1") is True
    finally:
        srv.stop(timeout=10)
    dec = _lm(tnet, "export-dst")
    fut = dec.submit(prompt + gen[:-1], max_new_tokens=8 - len(gen) + 1,
                     ext_kv={"k": snap["k"], "v": snap["v"],
                             "first_token": gen[-1]})
    dec.run()
    _check(jnet, prompt, gen[:-1] + fut.result(timeout=0), 8)


# ===========================================================================
# one POST through the Router = one causal trace
# ===========================================================================
def test_trace_propagates_router_to_replica_to_scheduler(replicas, tmp_path):
    _, _, url0 = replicas[0]
    router = Router([url0], poll_s=999)
    host, port = router.start_http("127.0.0.1", 0)
    out = tmp_path / "fleet-trace.json"
    profiler.set_config(filename=str(out))
    profiler.set_state("run")
    try:
        prompt = np.random.RandomState(41).randint(1, VOCAB, 6).tolist()
        assert len(Client(f"http://{host}:{port}").generate(
            "lm", prompt, max_new_tokens=4)) == 4
    finally:
        profiler.set_state("stop")
        router.stop()
    profiler.dump()
    evs = json.loads(out.read_text())["traceEvents"]
    spans = {e["args"]["span_id"]: e for e in evs
             if e.get("cat") == "span" and "span_id" in e.get("args", {})}
    by_name = {}
    for e in spans.values():
        by_name.setdefault(e["name"], []).append(e)
    root = next(e for e in by_name["fleet.route"]
                if e["args"]["model"] == "lm")
    assert root["args"]["parent_id"] is None
    assert root["args"]["status"] == 200
    trace_id = root["args"]["trace_id"]
    decode = next(e for e in by_name["serving.generation.decode"]
                  if e["args"]["trace_id"] == trace_id)
    chain, cur = [], decode
    while cur is not None:
        chain.append(cur["name"])
        assert cur["args"]["trace_id"] == trace_id
        pid = cur["args"]["parent_id"]
        cur = spans.get(pid) if pid is not None else None
    assert chain == ["serving.generation.decode", "http.generate",
                     "fleet.route"]
    prefill = next(e for e in by_name["serving.generation.prefill"]
                   if e["args"]["trace_id"] == trace_id)
    assert spans[prefill["args"]["parent_id"]]["name"] == "http.generate"
    assert spans[decode["args"]["parent_id"]]["tid"] != root["tid"]


# ===========================================================================
# satellites: cold start, role warmup, cancel
# ===========================================================================
def test_client_retries_through_replica_cold_start():
    port = free_port()
    srv = ModelServer()

    def bind_late():
        time.sleep(0.8)
        srv.start_http("127.0.0.1", port)

    t = threading.Thread(target=bind_late)
    t.start()
    try:
        with pytest.raises(Exception):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/ping",
                                   timeout=2)
        assert Client(f"http://127.0.0.1:{port}").ping()["status"] \
            == "SERVING"
    finally:
        t.join(30)
        srv.stop(timeout=10)


@pytest.mark.parametrize("role", ["prefill", "decode"])
def test_role_server_warms_its_family(llama, role):
    """A ModelServer of a role warms only that role's family at
    register_generation (the port's entries are the JAX package's, see
    tests/test_torch_generation_warmup.py), and its traffic adds none."""
    jnet, tnet = llama
    srv = ModelServer(role=role)
    sched = _lm(tnet, f"warm-{role}")
    srv.register_generation("lm", None, scheduler=sched, warmup=True,
                            warmup_prompt_len=16)
    try:
        sigs = sched.cache_stats["signatures"]
        batch = {sig[0][0][0][0] for sig in sigs}
        width = {sig[0][0][0][1] for sig in sigs}
        if role == "prefill":
            assert batch == {1} and min(width) > 1
            entries = sched.cache_stats["entries"]
            out = Client(srv).prefill("lm", [3, 1, 4, 1, 5, 9],
                                      max_new_tokens=4)
            assert set(out) == {"first_token", "hashes", "page_tokens", "kv"}
        else:
            assert batch == {sched.max_slots} and width == {1}
            entries = sched.cache_stats["entries"]
            pre = _lm(tnet, "warm-src")
            out = pre.prefill_only([3, 1, 4, 1, 5, 9], max_new_tokens=4)
            fut = srv._generators["lm"].submit(
                [3, 1, 4, 1, 5, 9], 4, None,
                ext_kv=decode_kv({"kv": encode_kv(out["k"], out["v"],
                                                  out["first_token"])}))
            _check(jnet, [3, 1, 4, 1, 5, 9], fut.result(timeout=60), 4)
        assert sched.cache_stats["entries"] == entries
    finally:
        srv.stop(timeout=10)


def test_cancel_mid_flight_frees_slot_and_pages(llama):
    jnet, tnet = llama
    sched = _lm(tnet, "cancel-sched")
    prompt = np.random.RandomState(61).randint(1, VOCAB, 6).tolist()
    stream = TokenStream(rid="c1")
    fut = sched.submit(prompt, max_new_tokens=30, stream=stream, rid="c1")
    sched.step()
    assert sched.stats_snapshot()["page_pool"]["active"] > 0
    before = _counter("mxnet_tpu_serving_cancelled_total",
                      model="cancel-sched")
    assert sched.cancel("c1") is True
    assert sched.cancel("c1") is False and sched.cancel("never") is False
    with pytest.raises(RequestCancelledError):
        fut.result(timeout=10)
    with pytest.raises(RequestCancelledError):
        list(stream.events(timeout=10))
    assert sched.stats_snapshot()["page_pool"]["active"] == 0
    assert _counter("mxnet_tpu_serving_cancelled_total",
                    model="cancel-sched") == before + 1
    fut2 = sched.submit(prompt, max_new_tokens=4)
    sched.run()
    _check(jnet, prompt, fut2.result(timeout=0), 4)


def test_http_cancel_endpoint_mid_stream(llama):
    srv, sched, url = _serve(llama[1], "lm@cx", delay=0.05)
    try:
        req = urllib.request.Request(
            f"{url}/generate/lm", method="POST",
            data=json.dumps({"prompt": [1, 2, 3], "max_new_tokens": 40,
                             "stream": True, "rid": "kill-me"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert "token" in next_sse_event(resp)
            assert Client(url).cancel("lm", "kill-me") is True
            tail = []
            while True:
                ev = next_sse_event(resp)
                if ev is None:
                    break
                tail.append(ev)
        assert tail and tail[-1].get("type") == "RequestCancelledError"
        assert Client(url).cancel("lm", "kill-me") is False
        assert _wait(lambda: sched.stats_snapshot()["page_pool"]["active"]
                     == 0)
    finally:
        srv.stop(timeout=10)


def test_router_client_disconnect_cancels_upstream(llama):
    srv, sched, rurl = _serve(llama[1], "lm@disc", delay=0.05)
    router = Router([rurl], poll_s=999)
    host, port = router.start_http("127.0.0.1", 0)
    before = _counter("mxnet_tpu_fleet_cancelled_total", model="lm",
                      reason="client_disconnect")
    sbefore = _counter("mxnet_tpu_serving_cancelled_total", model="lm@disc")
    try:
        body = json.dumps({"prompt": [4, 5, 6], "max_new_tokens": 40,
                           "stream": True}).encode()
        s = socket.create_connection((host, port), timeout=30)
        s.sendall(f"POST /generate/lm HTTP/1.1\r\nHost: {host}\r\n"
                  "Content-Type: application/json\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        buf = b""
        while b"data:" not in buf:
            chunk = s.recv(4096)
            assert chunk, f"stream closed early: {buf!r}"
            buf += chunk
        s.close()
        assert _wait(lambda: (
            _counter("mxnet_tpu_fleet_cancelled_total", model="lm",
                     reason="client_disconnect") > before
            and _counter("mxnet_tpu_serving_cancelled_total",
                         model="lm@disc") > sbefore
            and sched.stats_snapshot()["page_pool"]["active"] == 0))
        assert router.cancelled >= 1
    finally:
        router.stop()
        srv.stop(timeout=10)


# ===========================================================================
# self-healing: migration, rolling restart, hedging, damping, supervisor
# ===========================================================================
@pytest.mark.parametrize("how", ["stop", "snapshot", "relay_fault"])
def test_migration_mid_stream_token_identical(llama, how):
    """The serving replica is lost after tokens were delivered: ``stop``
    drains it (journal only: the survivor re-prefills prompt + known
    tokens), ``snapshot`` drains it after cadenced /export snapshots (the
    survivor attaches the K/V: width-1 signatures only), ``relay_fault``
    loses the relay leg by a transient ``relay`` fault.  The client's
    stream holds the JAX greedy tokens with no gap, no duplicate and no
    error event."""
    jnet, tnet = llama
    reps = [_serve(tnet, f"lm@mig-{how}{i}", delay=0.05 if i == 0 else 0.0)
            for i in range(2)]
    router = Router([url for _, _, url in reps], poll_s=999,
                    snapshot_tokens=2 if how == "snapshot" else 0)
    router.replicas[1].in_flight = 1   # replica 0 serves first
    snaps = []
    if how == "snapshot":
        orig = router._snapshot_now

        def spy(job):
            ok = orig(job)
            if ok:
                snaps.append(job.snapshot)
            return ok
        router._snapshot_now = spy
    before = _counter("mxnet_tpu_fleet_migrations_total", model="lm",
                      outcome="ok")
    plan = FaultPlan({"relay": ["ok*3", "unavailable"]}) \
        if how == "relay_fault" else None
    try:
        if plan is not None:
            plan.__enter__()
        prompt = np.random.RandomState(62).randint(1, VOCAB, 5).tolist()
        code, events = router.route_generate_stream(
            "lm", {"prompt": prompt, "max_new_tokens": 30})
        assert code == 200
        it = iter(events)
        got = []
        while len(got) < 5:
            ev = next(it)
            assert "error" not in ev, ev
            if "token" in ev:
                got.append(ev["token"])
        stopper = None
        if how != "relay_fault":
            if how == "snapshot":
                assert snaps and snaps[-1].get("kv") \
                    and snaps[-1].get("generated")
            stopper = threading.Thread(target=reps[0][0].stop,
                                       kwargs={"timeout": 30})
            stopper.start()
        tail = list(it)
        if stopper is not None:
            stopper.join(60)
        assert not any("error" in e for e in tail), tail[-3:]
        got += [e["token"] for e in tail if "token" in e]
        assert tail[-1] == {"done": True, "tokens": got}
        _check(jnet, prompt, got, 30)
        assert router.migrations >= 1
        assert _counter("mxnet_tpu_fleet_migrations_total", model="lm",
                        outcome="ok") > before
        if how == "relay_fault":
            assert plan.triggered[-1] == ("relay", "unavailable")
        else:
            assert router.replicas[0].status == "DEAD"
        if how == "snapshot":
            assert {sig[0][0][0][1] for sig in
                    reps[1][1].cache_stats["signatures"]} == {1}
    finally:
        if plan is not None:
            plan.__exit__(None, None, None)
        router.stop()
        for srv, _, _ in reps:
            srv.stop(timeout=10)


def test_rolling_restart_zero_drop_under_load(llama):
    """rolling_restart cordons, force-migrates and restarts one replica at
    a time while streams are live: every stream holds the JAX greedy
    tokens with no error, and both replicas come back SERVING."""
    jnet, tnet = llama
    servers, urls, incarnation = {}, [], [0]
    for i in range(2):
        srv, _, url = _serve(tnet, f"lm@rr{i}", delay=0.08)
        servers[url] = srv
        urls.append(url)
    router = Router(urls, poll_s=999)

    def restart_fn(i, rep):
        servers[rep.url].stop(timeout=30)
        incarnation[0] += 1
        port = int(rep.url.rsplit(":", 1)[1])
        srv, _, _ = _serve(tnet, f"lm@rr{i}.{incarnation[0]}", delay=0.08,
                           port=port)
        servers[rep.url] = srv

    rng = np.random.RandomState(65)
    prompts = [rng.randint(1, VOCAB, 4).tolist() for _ in range(3)]
    results = [None] * len(prompts)

    def run(k):
        code, events = router.route_generate_stream(
            "lm", {"prompt": prompts[k], "max_new_tokens": 40})
        assert code == 200
        results[k] = list(events)

    threads = [threading.Thread(target=run, args=(k,))
               for k in range(len(prompts))]
    try:
        for t in threads:
            t.start()
        assert _wait(lambda: len(router._jobs) >= 2, 120)
        report = router.rolling_restart(restart_fn, ready_timeout=60,
                                        drain_timeout=30, evac_timeout=30)
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        for k, evs in enumerate(results):
            _check(jnet, prompts[k], _tokens(evs), 40)
        assert len(report) == 2
        assert sum(r["migrated_streams"] for r in report) >= 1
        for url in urls:
            assert json.loads(urllib.request.urlopen(
                f"{url}/ping", timeout=10).read())["status"] == "SERVING"
        assert not any(r.cordoned for r in router.replicas)
    finally:
        router.stop()
        for srv in servers.values():
            srv.stop(timeout=10)


def test_hedged_request_first_token_wins(llama):
    """The committed replica's first token misses the p99-derived
    threshold: a hedge on the next-best replica wins the stream (the JAX
    greedy tokens) and the loser is cancelled upstream, its pages freed."""
    jnet, tnet = llama
    slow_srv, slow, slow_url = _serve(tnet, "lm@hslow", delay=1.0)
    fast_srv, fast, fast_url = _serve(tnet, "lm@hfast")
    router = Router([slow_url, fast_url], poll_s=999, hedge_pctl=99)
    router._ft_samples["lm"] = deque([0.01] * 32, maxlen=512)
    router.replicas[1].in_flight = 5   # the slow replica is the primary
    won = _counter("mxnet_tpu_fleet_hedges_total", model="lm",
                   outcome="won")
    cx = _counter("mxnet_tpu_serving_cancelled_total", model="lm@hslow")
    try:
        prompt = np.random.RandomState(66).randint(1, VOCAB, 5).tolist()
        code, events = router.route_generate_stream(
            "lm", {"prompt": prompt, "max_new_tokens": 6})
        assert code == 200
        _check(jnet, prompt, _tokens(list(events)), 6)
        assert router.hedges_won == 1
        assert _counter("mxnet_tpu_fleet_hedges_total", model="lm",
                        outcome="won") == won + 1
        assert fast.admitted >= 1
        assert _wait(lambda: _counter("mxnet_tpu_serving_cancelled_total",
                                      model="lm@hslow") > cx
                     and slow.stats_snapshot()["page_pool"]["active"] == 0)
    finally:
        router.stop()
        slow_srv.stop(timeout=10)
        fast_srv.stop(timeout=10)


def test_poller_damping_and_wedged_poll_does_not_block():
    import http.server
    delay = [0.0]

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            time.sleep(delay[0])
            body = json.dumps({"status": "SERVING", "in_flight": 0,
                               "models": {}}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        router = Router([url], poll_s=0.5, dead_after=2)
        rep = router.replicas[0]
        assert rep.alive and rep.status == "SERVING"
        delay[0] = 10.0
        t0 = time.monotonic()
        router.refresh()
        assert time.monotonic() - t0 < 5.0
        assert rep.alive and rep.status == "SERVING"
        assert rep.poll_failures == 1 and rep.admittable()
        router.refresh()
        assert rep.status == "DEAD" and not rep.alive
        delay[0] = 0.0
        router.refresh()
        assert rep.alive and rep.status == "SERVING"
        assert rep.poll_failures == 0
    finally:
        httpd.shutdown()


_CRASH_CHILD = r'''
import http.server, json, os, sys
port, state, fails = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
n = int(open(state).read()) if os.path.exists(state) else 0
open(state, "w").write(str(n + 1))
if n < fails:
    sys.exit(1)
class H(http.server.BaseHTTPRequestHandler):
    def do_GET(self):
        body = json.dumps({"status": "SERVING", "in_flight": 0,
                           "models": {}}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
    def log_message(self, *a):
        pass
http.server.HTTPServer(("127.0.0.1", port), H).serve_forever()
'''


def test_supervisor_respawns_crash_looping_replica(tmp_path):
    """The supervisor respawns a crash-looping replica on the same port
    with monotone backoff between respawns, and converges once it boots
    (a stdlib child that exits at once for its first 3 boots)."""
    state = str(tmp_path / "boots")
    rm = ReplicaManager(lambda role, port: [sys.executable, "-c",
                                            _CRASH_CHILD, str(port), state,
                                            "3"],
                        ["mixed"], ready_timeout=60)
    rm.start(wait_ready=False)
    rm.start_supervisor(poll_s=0.1, dead_after=2, base_backoff=0.05,
                        max_backoff=0.4, stable_s=30)
    try:
        port0 = rm.replicas[0].port

        def serving():
            try:
                with urllib.request.urlopen(rm.replicas[0].url + "/ping",
                                            timeout=2) as r:
                    return json.loads(r.read()).get("status") == "SERVING"
            except Exception:  # noqa: BLE001 - still crash-looping
                return False
        assert _wait(serving, 60)
        stats = rm.supervisor_stats()
        assert stats["running"] and stats["restarts"] >= 3
        assert rm.replicas[0].port == port0
        backoffs = [e["backoff_s"] for e in stats["recent"]]
        assert backoffs == sorted(backoffs)
        assert backoffs[0] == 0.0 and backoffs[-1] > 0.0, backoffs
        assert [e["respawn"] for e in stats["recent"][:3]] == [1, 2, 3]
        assert _counter("mxnet_tpu_fleet_restarts_total", role="mixed") >= 3
    finally:
        rm.stop()
    assert rm.supervisor_stats()["running"] is False
