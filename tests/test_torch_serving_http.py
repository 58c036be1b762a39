"""Port parity: the HTTP serving surface of ``mxnet_tpu_torch.serving``
(``ModelServer.handle_*``, ``start_http``, the socket ``Client`` with its
``RetryPolicy``, SSE, the per-model breaker, ``/ping``, ``/metrics``)
against the JAX package's, on the CPU.

Both packages serve the same models from the same weights: a BERT of 2
layers, 64 units and seq 16 (weights through ``save_parameters``), a
two-layer MLP for the breaker and queue scripts, and a Llama of 2 layers
and 64 units (through ``convert.llama_state_dict_from_mxnet``).  The same
scripted payloads go through ``handle_predict`` / ``handle_generate`` and
over real sockets: statuses and JSON keys must be equal, predict outputs
within 1e-5 relative (fp32; JSON carries fp32 exactly, so the socket
answer equals the in-process one bit for bit), generated tokens and SSE
token sequences equal, ``/ping`` the same state sequence under the same
fault plan, and ``/metrics`` the same serving family names.
"""
import json
import re
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import resilience as jres
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo.language import bert as jbert
from mxnet_tpu.gluon.model_zoo.language import llama_tiny as jax_llama_tiny
from mxnet_tpu.serving.server import Client as JClient, ModelServer as JServer

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon, resilience as tres
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import llama_state_dict_from_mxnet
from mxnet_tpu_torch.gluon.model_zoo.language import bert as tbert
from mxnet_tpu_torch.gluon.model_zoo.language import llama_tiny
from mxnet_tpu_torch.serving import server as tserver
from mxnet_tpu_torch.serving.server import Client as TClient, \
    ModelServer as TServer

REL = 1e-5
SEQ = 16
BERT_CFG = dict(vocab_size=60, units=64, hidden_size=128, num_layers=2,
                num_heads=4, max_length=SEQ, dropout=0.1)
SPEC = [((4,), "float32")]
PKG = {"jax": (JServer, JClient, jres), "torch": (TServer, TClient, tres)}


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tmx.set_default_context(tmx.cpu())
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    tmx.set_default_context(prev)


def _close(got, ref, rel=REL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max() + 1e-6


def _mlps(seed):
    jmx.random.seed(seed)
    jnet = jnn.Sequential()
    jnet.add(jnn.Dense(8), jnn.Dense(3))
    jnet.initialize()
    jnet(jmx.nd.array(np.zeros((8, 4), dtype="float32")))
    tnet = gluon.nn.HybridSequential()
    with tnet.name_scope():
        tnet.add(gluon.nn.Dense(8, in_units=4), gluon.nn.Dense(3, in_units=8))
    tnet.initialize()
    for jp, tp in zip(jnet.collect_params().values(),
                      tnet.collect_params().values()):
        tp.set_data(tmx.nd.array(jp.data().asnumpy()))
    return {"jax": jnet, "torch": tnet}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    prev = tmx.set_default_context(tmx.cpu())
    try:
        tmp = tmp_path_factory.mktemp("bert")
        jmx.random.seed(0)
        jbnet = jbert.BERTModel(prefix="bert_", **BERT_CFG)
        jbnet.collect_params().initialize(jmx.init.Normal(0.02))
        jbnet.save_parameters(str(tmp / "bert.params"))
        tbnet = tbert.BERTModel(prefix="bert_", device="cpu", **BERT_CFG)
        tbnet.load_parameters(str(tmp / "bert.params"))
        jmx.random.seed(1)
        jlm = jax_llama_tiny(vocab_size=64, max_length=64)
        jlm.collect_params().initialize()
        tlm = llama_tiny(vocab_size=64, max_length=64, device="cpu")
        llama_state_dict_from_mxnet(
            {k: p.data().asnumpy() for k, p in
             jlm.collect_params().items()}, tlm)
    finally:
        tmx.set_default_context(prev)
    return {"jax": (jbnet, jlm), "torch": (tbnet, tlm)}


@pytest.fixture(scope="module")
def servers(models):
    """One server per package: ``bert`` (ladder 1/2/4/8), ``lm`` (the
    paged engine), ``lm_dense`` (the dense engine), ``q`` (a queue of 0:
    every submission is shed); each listening on a free port."""
    prev = tmx.set_default_context(tmx.cpu())
    out = {}
    try:
        for k, (Server, Client, _) in PKG.items():
            bert, lm = models[k]
            srv = Server()
            srv.register("bert", bert, max_batch=8, max_wait_us=2000,
                         input_spec=[((SEQ,), "int32")])
            srv.register("q", _mlps(5)[k], input_spec=SPEC, max_queue=0)
            srv.register_generation("lm", lm, max_slots=2, page_tokens=4,
                                    warmup=False)
            srv.register_generation("lm_dense", lm, max_slots=2,
                                    kv_cache=False, warmup=False)
            port = srv.start_http(port=0)
            out[k] = (srv, f"http://127.0.0.1:{port}")
    finally:
        tmx.set_default_context(prev)
    yield out
    for srv, _ in out.values():
        srv.stop()


def _rows(seed, n):
    return np.random.RandomState(seed).randint(0, 60, (n, SEQ)).astype(
        np.int32)


# ------------------------------------------------------------ the taxonomy
def _scripted(srv, res, kind):
    """One scripted (status, body) exchange through the handler methods."""
    x = _rows(3, 2).tolist()
    if kind == "ok":
        return srv.handle_predict("bert", {"inputs": [x]})
    if kind == "data_key":
        return srv.handle_predict("bert", {"data": x})
    if kind == "unknown":
        return srv.handle_predict("nope", {"inputs": [x]})
    if kind == "bad_shape":
        return srv.handle_predict("bert", {"inputs": [[[1, 2, 3]]]})
    if kind == "ragged":
        return srv.handle_predict("bert", {"inputs": [[[1, 2], [3]]]})
    if kind == "no_inputs":
        return srv.handle_predict("bert", {"rows": x})
    if kind == "queue_full":
        return srv.handle_predict("q", {"inputs": [[[0.0] * 4]]})
    if kind == "deadline":
        return srv.handle_predict("bert", {"inputs": [x]}, deadline_ms=1e-3)
    if kind == "http_fatal":
        with res.FaultPlan({"http": ["fatal"]}):
            return srv.handle_predict("bert", {"inputs": [x]})
    if kind == "http_transient":
        with res.FaultPlan({"http": ["unavailable"]}):
            return srv.handle_predict("bert", {"inputs": [x]})
    if kind == "gen_ok":
        return srv.handle_generate("lm", {"prompt": [1, 2, 3],
                                          "max_new_tokens": 3})
    if kind == "gen_unknown":
        return srv.handle_generate("nope", {"prompt": [1]})
    if kind == "gen_bad":
        return srv.handle_generate("lm", {"max_new_tokens": 3})
    if kind == "gen_too_long":
        return srv.handle_generate("lm", {"prompt": [1] * 60,
                                          "max_new_tokens": 10})
    if kind == "gen_fault":
        with res.FaultPlan({"replica_exec": ["fatal"]}):
            return srv.handle_generate("lm", {"prompt": [1]})
    if kind == "cancel_missing":
        return srv.handle_cancel("lm", {})
    if kind == "cancel_unknown_rid":
        return srv.handle_cancel("lm", {"rid": "gone"})
    if kind == "cancel_unknown_model":
        return srv.handle_cancel("nope", {"rid": "x"})
    raise AssertionError(kind)


KINDS = {"ok": 200, "data_key": 200, "unknown": 404, "bad_shape": 400,
         "ragged": 400, "no_inputs": 400, "queue_full": 503,
         "deadline": 504, "http_fatal": 500, "http_transient": 503,
         "gen_ok": 200, "gen_unknown": 404, "gen_bad": 400,
         "gen_too_long": 400, "gen_fault": 500, "cancel_missing": 400,
         "cancel_unknown_rid": 200, "cancel_unknown_model": 404}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_statuses_and_json_keys_match(servers, kind):
    got = {}
    for k, (srv, _) in servers.items():
        code, body = _scripted(srv, PKG[k][2], kind)
        got[k] = (code, sorted(body))
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == KINDS[kind]
    if got["torch"][0] == 503:
        assert "retry_after_s" in got["torch"][1]


def test_predict_outputs_agree_and_socket_equals_in_process(servers):
    x = _rows(7, 3)
    out = {}
    for k, (srv, url) in servers.items():
        client = PKG[k][1](url)
        over_socket = client.predict("bert", [x.tolist()])
        in_process = srv.predict("bert", x)
        code, body = srv.handle_predict("bert", {"inputs": [x.tolist()]})
        assert code == 200 and len(body["outputs"]) == 2
        out[k] = (over_socket, [o.asnumpy() for o in in_process])
    for k, (sock, proc) in out.items():
        # the same rung's entry, and JSON carries fp32 exactly
        for s, p in zip(sock, proc):
            assert np.array_equal(np.asarray(s, np.float32), p), k
    for t, j in zip(out["torch"][0], out["jax"][0]):
        _close(t, j)
    assert np.asarray(out["torch"][0][0]).shape == (3, SEQ, 64)


def test_concurrent_socket_requests_agree(servers):
    reqs = [_rows(20 + i, 1 + i % 3) for i in range(8)]
    out = {}
    for k, (srv, url) in servers.items():
        client = PKG[k][1](url)
        answers = [None] * len(reqs)
        gate = threading.Barrier(len(reqs))

        def call(i, client=client, answers=answers, gate=gate):
            gate.wait()
            answers[i] = client.predict("bert", [reqs[i].tolist()])
        ts = [threading.Thread(target=call, args=(i,))
              for i in range(len(reqs))]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        out[k] = answers
    for i, (t, j) in enumerate(zip(out["torch"], out["jax"])):
        for a, b in zip(t, j):
            _close(a, b)
        solo = servers["torch"][0].predict("bert", reqs[i])
        _close(t[0], solo[0].asnumpy())


@pytest.mark.parametrize("model", ["lm", "lm_dense"])
def test_generate_and_sse_tokens_equal(servers, model):
    prompts = [[1, 2, 3], [5, 9, 11, 13, 17, 19], [7]]
    out = {}
    for k, (srv, url) in servers.items():
        client = PKG[k][1](url)
        plain = [client.generate(model, p, max_new_tokens=6)
                 for p in prompts]
        streamed = [list(client.generate_stream(model, p, max_new_tokens=6))
                    for p in prompts]
        in_proc = [srv.generate(model, p, max_new_tokens=6) for p in prompts]
        out[k] = (plain, streamed, in_proc)
    assert out["torch"] == out["jax"]
    plain, streamed, in_proc = out["torch"]
    assert plain == streamed == in_proc
    assert all(len(t) == 6 for t in plain)


def test_sse_wire_events_match(servers):
    """The raw SSE body: one ``data:`` event per token, then the done
    event carrying all tokens."""
    out = {}
    for k, (_, url) in servers.items():
        req = urllib.request.Request(
            f"{url}/generate/lm", method="POST",
            data=json.dumps({"prompt": [4, 5], "max_new_tokens": 4,
                             "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            ctype = resp.headers["Content-Type"]
            body = resp.read().decode()
        events = [json.loads(line[5:]) for line in body.splitlines()
                  if line.startswith("data:")]
        out[k] = (ctype, events)
    assert out["torch"] == out["jax"]
    ctype, events = out["torch"]
    assert ctype == "text/event-stream" and events[-1]["done"]
    assert [e["token"] for e in events[:-1]] == events[-1]["tokens"]


def test_sse_error_event_and_stream_errors_match(servers):
    """A request the scheduler rejects after acceptance ends its stream
    with a typed error event; both clients raise the same type."""
    out = {}
    for k, (_, url) in servers.items():
        client = PKG[k][1](url)
        with pytest.raises(Exception) as ei:
            list(client.generate_stream("lm", [1] * 60, max_new_tokens=10))
        out[k] = type(ei.value).__name__
    assert out["torch"] == out["jax"]


def _drop_after_first_token(url, model, prompt, max_new):
    """Open an SSE stream on a raw socket, read one token event, then
    reset the connection."""
    host, port = url[len("http://"):].split(":")
    body = json.dumps({"prompt": prompt, "max_new_tokens": max_new,
                       "stream": True}).encode()
    s = socket.create_connection((host, int(port)), timeout=60)
    s.sendall(b"POST /generate/" + model.encode() + b" HTTP/1.1\r\n"
              b"Host: x\r\nContent-Type: application/json\r\n"
              b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n"
              + body)
    buf = b""
    while b"data:" not in buf or not buf.split(b"data:", 1)[1].count(b"\n"):
        chunk = s.recv(4096)
        assert chunk, "server closed before the first event"
        buf += chunk
    s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                 b"\x01\x00\x00\x00\x00\x00\x00\x00")
    s.close()
    return json.loads(buf.split(b"data:", 1)[1].split(b"\n", 1)[0])


def test_dropped_sse_connection_cancels_its_request(servers):
    out = {}
    for k, (srv, url) in servers.items():
        sched = srv._generators["lm_dense"].scheduler
        before = sched.cancelled
        first = _drop_after_first_token(url, "lm_dense", [3, 1, 4], 58)
        deadline = time.monotonic() + 120
        while sched.cancelled == before and time.monotonic() < deadline:
            time.sleep(0.01)
        while (sched._pending or any(s is not None for s in sched._slots)) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        out[k] = (sched.cancelled - before, "token" in first,
                  sum(s is not None for s in sched._slots))
    assert out["torch"] == out["jax"] == (1, True, 0)


def test_cancel_over_the_socket_matches(servers):
    """A live request cancelled by rid: the blocked generate answers 409,
    the cancel answers {"cancelled": true}, a second cancel false."""
    out = {}
    for k, (srv, url) in servers.items():
        client = PKG[k][1](url)
        sched = srv._generators["lm_dense"].scheduler
        res = {}

        def gen(client=client, res=res):
            try:
                res["tokens"] = client.generate("lm_dense", [2, 7, 1],
                                                max_new_tokens=58)
            except Exception as e:  # noqa: BLE001 - the outcome
                res["error"] = str(e)[:8]
        with sched._lock:   # the request is queued, not yet admitted
            t = threading.Thread(target=gen)
            t.start()
            deadline = time.monotonic() + 60
            while not sched._rids and time.monotonic() < deadline:
                sched._lock.release()
                time.sleep(0.005)
                sched._lock.acquire()
            rid = next(iter(sched._rids))
        first = client.cancel("lm_dense", rid)
        t.join(120)
        out[k] = (first, client.cancel("lm_dense", rid), res)
    assert out["torch"] == out["jax"]
    assert out["torch"][:2] == (True, False)
    assert out["torch"][2] == {"error": "HTTP 409"}


# ------------------------------------------------------- routes and client
def _get(url, path, accept=None):
    req = urllib.request.Request(url + path,
                                 headers={"Accept": accept} if accept else {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers["Content-Type"], r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read().decode()


def test_get_routes_match(servers):
    out = {}
    for k, (_, url) in servers.items():
        rows = {}
        for path in ("/ping", "/stats", "/stats/bert", "/stats/nope",
                     "/goodput", "/nowhere"):
            code, ctype, body = _get(url, path)
            payload = json.loads(body)
            rows[path] = (code, ctype, sorted(payload)
                          if path in ("/ping", "/goodput", "/stats/nope",
                                      "/nowhere") else None)
        stats = json.loads(_get(url, "/stats/bert")[2])
        out[k] = (rows, sorted(set(stats) - {"batch_stage_ms_mean",
                                             "batch_stage_ms_max",
                                             "queue_depth"}))
    assert out["torch"] == out["jax"]
    code, _, body = _get(servers["torch"][1], "/stats/bert")
    assert {"batch_stage_ms_mean", "batch_stage_ms_max",
            "queue_depth", "p99_exemplar"} <= set(json.loads(body))


def _family_names(text, prefix="mxnet_tpu_serving_"):
    return sorted({m.group(1) for m in re.finditer(
        r"^# TYPE (\S+) \S+$", text, re.M) if m.group(1).startswith(prefix)})


def test_metrics_negotiation_and_serving_families_match(servers):
    out = {}
    for k, (_, url) in servers.items():
        code, ctype, plain = _get(url, "/metrics")
        code2, ctype2, om = _get(url, "/metrics",
                                 accept="application/openmetrics-text")
        out[k] = (code, ctype, code2, ctype2, " # {" in plain,
                  om.endswith("# EOF\n"), _family_names(plain),
                  _family_names(om))
    assert out["torch"] == out["jax"]
    assert "mxnet_tpu_serving_request_latency_seconds" in out["torch"][6]
    # the OpenMetrics dialect names counter families without _total
    assert "mxnet_tpu_serving_requests" in out["torch"][7]


def test_post_routes_and_fleet_routes(servers):
    """Malformed bodies and unknown routes answer alike; so do the fleet
    routes (``/fleet/state``, ``/prefill``, ``/export``, a ``"kv"``
    handoff): the same statuses and JSON keys in both packages."""
    out = {}
    for k, (_, url) in servers.items():
        rows = []
        for path, body in (("/predict/bert", b"[1, 2]"),
                           ("/predict/bert", b"{not json"),
                           ("/nowhere", b"{}")):
            req = urllib.request.Request(url + path, data=body,
                                         method="POST")
            try:
                urllib.request.urlopen(req, timeout=60)
                rows.append(200)
            except urllib.error.HTTPError as e:
                rows.append(e.code)
        out[k] = rows
    assert out["torch"] == out["jax"] == [400, 400, 404]
    fleet = {}
    for k, (srv, url) in servers.items():
        rows = []
        for path, data in (("/fleet/state", None),
                           ("/prefill/lm", b"{}"),
                           ("/prefill/lm", b'{"prompt": [1, 2, 3, 4, 5]}'),
                           ("/prefill/lm_dense", b'{"prompt": [1, 2]}'),
                           ("/prefill/nope", b'{"prompt": [1]}'),
                           ("/export/lm", b'{"rid": "x"}'),
                           ("/export/lm", b"{}")):
            req = urllib.request.Request(url + path, data=data,
                                         method="POST" if data else "GET")
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    rows.append((r.status, sorted(json.loads(r.read()))))
            except urllib.error.HTTPError as e:
                rows.append((e.code, sorted(json.loads(e.read()))))
        for payload in ({"prompt": [1], "kv": {"k": 1}},
                        {"prompt": [1, 2], "kv": {
                            "shape": [2, 2, 64], "k": "", "v": "",
                            "first_token": 1}}):
            code, body = srv.handle_generate("lm", payload)
            rows.append((code, sorted(body)))
        fleet[k] = rows
    assert fleet["torch"] == fleet["jax"]
    assert [r[0] for r in fleet["torch"]] == [200, 400, 200, 400, 404, 404,
                                              400, 400, 400]
    srv, url = servers["torch"]
    assert srv.fleet_state()["models"]["lm"]["engine"] == "paged"
    k = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    wire = tserver.encode_kv(k, -k, 5)
    got = tserver.decode_kv({"kv": wire})
    assert got["first_token"] == 5 and np.array_equal(got["v"], -k)
    assert tserver.decode_kv({}) is None
    assert TServer(role="prefill").role == "prefill"
    with pytest.raises(MXNetError):
        TServer(role="both")
    out = TClient(url).prefill("lm", [1, 2, 3, 4, 5], max_new_tokens=2)
    assert sorted(out) == ["first_token", "hashes", "kv", "page_tokens"]
    assert out["kv"]["shape"] == [2, 5, 64]


def test_client_retries_503_and_connection_refused():
    """The socket Client's RetryPolicy: connection refused retries and
    then raises; a 503 maps to OverloadedError and retries."""
    out = {}
    for k, (_, Client, res) in PKG.items():
        sleeps = []
        free = socket.socket()
        free.bind(("127.0.0.1", 0))
        port = free.getsockname()[1]
        free.close()
        client = Client(f"http://127.0.0.1:{port}", retry=res.RetryPolicy(
            max_attempts=3, base_delay=0.01, sleep=sleeps.append,
            retryable=Client._retryable, rng_seed=0))
        with pytest.raises(Exception) as ei:
            client.ping()
        out[k] = (len(sleeps), Client._retryable(ei.value),
                  Client._retryable(res.OverloadedError("x")),
                  Client._retryable(ValueError("x")))
    assert out["torch"] == out["jax"] == (2, True, True, False)


def test_trace_headers_round_trip():
    from mxnet_tpu_torch.observability import tracing
    assert tserver.trace_headers() == {}
    with tracing.span("http.predict") as sp:
        h = tserver.trace_headers()
    ctx = tserver.parent_from_headers(h)
    assert (ctx.trace_id, ctx.span_id) == (sp.trace_id, sp.span_id)
    assert tserver.parent_from_headers({tserver.TRACE_HEADER: "x",
                                        tserver.PARENT_HEADER: "1"}) is None


# ---------------------------------------------- breaker, ping and draining
def test_ping_sequence_under_the_same_fault_plan():
    """SERVING -> DEGRADED (the execute site fails once: 500, the model's
    breaker opens; predict then sheds 503) -> DEGRADED while half-open ->
    SERVING (a probe succeeds) -> DRAINING (503 with in_flight while a
    queued request drains); the shed request's body carries
    retry_after_s, and every accepted request is answered."""
    nets = _mlps(9)
    x = [[0.5, -1.0, 2.0, 0.25]]
    out = {}
    for k, (Server, _, res) in PKG.items():
        srv = Server()
        br = res.CircuitBreaker(failure_threshold=1, cooldown=0.4,
                                name="serving:m")
        srv.register("m", nets[k], input_spec=SPEC, max_wait_us=0,
                     breaker=br)
        url = f"http://127.0.0.1:{srv.start_http(port=0)}"
        seq = []

        def ping():
            code, _, body = _get(url, "/ping")
            seq.append((code, json.loads(body)))
        ping()
        with res.FaultPlan({"execute": ["fatal"]}):
            seq.append(srv.handle_predict("m", {"inputs": [x]})[0])
        ping()
        code, body = srv.handle_predict("m", {"inputs": [x]})
        seq.append((code, sorted(body)))
        time.sleep(0.5)
        ping()
        code, body = srv.handle_predict("m", {"inputs": [x]})
        seq.append(code)
        ping()
        # a drain in progress: the worker holds a request behind the
        # engine's lock, a second one queues
        eng = srv._models["m"].engine
        batcher = srv._models["m"].batcher
        eng._lock.acquire()
        futs = [srv.predict_async("m", np.asarray(x, np.float32))]
        while batcher.pending:      # the worker took it and waits
            time.sleep(0.005)
        time.sleep(0.05)
        futs.append(srv.predict_async("m", np.asarray(x, np.float32)))
        assert batcher.pending == 1
        stopper = threading.Thread(target=srv.stop)
        stopper.start()
        while srv.health() != "DRAINING":
            time.sleep(0.005)
        ping()
        eng._lock.release()
        stopper.join(60)
        answered = [f.result(timeout=60).shape for f in futs]
        out[k] = (seq, answered)
    assert out["torch"] == out["jax"]
    states = [s[1]["status"] for s in out["torch"][0] if isinstance(s, tuple)
              and isinstance(s[1], dict)]
    assert states == ["SERVING", "DEGRADED", "DEGRADED", "SERVING",
                      "DRAINING"]
    assert out["torch"][0][-1] == (503, {"status": "DRAINING",
                                         "in_flight": 1})
    assert out["torch"][0][3] == (503, ["error", "retry_after_s"])


def test_breaker_probe_failure_reopens_alike():
    nets = _mlps(10)
    x = {"inputs": [[[1.0, 2.0, 3.0, 4.0]]]}
    out = {}
    for k, (Server, _, res) in PKG.items():
        srv = Server()
        br = res.CircuitBreaker(failure_threshold=2, cooldown=0.2)
        srv.register("m", nets[k], input_spec=SPEC, breaker=br)
        codes = []
        with res.FaultPlan({"execute": ["fatal*3"]}):
            for _ in range(3):
                codes.append(srv.handle_predict("m", x)[0])
            time.sleep(0.25)
            codes.append(srv.handle_predict("m", x)[0])   # failed probe
            codes.append(srv.health())
        time.sleep(0.25)
        codes.append(srv.handle_predict("m", x)[0])
        codes.append(srv.health())
        stats = srv.stats("m")
        srv.stop()
        out[k] = (codes, br.open_events, stats["errors"], stats["sheds"])
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == [500, 500, 503, 500, "DEGRADED", 200,
                               "SERVING"]
