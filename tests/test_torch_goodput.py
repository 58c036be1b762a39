"""Port parity: the goodput ledger, tail retention and the memory ledger in
``mxnet_tpu_torch`` against the JAX package's, on the CPU.

Mirrors ``tests/test_goodput.py``'s serving gates (the served batch
reconciles and its p99 exemplar resolves, retention below the threshold,
generation's queue/execute/stream, the memory ledger's high water) with
both packages serving the same model on the same inputs: a two-layer MLP
with the JAX package's weights copied into the port's, and a Llama of 2
layers and 64 units through ``convert.llama_state_dict_from_mxnet``.
Predict outputs agree within 1e-5 relative (fp32), generated tokens are
equal, and each package's attribution reconciles: buckets + other ==
wall within 1e-9 s.
"""
import re

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo.language import llama_tiny as jax_llama_tiny
from mxnet_tpu.observability import (goodput as jgoodput, memory as jmemory,
                                     metrics as jmetrics, tracing as jtracing)
from mxnet_tpu.serving.server import ModelServer as JServer

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.convert import llama_state_dict_from_mxnet
from mxnet_tpu_torch.gluon.model_zoo.language import llama_tiny
from mxnet_tpu_torch.observability import (goodput as tgoodput,
                                           memory as tmemory,
                                           metrics as tmetrics,
                                           tracing as ttracing)
from mxnet_tpu_torch.serving import ModelServer as TServer

REL = 1e-5
SPEC = [((4,), "float32")]
PKG = {"jax": (JServer, jgoodput, jtracing, jmetrics, jmemory),
       "torch": (TServer, tgoodput, ttracing, tmetrics, tmemory)}


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)


def _nets(seed, n_out=3):
    """The JAX package's Dense(8) -> Dense(n_out) and the port's copy."""
    jmx.random.seed(seed)
    jnet = jnn.Sequential()
    jnet.add(jnn.Dense(8), jnn.Dense(n_out))
    jnet.initialize()
    jnet(jmx.nd.array(np.zeros((8, 4), dtype="float32")))
    tnet = gluon.nn.HybridSequential()
    with tnet.name_scope():
        tnet.add(gluon.nn.Dense(8, in_units=4),
                 gluon.nn.Dense(n_out, in_units=8))
    tnet.initialize()
    for jp, tp in zip(jnet.collect_params().values(),
                      tnet.collect_params().values()):
        tp.set_data(tmx.nd.array(jp.data().asnumpy()))
    return {"jax": jnet, "torch": tnet}


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= REL * np.abs(ref).max() + 1e-6


def _parse_latency_exemplars(text, model):
    """Exemplar trace ids on the request-latency histogram of ``model``,
    by bucket le."""
    out = {}
    pat = re.compile(
        r'^mxnet_tpu_serving_request_latency_seconds_bucket\{[^}]*'
        r'model="%s"[^}]*le="([^"]+)"\}\s+\d+\s+#\s+'
        r'\{trace_id="(\d+)"\}\s+(\S+)' % re.escape(model))
    for line in text.splitlines():
        m = pat.match(line)
        if m:
            out[m.group(1)] = (int(m.group(2)), float(m.group(3)))
    return out


def test_served_batch_reconciles_and_p99_exemplar_resolves(monkeypatch):
    """Both packages serve 12 requests; per request the buckets + other
    equal the wall; from /metrics' OpenMetrics text alone the tail
    exemplar resolves to a retained trace holding the batcher's execute
    span, exportable as a chrome trace; /stats names the same tail."""
    monkeypatch.setenv("MXNET_TPU_TRACE_RETAIN_PCT", "90")
    nets = _nets(0)
    x = np.random.RandomState(0).randn(2, 4).astype("float32")
    out = {}
    for k, (Server, gp, tr, _, _) in PKG.items():
        server = Server()
        server.register("gp", nets[k], max_batch=4, max_wait_us=500,
                        input_spec=SPEC)
        try:
            ys = [server.predict("gp", x).asnumpy() for _ in range(12)]
            rec = gp.serving().last_request
            assert rec["model"] == "gp"
            assert sum(rec["buckets"].values()) == pytest.approx(
                rec["wall_seconds"], abs=1e-9)
            assert " # {" not in server.metrics_text()
            exemplars = _parse_latency_exemplars(
                server.metrics_text(exemplars=True), "gp")
            assert exemplars
            top = max(exemplars, key=lambda le: float(le))
            tid, _ = exemplars[top]
            kept = tr.retained_trace(tid)
            assert kept is not None, (k, tid)
            doc = tr.export_chrome_trace(tid)
            assert doc["traceEvents"] and all(
                ev["args"]["trace_id"] == tid for ev in doc["traceEvents"])
            snap = server.stats("gp")
            assert snap["p99_exemplar"] is not None
            assert tr.retained_trace(
                snap["p99_exemplar"]["trace_id"]) is not None
            names = {s["name"] for s in kept["spans"]}
            out[k] = (ys, sorted(rec["buckets"]),
                      names >= {"serving.enqueue", "serving.batcher.pack",
                                "serving.batcher.execute",
                                "serving.batcher.split",
                                "serving.engine.predict"})
        finally:
            server.stop()
    for got, ref in zip(out["torch"][0], out["jax"][0]):
        _close(got, ref)
    assert out["torch"][1:] == out["jax"][1:]
    assert out["torch"][1] == ["execute", "other", "pack", "queue", "split"]
    assert out["torch"][2]


def test_retention_below_threshold_discards(monkeypatch):
    """pct=100 with a warmed histogram: fast repeats drop their pending
    spans instead of accumulating; offered >= retained in both."""
    monkeypatch.setenv("MXNET_TPU_TRACE_RETAIN_PCT", "100")
    nets = _nets(2)
    out = {}
    for k, (Server, gp, tr, metrics, _) in PKG.items():
        server = Server()
        server.register("gpd", nets[k], max_batch=4, max_wait_us=500,
                        input_spec=SPEC)
        try:
            before = len(tr.retained_traces())
            off0 = metrics.registry().get(
                "mxnet_tpu_goodput_traces_offered_total").value
            for _ in range(20):
                server.predict("gpd", np.zeros((2, 4), dtype="float32"))
            kept = len(tr.retained_traces()) - before
            offered = metrics.registry().get(
                "mxnet_tpu_goodput_traces_offered_total").value - off0
            retained = metrics.registry().get(
                "mxnet_tpu_goodput_traces_retained_total").value
            with tr._trace_lock:
                pending = len(tr._pending)
            out[k] = (kept <= 20, offered, offered >= kept,
                      retained >= 0, pending <= 256)
        finally:
            server.stop()
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == 20


def _llamas(seed=0):
    jmx.random.seed(seed)
    jnet = jax_llama_tiny(vocab_size=64, max_length=64)
    jnet.collect_params().initialize()
    params = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    tnet = llama_tiny(vocab_size=64, max_length=64, device="cpu")
    llama_state_dict_from_mxnet(params, tnet)
    return {"jax": jnet, "torch": tnet}


@pytest.mark.parametrize("kv_cache", [True, False])
def test_generation_requests_attribute_queue_execute_stream(kv_cache):
    torch.set_num_threads(1)
    nets = _llamas()
    out = {}
    for k, (Server, gp, _, _, _) in PKG.items():
        server = Server()
        server.register_generation("gen-gp", nets[k], max_slots=2,
                                   kv_cache=kv_cache, warmup=False)
        try:
            toks = server.generate("gen-gp", [1, 2, 3], max_new_tokens=4)
            rec = gp.serving().last_request
            assert rec["model"] == "gen-gp"
            assert sum(rec["buckets"].values()) == pytest.approx(
                rec["wall_seconds"], abs=1e-9)
            assert rec["buckets"].get("execute", 0) > 0
            out[k] = (toks, sorted(rec["buckets"]), rec["attrs"])
        finally:
            server.stop()
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == ["execute", "other", "queue", "stream"]


def test_memory_ledger_components_and_high_water():
    out = {}
    for k, (_, _, _, _, memory) in PKG.items():
        led = memory.ledger()

        class _Pool:
            nbytes = 4096

        pool = _Pool()
        pool.nbytes = led.snapshot()["high_water_bytes"] + 4096
        led.register_object("test:pool", pool, lambda p: p.nbytes)
        snap = led.snapshot()
        got = (snap["components"]["test:pool"] == pool.nbytes,
               snap["total_bytes"] >= pool.nbytes,
               snap["high_water_bytes"] >= snap["total_bytes"] - 1e-9,
               "test:pool" in snap["high_water_components"])
        pool.nbytes = 0
        del pool
        out[k] = got + ("test:pool" not in led.components(),
                        sorted(snap))
        led.unregister("test:pool")
    assert out["torch"] == out["jax"]
    assert all(out["torch"][:5])


def test_port_components_register_in_the_memory_ledger():
    """The page pool, the host staging buffers and a training step
    register as their JAX counterparts do (hostbuf.py:47,
    paged_cache.py:162, executor.py:519), and drop out once collected."""
    from mxnet_tpu_torch import gluon as g, optimizer
    from mxnet_tpu_torch.executor import CompiledTrainStep
    from mxnet_tpu_torch.serving import GenerationScheduler
    nets = _llamas(1)
    sched = GenerationScheduler(nets["torch"], max_slots=2, page_tokens=4,
                                name="ledger-lm")
    sched.submit([1, 2, 3], max_new_tokens=2)
    sched.run()
    net = g.nn.Dense(3, in_units=4, device="cpu")
    step = CompiledTrainStep(net, g.loss.L2Loss(),
                             optimizer.create("sgd", learning_rate=0.1))
    step(torch.randn(8, 4), torch.randn(8, 3))
    comps = tmemory.ledger().snapshot()["components"]
    pool = sched._target.pool
    assert comps["serving:kv_pages:ledger-lm"] == pool.k.nbytes * 2
    assert comps["serving:host_buffers:ledger-lm"] > 0
    assert comps["serving:host_buffers:ledger-lm-tables"] > 0
    assert comps["trainstep:Dense"] == step.live_bytes() > 0
    del sched, pool, step
    import gc
    gc.collect()
    comps = tmemory.ledger().components()
    assert "serving:kv_pages:ledger-lm" not in comps
    assert not any(c.startswith("trainstep:Dense") for c in comps)


def test_reconciliation_holds_on_every_served_request():
    """Every record of the port's serving ledger from one burst of
    co-batched requests reconciles (buckets + other == wall), and the
    bucket counters sum to the wall counter."""
    nets = _nets(4)
    server = TServer()
    server.register("gp-burst", nets["torch"], max_batch=8,
                    max_wait_us=20000, input_spec=SPEC)
    try:
        futs = [server.predict_async("gp-burst",
                                     np.full((1 + i % 3, 4), i, "float32"))
                for i in range(10)]
        [f.result() for f in futs]
        recs = [r for r in tgoodput.serving().records()
                if r["model"] == "gp-burst"]
        assert len(recs) == 10
        for r in recs:
            assert sum(r["buckets"].values()) == pytest.approx(
                r["wall_seconds"], abs=1e-9)
        fam = tmetrics.registry().get("mxnet_tpu_goodput_serving_seconds_total")
        wall = tmetrics.registry().get(
            "mxnet_tpu_goodput_serving_wall_seconds_total")
        total = sum(v for key, v in fam.sample_dict().items()
                    if 'model="gp-burst"' in key)
        assert total == pytest.approx(
            wall.labels(model="gp-burst").value, rel=1e-9)
        assert server.stats("gp-burst")["batches"] < 10
    finally:
        server.stop()
