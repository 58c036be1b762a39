"""Port parity: the non-generative serving path (``InferenceEngine``,
``DynamicBatcher``, ``ModelServer.register``, the in-process ``Client``)
against mxnet_tpu's, on the CPU.

Mirrors the non-generative tests of ``tests/test_serving.py`` on the
port, and serves a small BERT (2 layers, 32 units, seq 16) through both
packages' ``ModelServer.register`` on the same weights.

Tolerance: a served row against a solo forward of the same block within
1e-5 of the output's largest |value| plus 1e-6 (a padded rung sums in
another order than the solo call); rows of one executable shape with
different neighbours are compared bit for bit; the BERT answers against
the JAX package's within the same 1e-5 bound.
"""
import threading

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo.language import bert as jbert
from mxnet_tpu.serving import ModelServer as JServer

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch.error import DeadlineExceededError, OverloadedError
from mxnet_tpu_torch.gluon.model_zoo.language import bert as tbert
from mxnet_tpu_torch.serving import (DynamicBatcher, InferenceEngine,
                                     ModelServer, ServingStats, bucket_for,
                                     bucket_ladder)

REL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)


def _close(got, ref, rel=REL, what=""):
    got = np.asarray(got.asnumpy() if hasattr(got, "asnumpy") else got)
    ref = np.asarray(ref.asnumpy() if hasattr(ref, "asnumpy") else ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    bound = rel * float(np.abs(ref).max()) + 1e-6
    err = float(np.abs(got - ref).max())
    assert err <= bound, f"{what}: max err {err} > {bound}"


def _mlp(out_units=3, in_units=4, seed=0):
    tmx.random.seed(seed)
    net = gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(gluon.nn.Dense(8, in_units=in_units))
        net.add(gluon.nn.Dense(out_units, in_units=8))
    net.initialize()
    return net


SPEC = [((4,), "float32")]


# --------------------------------------------------------------- ladder math
def test_bucket_ladder_shapes():
    assert bucket_ladder(8) == (1, 2, 4, 8)
    assert bucket_ladder(1) == (1,)
    assert bucket_ladder(6) == (1, 2, 4, 6)
    assert bucket_for(3, (1, 2, 4, 8)) == 4
    assert bucket_for(8, (1, 2, 4, 8)) == 8
    with pytest.raises(tmx.MXNetError):
        bucket_for(9, (1, 2, 4, 8))
    with pytest.raises(ValueError):
        bucket_ladder(0)


def test_stats_percentiles_and_histograms():
    s = ServingStats("m")
    for us in (100, 200, 300, 400, 1000):
        s.record_request(us)
    s.record_batch(3, 5, 8)
    s.record_batch(1, 1, 1)
    s.record_error()
    s.record_shed()
    snap = s.snapshot({"entries": 2, "hits": 7, "misses": 2,
                       "signatures": [("a",)]})
    assert snap["requests"] == 5 and snap["batches"] == 2
    assert snap["latency_us_p50"] == 300
    assert snap["latency_us_p99"] == 1000
    assert snap["batch_occupancy"] == {3: 1, 1: 1}
    assert snap["bucket_use"] == {8: 1, 1: 1}
    assert snap["compile_cache"]["hits"] == 7
    assert snap["compile_cache"]["signatures"] == ["('a',)"]
    assert (snap["errors"], snap["sheds"], snap["expired"]) == (1, 1, 0)
    assert snap["mean_requests_per_batch"] == 2.5
    assert "compile_cache" not in s.snapshot()


# ------------------------------------------------------------------- engine
def test_engine_pads_to_bucket_and_slices_back():
    net = _mlp()
    eng = InferenceEngine(net, input_spec=SPEC, max_batch=8)
    assert eng.warmup() == 4
    stats0 = eng.cache_stats
    assert stats0["entries"] == len(eng.ladder) == 4
    assert stats0["misses"] == 4
    x = np.random.RandomState(0).randn(3, 4).astype("float32")
    out = eng.predict(x)
    assert out.shape == (3, 3)
    _close(out, net(nd.array(x)))
    assert eng.cache_stats["entries"] == 4
    assert eng.cache_stats["hits"] >= 1
    # warmup takes the largest rung first (the others share its graphs'
    # memory pool on the card)
    assert [sig[0][0][0] for sig in eng.cache_stats["signatures"]] == [
        (8, 4), (4, 4), (2, 4), (1, 4)]
    assert eng.cache_stats["signatures"][1][0] == (((4, 4), "float32"),)


def test_engine_chunks_oversized_requests():
    net = _mlp()
    eng = InferenceEngine(net, input_spec=SPEC, max_batch=4)
    x = np.random.RandomState(1).randn(11, 4).astype("float32")
    out = eng.predict(x)
    assert out.shape == (11, 3)
    _close(out, net(nd.array(x)))
    sizes = {sig[0][0][0][0] for sig in eng.cache_stats["signatures"]}
    assert sizes <= set(eng.ladder)


def test_engine_validates_spec():
    eng = InferenceEngine(_mlp(), input_spec=SPEC, max_batch=4)
    with pytest.raises(tmx.MXNetError, match="feature shape"):
        eng.predict(np.zeros((2, 5), dtype="float32"))
    with pytest.raises(tmx.MXNetError, match="dtype"):
        eng.predict(np.zeros((2, 4), dtype="int32"))
    with pytest.raises(tmx.MXNetError, match="empty request"):
        eng.predict(np.zeros((0, 4), dtype="float32"))
    with pytest.raises(tmx.MXNetError, match="expected 1 inputs"):
        eng.predict([np.zeros((1, 4), "float32")] * 2)
    with pytest.raises(tmx.MXNetError, match="input_spec"):
        InferenceEngine(_mlp(), max_batch=2).warmup()


def test_engine_spec_from_captured_signature():
    net = _mlp()
    net(nd.array(np.zeros((2, 4), dtype="float32")))
    eng = InferenceEngine(net, max_batch=4)
    assert eng.input_spec == [((4,), "float32")]
    assert eng.warmup() == len(eng.ladder)


def test_engine_from_export_roundtrip(tmp_path):
    net = _mlp(seed=3)
    x = nd.array(np.random.RandomState(2).randn(2, 4).astype("float32"))
    ref = net(x)
    prefix = str(tmp_path / "mlp")
    net.export(prefix)
    eng = InferenceEngine.from_export(prefix, max_batch=4)
    assert eng.input_spec == [((4,), "float32")]
    assert eng.name == "mlp"
    eng.warmup()
    _close(eng.predict(x), ref)


def test_jax_export_serves_on_the_port(tmp_path):
    """A JAX package export, served by the port's engine, answers as the
    JAX block does."""
    jmx.random.seed(4)
    jnet = jmx.gluon.nn.HybridSequential(prefix="j_")
    with jnet.name_scope():
        jnet.add(jmx.gluon.nn.Dense(8, activation="relu", in_units=4),
                 jmx.gluon.nn.Dense(3, in_units=8))
    jnet.collect_params().initialize()
    x = np.random.RandomState(5).randn(3, 4).astype("float32")
    ref = jnet(jmx.nd.array(x))
    jnet.export(str(tmp_path / "j"))
    eng = InferenceEngine.from_export(str(tmp_path / "j"), max_batch=4,
                                      ctx=tmx.cpu())
    eng.warmup()
    _close(eng.predict(x), ref)


# ------------------------------------------------------------------ batcher
def test_batcher_packs_concurrent_requests():
    net = _mlp()
    stats = ServingStats("mlp")
    eng = InferenceEngine(net, input_spec=SPEC, max_batch=8, stats=stats)
    eng.warmup()
    batcher = DynamicBatcher(eng, max_wait_us=200_000, stats=stats)
    n_clients = 6
    gate = threading.Barrier(n_clients)
    futs = [None] * n_clients
    xs = [np.random.RandomState(i).randn(1, 4).astype("float32")
          for i in range(n_clients)]

    def submit(i):
        gate.wait()
        futs[i] = batcher.submit(xs[i])

    threads = [threading.Thread(target=submit, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(n_clients):
        _close(futs[i].result(timeout=30), net(nd.array(xs[i])))
    snap = stats.snapshot()
    assert snap["requests"] == n_clients
    assert any(k >= 2 for k in snap["batch_occupancy"]), snap
    assert eng.cache_stats["misses"] == 4
    batcher.close()


def test_batching_row_isolation_is_bitwise():
    """Your rows of a shared batch do not depend on the other requests in
    it, bit for bit: same rung, same offset, two different neighbours;
    zero padding is just another neighbour."""
    net = _mlp()
    eng = InferenceEngine(net, input_spec=SPEC, max_batch=4)
    eng.warmup()
    rng = np.random.RandomState(7)
    mine = rng.randn(3, 4).astype("float32")
    neighbor_a = rng.randn(1, 4).astype("float32")
    neighbor_b = rng.randn(1, 4).astype("float32") * 100.0
    run_a = eng.predict(np.concatenate([neighbor_a, mine]))
    run_b = eng.predict(np.concatenate([neighbor_b, mine]))
    np.testing.assert_array_equal(run_a.asnumpy()[1:], run_b.asnumpy()[1:])
    run_z = eng.predict(np.concatenate([np.zeros((1, 4), "float32"), mine]))
    np.testing.assert_array_equal(run_z.asnumpy()[1:], run_a.asnumpy()[1:])


def test_batcher_carry_respects_max_batch():
    eng = InferenceEngine(_mlp(), input_spec=SPEC, max_batch=4)
    eng.warmup()
    stats = ServingStats("m")
    b = DynamicBatcher(eng, max_wait_us=100_000, stats=stats)
    futs = [b.submit(np.ones((3, 4), dtype="float32")) for _ in range(2)]
    for f in futs:
        assert f.result(timeout=30).shape == (3, 3)
    assert stats.snapshot()["batches"] == 2
    b.close()


def test_batcher_shutdown_drains_accepted_requests():
    eng = InferenceEngine(_mlp(), input_spec=SPEC, max_batch=4)
    eng.warmup()
    b = DynamicBatcher(eng, max_wait_us=1000)
    futs = [b.submit(np.full((1, 4), i, dtype="float32")) for i in range(10)]
    assert b.close()
    assert all(f.done() and f.exception() is None for f in futs)
    with pytest.raises(RuntimeError, match="shut down"):
        b.submit(np.zeros((1, 4), dtype="float32"))
    assert b.fail_pending() == 0


def test_batcher_isolates_bad_requests():
    eng = InferenceEngine(_mlp(), input_spec=SPEC, max_batch=4)
    b = DynamicBatcher(eng)
    with pytest.raises(tmx.MXNetError):
        b.submit(np.zeros((1, 7), dtype="float32"))
    ok = b.submit(np.zeros((1, 4), dtype="float32")).result(timeout=30)
    assert ok.shape == (1, 3)
    b.close()


def test_batcher_failed_batch_fails_only_its_requests():
    """A batch whose forward raises fails its own futures and counts the
    errors; the next batch runs."""
    eng = InferenceEngine(_mlp(), input_spec=SPEC, max_batch=4)
    eng.warmup()
    stats = ServingStats("m")
    b = DynamicBatcher(eng, max_wait_us=1000, stats=stats)
    real = eng.execute_padded

    def broken(arrs, rows):
        eng.execute_padded = real
        raise RuntimeError("injected")
    eng.execute_padded = broken
    with pytest.raises(RuntimeError, match="injected"):
        b.submit(np.zeros((1, 4), "float32")).result(timeout=30)
    assert b.submit(np.zeros((1, 4), "float32")).result(
        timeout=30).shape == (1, 3)
    assert stats.snapshot()["errors"] == 1
    b.close()


def test_batcher_admission_control(monkeypatch):
    """A full queue sheds with OverloadedError; a request past its
    deadline fails with DeadlineExceededError instead of running."""
    eng = InferenceEngine(_mlp(), input_spec=SPEC, max_batch=4)
    eng.warmup()
    stats = ServingStats("m")
    gate = threading.Event()
    real = eng.execute_padded

    def slow(arrs, rows):
        gate.wait(30)
        return real(arrs, rows)
    eng.execute_padded = slow
    b = DynamicBatcher(eng, max_wait_us=0, stats=stats, max_queue=1)
    first = b.submit(np.zeros((4, 4), "float32"))     # occupies the worker
    while b.pending:
        pass
    late = b.submit(np.zeros((1, 4), "float32"), deadline_ms=1)
    with pytest.raises(OverloadedError) as err:
        b.submit(np.zeros((1, 4), "float32"))
    assert err.value.retry_after_s >= 1.0
    threading.Event().wait(0.01)
    gate.set()
    assert first.result(timeout=30).shape == (4, 3)
    with pytest.raises(DeadlineExceededError):
        late.result(timeout=30)
    snap = stats.snapshot()
    assert (snap["sheds"], snap["expired"]) == (1, 1)
    b.close()


def test_batcher_oversized_request_records_clean_stats():
    stats = ServingStats("m")
    eng = InferenceEngine(_mlp(), input_spec=SPEC, max_batch=4, stats=stats)
    eng.warmup()
    b = DynamicBatcher(eng, stats=stats)
    out = b.submit(np.zeros((10, 4), dtype="float32")).result(timeout=30)
    assert out.shape == (10, 3)
    snap = stats.snapshot()
    assert snap["errors"] == 0
    assert snap["batches"] == 1 and snap["requests"] == 1
    assert snap["bucket_use"] == {4: 1}
    b.close()


def test_batcher_without_a_spec_joins_requests_on_the_device():
    """Before any spec is known the batcher sends each request to the
    device and joins them there; the first batch fixes the spec, and the
    answers are the same."""
    net = _mlp()
    eng = InferenceEngine(net, max_batch=4)
    b = DynamicBatcher(eng, max_wait_us=50_000)
    xs = [np.random.RandomState(i).randn(2, 4).astype("float32")
          for i in range(2)]
    futs = [b.submit(x) for x in xs]
    for f, x in zip(futs, xs):
        _close(f.result(timeout=30), net(nd.array(x)))
    assert eng.input_spec == SPEC
    b.close()


# ------------------------------------------------------------------- server
def test_server_stats_client_and_shutdown():
    server = ModelServer()
    eng = server.register("mlp", _mlp(), max_batch=4, max_wait_us=1000,
                          input_spec=SPEC)
    out = server.client().predict("mlp", np.zeros((2, 4), dtype="float32"))
    assert out.shape == (2, 3)
    snap = server.stats("mlp")
    assert snap["requests"] == 1 and snap["compile_cache"]["misses"] == 3
    assert server.models() == ["mlp"] and list(server.stats()) == ["mlp"]
    assert eng.stats_snapshot()["ladder"] == [1, 2, 4]
    server.stop()
    with pytest.raises(RuntimeError):
        server.predict("mlp", np.zeros((1, 4), dtype="float32"))
    server.stop()


def test_server_unknown_model_and_duplicate_register():
    server = ModelServer()
    server.register("a", _mlp(), max_batch=2, input_spec=SPEC)
    with pytest.raises(tmx.MXNetError, match="unknown model"):
        server.predict("nope", np.zeros((1, 4), dtype="float32"))
    with pytest.raises(tmx.MXNetError, match="already registered"):
        server.register("a", _mlp())
    with pytest.raises(tmx.MXNetError, match="block or an engine"):
        server.register("b")
    server.stop()
    with pytest.raises(tmx.MXNetError, match="stopped"):
        server.register("c", _mlp(), input_spec=SPEC)


def test_register_warms_the_ladder_on_the_worker_thread():
    """The ladder's warmup forwards run on the batcher's worker thread,
    the thread that serves: a thread's first forward on the card sets up
    its library handles, which the first live batch must not pay for."""
    import threading as th
    net = _mlp()
    threads = []
    net.register_forward_pre_hook(
        lambda block, args: threads.append(th.current_thread().name))
    server = ModelServer()
    server.register("m", net, max_batch=4, input_spec=SPEC)
    assert len(threads) == 4 and set(threads) == {"mx-serving-batcher-m"}
    server.predict("m", np.zeros((3, 4), "float32"))
    assert threads[-1] == "mx-serving-batcher-m"
    assert server.stats("m")["compile_cache"]["hits"] == 1
    server.stop()


def test_server_register_needs_a_spec_to_warm_up():
    server = ModelServer()
    with pytest.raises(tmx.MXNetError, match="input_spec"):
        server.register("m", _mlp())
    server.register("m", _mlp(), warmup=False)
    assert server.predict("m", np.zeros((1, 4), "float32")).shape == (1, 3)
    server.stop()


# ------------------------------------------------------- BERT, both servers
BERT_CFG = dict(vocab_size=60, units=32, hidden_size=64, num_layers=2,
                num_heads=4, max_length=16, dropout=0.1)
SEQ = 16


def test_small_bert_served_like_the_jax_server(tmp_path):
    """A small BERT (2 layers, 32 units, seq 16, dropout 0.1: the identity
    in predict mode) served through ``register`` on both packages from
    the same weights: 8 concurrent requests of 1-3 rows, two outputs each
    (sequence, pooled), equal to the JAX server's answers and to a solo
    forward; the ladder's 4 entries, then hits only."""
    jmx.random.seed(0)
    jnet = jbert.BERTModel(prefix="bert_", **BERT_CFG)
    jnet.collect_params().initialize(jmx.init.Normal(0.02))
    jnet.save_parameters(str(tmp_path / "bert.params"))
    tnet = tbert.BERTModel(prefix="bert_", device="cpu", **BERT_CFG)
    tnet.load_parameters(str(tmp_path / "bert.params"))
    spec = [((SEQ,), "int32")]
    rng = np.random.RandomState(0)
    reqs = [rng.randint(0, 60, (int(rng.randint(1, 4)), SEQ)).astype(
        np.int32) for _ in range(8)]
    answers = {}
    for name, server, net in (("jax", JServer(), jnet),
                              ("port", ModelServer(), tnet)):
        eng = server.register("bert", net, max_batch=8, max_wait_us=100_000,
                              input_spec=spec)
        assert eng.cache_stats["misses"] == 4
        gate = threading.Barrier(len(reqs))
        out = [None] * len(reqs)

        def call(i, server=server, gate=gate, out=out):
            gate.wait()
            out[i] = server.predict("bert", reqs[i])

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = server.stats("bert")
        server.stop()
        assert stats["requests"] == len(reqs)
        assert stats["compile_cache"]["misses"] == 4
        assert stats["compile_cache"]["entries"] == 4
        assert stats["compile_cache"]["hits"] == stats["batches"]
        answers[name] = out
    for i, (t, j) in enumerate(zip(answers["port"], answers["jax"])):
        assert len(t) == 2 and t[0].shape == (len(reqs[i]), SEQ, 32)
        assert t[1].shape == (len(reqs[i]), 32)
        _close(t[0], j[0], what=f"request {i} sequence")
        _close(t[1], j[1], what=f"request {i} pooled")
        solo = tnet(nd.array(reqs[i], dtype="int32"))
        _close(t[0], solo[0], what=f"request {i} solo")
