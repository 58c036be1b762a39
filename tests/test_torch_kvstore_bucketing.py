"""Port parity: bucketed gradient fusion (``mxnet_tpu_torch/kvstore/
bucketing.py``), 2-bit compression and the Trainer's kvstore decision
matrix, in one process, against mxnet_tpu's.

The cases of ``tests/test_kvstore_bucketing.py``, each run in both
packages on the same values: the reduction count of a 50-key push is
ceil(bytes / cap), bucketed and per-key pulls are equal bit for bit,
list-form pushpull is one staged flush, priority orders the deferred
flush, overlap issues at capacity, dtype groups never mix, the async
store opts out, the Trainer's batched allreduce trains as the per-key
one does, a layout change resets the compression residuals and per-key
residuals survive.  Two cases of that file are not here: row-sparse keys
(the row-sparse arrays are ROADMAP A15) and ``CompiledTrainStep``'s
in-trace buckets (the port's step is plain PyTorch and reduces
nothing), and the bucket metrics are the plain ``keys_staged`` /
``buckets_issued`` counts (the metrics registry is ROADMAP A12).  The
JAX package reduces over its 8-device CPU mesh where the replica count
matches, and pairwise elsewhere; the port sums pairwise.  Integer values
make every order of addition exact, so the pulls are compared exactly.
The 2-bit codec's packed words (as uint32) and residuals are compared bit
for bit with the JAX package's ``_quantize_2bit``.  The Trainer runs
against the JAX package's within 1e-5 of each tensor's largest |value|
(XLA and PyTorch sum the forward's products in other orders).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.parallel.collectives as jcoll
from mxnet_tpu import kvstore as jkv
from mxnet_tpu.kvstore import gradient_compression as jgc
from mxnet_tpu.kvstore.bucketing import GradientBucketer as JBucketer
from mxnet_tpu.kvstore.bucketing import \
    partition_bucket_indices as jpartition
from mxnet_tpu.parallel import make_mesh

import mxnet_tpu_torch as tmx
import torch
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import kvstore as tkv
from mxnet_tpu_torch.kvstore import gradient_compression as tgc
from mxnet_tpu_torch.kvstore.bucketing import GradientBucketer as TBucketer
from mxnet_tpu_torch.kvstore.bucketing import \
    partition_bucket_indices as tpartition

N_PARAMS = 50


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)


def _count_jax_allreduce(monkeypatch):
    calls = {"n": 0}
    orig = jcoll.allreduce_arrays

    def counting(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(jcoll, "allreduce_arrays", counting)
    return calls


def _push_synthetic_model(mx, kv, dtype, elems):
    """Init + push a 50-key model, 8 replicas a key, integer values (bf16
    stays exact); the pulled arrays."""
    keys = list(range(N_PARAMS))
    kv.init(keys, [mx.nd.zeros((elems,), dtype=dtype) for _ in keys])
    vals = [[mx.nd.ones((elems,), dtype=dtype) * ((k + r) % 5 + 1)
             for r in range(8)] for k in keys]
    kv.push(keys, vals, priority=[-k for k in keys])
    outs = [mx.nd.zeros((elems,), dtype=dtype) for _ in keys]
    kv.pull(keys, out=outs)
    return [np.asarray(o.asnumpy()) for o in outs]


@pytest.mark.parametrize("dtype,itemsize", [("float32", 4), ("bfloat16", 2)])
def test_collective_count_collapses_to_ceil(monkeypatch, dtype, itemsize):
    elems = 1024
    bucket_bytes = 10 * elems * itemsize          # 10 keys a bucket
    expected = math.ceil(N_PARAMS * elems * itemsize / bucket_bytes)
    assert expected == 5
    pulls = {}
    for cap in (bucket_bytes // 1024, 0):
        monkeypatch.setenv("MXNET_KVSTORE_BUCKET_KB", str(cap))
        with make_mesh({"dp": 8}):
            calls = _count_jax_allreduce(monkeypatch)
            jax_pull = _push_synthetic_model(
                jmx, jkv.create("dist_tpu_sync"), dtype, elems)
        kv = tkv.create("dist_tpu_sync")
        pulls[cap] = _push_synthetic_model(tmx, kv, dtype, elems)
        rounds = kv._rounds_completed["allreduce"]
        assert rounds == calls["n"] == (expected if cap else N_PARAMS)
        assert kv.buckets_issued == (expected if cap else 0)
        for p, j in zip(pulls[cap], jax_pull):
            assert str(p.dtype) == str(j.dtype)
            assert np.array_equal(p.astype(np.float32), j.astype(np.float32))
    for b, p in zip(*pulls.values()):
        assert np.array_equal(b, p)                # bit for bit


def test_pushpull_list_form_single_staged_flush(monkeypatch):
    """List-form pushpull is one staged flush: ceil(12 KiB / 4 KiB)
    collectives, and the pull adds none."""
    monkeypatch.setenv("MXNET_KVSTORE_BUCKET_KB", "4")
    got = {}
    for mx, kv_mod in ((jmx, jkv), (tmx, tkv)):
        with make_mesh({"dp": 8}):
            kv = kv_mod.create("dist_tpu_sync")
            rounds = {"n": 0}
            inner = kv._collective

            def counting(what, fn, inner=inner, rounds=rounds):
                rounds["n"] += 1
                return inner(what, fn)

            kv._collective = counting
            keys = list(range(12))
            kv.init(keys, [mx.nd.zeros((16, 16)) for _ in keys])
            vals = [[mx.nd.ones((16, 16)) for _ in range(8)] for _ in keys]
            outs = [mx.nd.zeros((16, 16)) for _ in keys]
            kv.pushpull(keys, vals, out=outs, priority=[-k for k in keys])
        assert rounds["n"] == 3
        got[mx.__name__] = [o.asnumpy() for o in outs]
    for a, b in zip(*got.values()):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, 8.0)


def test_bucketed_compression_matches_perkey_trajectory(monkeypatch):
    """2-bit compression over bucket buffers: four steps of error
    feedback equal the per-key trajectory exactly, in both packages."""
    shapes = [(5,), (7,), (3, 3), (4,), (6,)]
    rng = np.random.RandomState(3)
    step_grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
                  for _ in range(4)]

    def run(mx, kv_mod, bucket_kb):
        monkeypatch.setenv("MXNET_KVSTORE_BUCKET_KB", str(bucket_kb))
        kv = kv_mod.create("device")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        keys = list(range(len(shapes)))
        kv.init(keys, [mx.nd.zeros(s) for s in shapes])
        history = []
        for grads in step_grads:
            kv.push(keys, [mx.nd.array(g) for g in grads])
            outs = [mx.nd.zeros(s) for s in shapes]
            kv.pull(keys, out=outs)
            history.append([o.asnumpy().copy() for o in outs])
        return history

    runs = [run(mx, kv_mod, kb) for mx, kv_mod in ((jmx, jkv), (tmx, tkv))
            for kb in (64, 0)]
    for other in runs[1:]:
        for step_a, step_b in zip(runs[0], other):
            for a, b in zip(step_a, step_b):
                np.testing.assert_array_equal(a, b)
    flat = np.concatenate([a.ravel() for a in runs[2][0]])
    assert set(np.unique(flat)).issubset({-0.5, 0.0, 0.5})


def _issue_order(Bucketer, full):
    issued = []

    def reduce_fn(flats, desc):
        issued.append(float(flats[0][0]))
        return flats[0]

    b = Bucketer(reduce_fn, capacity_bytes=4, overlap=False)
    for val, prio in [(1.0, -2), (2.0, 0), (3.0, -1)]:
        b.stage(val, str(val), [full(val)], priority=prio)
    out = b.flush()
    return issued, [k for k, _, _ in out], {sk: float(np.asarray(m)[0])
                                            for _, sk, m in out}


def test_priority_orders_deferred_flush():
    """With overlap off, flush issues buckets highest priority first."""
    jax_side = _issue_order(JBucketer,
                            lambda v: jnp.full((2,), v, jnp.float32))
    port = _issue_order(TBucketer,
                        lambda v: torch.full((2,), v, dtype=torch.float32))
    assert port == jax_side
    assert port[0] == [2.0, 3.0, 1.0] and port[1] == [1.0, 2.0, 3.0]


def _overlap_counts(Bucketer, zeros):
    issued = []

    def reduce_fn(flats, desc):
        issued.append(desc)
        return flats[0]

    b = Bucketer(reduce_fn, capacity_bytes=8, overlap=True)
    counts = []
    b.stage("a", "a", [zeros(2)])           # 8 B: fills the cap
    counts.append(len(issued))
    b.stage("b", "b", [zeros(1)])           # stays open
    counts.append(len(issued))
    out = b.flush()
    return counts + [len(issued), len(out)], issued


def test_overlap_issues_at_capacity():
    jax_side = _overlap_counts(JBucketer,
                               lambda n: jnp.zeros((n,), jnp.float32))
    port = _overlap_counts(TBucketer,
                           lambda n: torch.zeros(n, dtype=torch.float32))
    assert port == jax_side
    assert port[0] == [1, 1, 2, 2]


def test_overlap_waits_for_pending_reductions():
    """A reduction may come back in flight (an async all-reduce): flush
    waits for it before splitting."""
    from mxnet_tpu_torch.parallel.collectives import PendingReduce
    waited = []

    class Work:
        def wait(self):
            waited.append(True)

    b = TBucketer(lambda flats, desc: PendingReduce(flats[0] * 2, Work()),
                  capacity_bytes=8, overlap=True)
    b.stage("a", "a", [torch.ones(2)])
    assert b.issued == 1 and not waited
    out = b.flush()
    assert waited == [True]
    torch.testing.assert_close(out[0][2], torch.full((2,), 2.0))


def test_dtype_groups_never_mix():
    def run(Bucketer, ones, f32, bf16):
        seen = []

        def reduce_fn(flats, desc):
            seen.append(str(flats[0].dtype).replace("torch.", ""))
            return flats[0]

        b = Bucketer(reduce_fn, capacity_bytes=1 << 20, overlap=False)
        b.stage(0, "0", [ones(4, f32)])
        b.stage(1, "1", [ones(4, bf16)])
        b.stage(2, "2", [ones(4, f32)])
        n = len(b.flush())
        return sorted(seen), n

    jax_side = run(JBucketer, lambda n, d: jnp.ones((n,), d), jnp.float32,
                   jnp.bfloat16)
    port = run(TBucketer, lambda n, d: torch.ones(n, dtype=d), torch.float32,
               torch.bfloat16)
    assert port == jax_side == (["bfloat16", "float32"], 3)


@pytest.mark.parametrize("args,want", [
    (([4, 4, 4, 4], ["f"] * 4, 8), [[0, 1], [2, 3]]),
    (([4, 4, 4, 4], ["a", "b", "a", "b"], 8), [[0, 2], [1, 3]]),
    (([16, 4, 4], ["f"] * 3, 8), [[0], [1, 2]]),
    (([4] * 3, ["f"] * 3, 0), [[0, 1, 2]]),
])
def test_partition_bucket_indices(args, want):
    assert tpartition(*args) == jpartition(*args) == want


def test_async_store_opts_out_of_fusion(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_BUCKET_KB", "64")
    for mx, kv_mod in ((jmx, jkv), (tmx, tkv)):
        kv = kv_mod.create("dist_async")
        assert kv._fuse_dense_push is False
        kv.init([0, 1], [mx.nd.zeros((4,)) for _ in range(2)])
        kv.push([0, 1], [mx.nd.ones((4,)), mx.nd.ones((4,)) * 2])
        np.testing.assert_array_equal(kv.pull(0).asnumpy(), 1.0)
        np.testing.assert_array_equal(kv.pull(1).asnumpy(), 2.0)
    assert kv.buckets_issued == 0


def _train(side, bucket_kb, monkeypatch, steps=3):
    """The Trainer over dist_tpu_sync for ``steps`` steps of a 2-layer
    net from fixed weights.  In one process the port's store engages only
    with ``force_use`` (the JAX package's counts its 8-device mesh)."""
    monkeypatch.setenv("MXNET_KVSTORE_BUCKET_KB", str(bucket_kb))
    mx = jmx if side == "jax" else tmx
    rng = np.random.RandomState(5)
    w = [rng.randn(16, 10).astype(np.float32) * 0.3,
         rng.randn(16).astype(np.float32) * 0.1,
         rng.randn(8, 16).astype(np.float32) * 0.3,
         rng.randn(8).astype(np.float32) * 0.1]
    x = mx.nd.array(rng.randn(4, 10).astype(np.float32))
    net = mx.gluon.nn.HybridSequential(prefix="bk_")
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(16, activation="relu", in_units=10),
                mx.gluon.nn.Dense(8, in_units=16))
    net.initialize()
    params = list(net.collect_params().values())
    for p, v in zip(params, w):
        p.set_data(mx.nd.array(v))
    with make_mesh({"dp": 8}):
        kv = mx.kv.create("dist_tpu_sync")
        kv.force_use = True
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1}, kvstore=kv)
        for _ in range(steps):
            with mx.autograd.record():
                loss = (net(x) ** 2).sum()
            loss.backward()
            trainer.step(4)
    return [p.data().asnumpy().copy() for p in params], kv


def test_trainer_batched_allreduce_bitwise_parity(monkeypatch):
    """Trainer.step over dist_tpu_sync: bucketed and per-key training are
    equal bit for bit after 3 steps (one bucket a step against one
    reduction a key), and agree with the JAX package's."""
    bucketed, kv = _train("port", 2, monkeypatch)
    assert kv.buckets_issued == 3 and kv.keys_staged == 12
    perkey, kv0 = _train("port", 0, monkeypatch)
    assert kv0._rounds_completed["allreduce"] == 12
    for b, p in zip(bucketed, perkey):
        assert np.array_equal(b, p)
    ref, _ = _train("jax", 2, monkeypatch)
    for b, r in zip(bucketed, ref):
        np.testing.assert_allclose(b, r, rtol=0,
                                   atol=1e-5 * np.abs(r).max() + 1e-6)


def test_layout_change_resets_compression_residuals(monkeypatch):
    """A Trainer made again on the same store with another bucket layout
    must not apply the old layout's residuals where a bucket signature
    carries over."""
    monkeypatch.setenv("MXNET_KVSTORE_BUCKET_KB", "1")
    shapes = [(300,), (300,), (300,)]         # 1.2 KB each: a bucket a key
    rng = np.random.RandomState(7)
    grads = [rng.randn(*s).astype(np.float32) for s in shapes]

    def run(mx, kv_mod):
        def fresh_store(keys):
            kv = kv_mod.create("device")
            kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
            kv.init(keys, [mx.nd.zeros(shapes[k]) for k in keys])
            return kv

        def push(kv, keys, scale=1.0):
            kv.push(keys, [mx.nd.array(grads[k] * scale) for k in keys])
            outs = [mx.nd.zeros(shapes[k]) for k in keys]
            kv.pull(keys, out=outs)
            return [o.asnumpy().copy() for o in outs]

        kv = fresh_store([0, 1, 2])
        push(kv, [0, 1, 2])
        push(kv, [0, 1, 2])
        assert kv._compression._residuals
        got = [push(kv, [0, 1], scale=0.3) for _ in range(2)]
        kv2 = fresh_store([0, 1])
        want = [push(kv2, [0, 1], scale=0.3) for _ in range(2)]
        for g_step, w_step in zip(got, want):
            for g, w in zip(g_step, w_step):
                np.testing.assert_array_equal(g, w)
        assert any(not np.array_equal(a, b) for a, b in zip(got[0], got[1]))
        return got

    for a, b in zip(run(jmx, jkv), run(tmx, tkv)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_perkey_compression_residuals_survive_alternating_pushes(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_BUCKET_KB", "64")
    g = np.array([0.2, 0.3, -0.2, 0.1, 0.4], np.float32)
    for mx, kv_mod in ((jmx, jkv), (tmx, tkv)):
        kv = kv_mod.create("device")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.init(0, mx.nd.zeros((5,)))
        kv.init(1, mx.nd.zeros((5,)))
        pulls = []
        for _ in range(2):
            kv.push(0, mx.nd.array(g))
            pulls.append(kv.pull(0).asnumpy().copy())
            kv.push(1, mx.nd.array(g * 0.5))
        np.testing.assert_array_equal(pulls[0], 0.0)
        assert pulls[1].max() == 0.5
        assert set(kv._compression._residuals) == {"0", "1"}


def test_bucket_counts(monkeypatch):
    """8 keys of 64 B fuse into one bucket: 8 staged, 1 issued."""
    monkeypatch.setenv("MXNET_KVSTORE_BUCKET_KB", "64")
    kv = tkv.create("device")
    keys = list(range(8))
    kv.init(keys, [tmx.nd.zeros((16,)) for _ in keys])
    kv.push(keys, [tmx.nd.ones((16,)) for _ in keys])
    assert (kv.keys_staged, kv.buckets_issued) == (8, 1)
    kv.push(keys[:1], [tmx.nd.ones((16,))])      # one key: the per-key path
    assert (kv.keys_staged, kv.buckets_issued) == (8, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 16, 37, 1000])
def test_two_bit_codec_bit_for_bit(dtype, n):
    """The packed words, read as uint32, and the residuals equal the JAX
    package's ``_quantize_2bit`` over three rounds of error feedback; the
    decoded values equal its ``_dequantize_2bit``."""
    rng = np.random.RandomState(n)
    tdt = getattr(torch, dtype)
    res_j = jnp.zeros((n,), dtype)
    res_t = torch.zeros(n, dtype=tdt)
    for _ in range(3):
        g = (rng.randn(n) * 0.4).astype(np.float32)
        g[: n // 4] = 0.5                          # on the threshold
        words_j, res_j = jgc._quantize_2bit(
            jnp.asarray(g, dtype), res_j, jnp.asarray(0.5, dtype))
        words_t, res_t = tgc._quantize_2bit(torch.tensor(g).to(tdt), res_t,
                                            0.5)
        assert words_t.dtype == torch.int32
        np.testing.assert_array_equal(words_t.numpy().view(np.uint32),
                                      np.asarray(words_j))
        np.testing.assert_array_equal(res_t.float().numpy(),
                                      np.asarray(res_j).astype(np.float32))
        dec_j = jgc._dequantize_2bit(words_j, 0.5, n, dtype)
        dec_t = tgc._dequantize_2bit(words_t, 0.5, n, tdt)
        np.testing.assert_array_equal(dec_t.float().numpy(),
                                      np.asarray(dec_j).astype(np.float32))


def test_compression_roundtrip_and_reset():
    gc_j = jgc.GradientCompression(threshold=0.25)
    gc_t = tgc.GradientCompression(threshold=0.25)
    assert gc_t.get_params() == gc_j.get_params()
    g = np.random.RandomState(2).randn(3, 7).astype(np.float32) * 0.3
    for _ in range(2):
        a = np.asarray(gc_j.roundtrip("k", jnp.asarray(g)))
        b = gc_t.roundtrip("k", torch.tensor(g)).numpy()
        np.testing.assert_array_equal(a, b)
    gc_t.reset("k")
    assert "k" not in gc_t._residuals
    with pytest.raises(ValueError):
        tgc.GradientCompression(type="1bit")


# ------------------------------------- the Trainer's kvstore decision matrix
def _dense(mx):
    net = mx.gluon.nn.Dense(3, in_units=4, prefix="dm_")
    net.initialize()
    return net


def _one_step(mx, trainer, net):
    x = mx.nd.array(np.ones((2, 4), np.float32))
    with mx.autograd.record():
        loss = net(x).sum()
    loss.backward()
    trainer.step(2)


@pytest.mark.parametrize("kind", [None, "local", "device", "dist_sync",
                                  "dist_async"])
def test_trainer_engages_no_store_with_one_worker(kind):
    """One process: no store engages unless ``force_use`` (the JAX
    package's engages its dist stores over its 8-device mesh)."""
    net = _dense(tmx)
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1}, kvstore=kind)
    _one_step(tmx, trainer, net)
    assert trainer._kvstore is None


@pytest.mark.parametrize("env_value,want", [(None, True), ("0", False)])
def test_trainer_update_on_kvstore(monkeypatch, env_value, want):
    """``update_on_kvstore`` None reads MXNET_UPDATE_ON_KVSTORE; both
    placements of the update give the JAX package's numbers."""
    if env_value is not None:
        monkeypatch.setenv("MXNET_UPDATE_ON_KVSTORE", env_value)
    got = {}
    for mx in (jmx, tmx):
        net = _dense(mx)
        net.collect_params()["dm_weight"].set_data(
            mx.nd.array(np.arange(12, dtype=np.float32).reshape(3, 4) / 10))
        kv = mx.kv.create("device")
        kv.force_use = True
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1, "momentum": 0.9},
                                   kvstore=kv)
        for _ in range(2):
            _one_step(mx, trainer, net)
        got[mx.__name__] = [p.data().asnumpy()
                            for p in net.collect_params().values()]
        if mx is tmx:
            assert trainer._kvstore is kv
            assert trainer._update_on_kvstore is want
    for a, b in zip(*got.values()):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_trainer_compression_params_reach_the_store():
    """The port's Trainer sets ``compression_params`` on the store it
    engages (the JAX package's keeps them unused): each gradient sum is
    quantized to 0 or +-0.5 before SGD applies it."""
    net = _dense(tmx)
    w0 = net.collect_params()["dm_weight"].data().asnumpy().copy()
    kv = tkv.create("device")
    kv.force_use = True
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1}, kvstore=kv,
                                compression_params={"type": "2bit",
                                                    "threshold": 0.5})
    _one_step(tmx, trainer, net)
    assert kv._compression.get_params() == {"type": "2bit",
                                            "threshold": 0.5}
    step = (w0 - net.collect_params()["dm_weight"].data().asnumpy()) / 0.1
    np.testing.assert_allclose(step, 0.5 / 2, rtol=1e-6)   # 1/batch of 0.5


def test_trainer_optimizer_state_sharding_raises(monkeypatch):
    net = _dense(tmx)
    with pytest.raises(MXNetError, match="A11"):
        tmx.gluon.Trainer(net.collect_params(), "sgd",
                          optimizer_state_sharding=True)
    monkeypatch.setenv("MXNET_KVSTORE_SHARD", "1")
    kv = tkv.create("device")
    kv.init([0, 1], [tmx.nd.zeros((2,)), tmx.nd.zeros((2,))])
    with pytest.raises(MXNetError, match="A11"):
        kv.push([0, 1], [tmx.nd.ones((2,)), tmx.nd.ones((2,))])
