"""Port parity: the one-process KVStore (``mx.kv``, ``'local'`` and
``'device'``) against mxnet_tpu's, on the CPU.

The one-process cases of ``tests/test_kvstore.py``: each runs the same
pushes and pulls in both packages on the same seeded values and compares
what comes out, the dist stores in one process and 2-bit compression
included.  Row-sparse pulls are not ported: the port raises for them.

Tolerance: sums and updates of the same fp32 values in the same order
agree exactly; they are compared within 1e-6 of the largest |value|
(PyTorch and XLA may fuse an SGD update's multiply-adds differently).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import kvstore as jkv

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import kvstore as tkv

SHAPE = (4, 4)
KEYS = [5, 7, 11]
BOTH = [(jmx, jkv), (tmx, tkv)]


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)


def _vals(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.uniform(-1, 1, SHAPE).astype(np.float32) for _ in range(n)]


def _init_kv(mx, kv_mod, name="local"):
    kv = kv_mod.create(name)
    kv.init(3, mx.nd.zeros(SHAPE))
    kv.init(KEYS, [mx.nd.zeros(SHAPE)] * len(KEYS))
    return kv


def _same(case):
    """``case(mx, kv_mod)`` in both packages: the port's numpy results
    equal the JAX package's."""
    ref, got = (case(mx, kv_mod) for mx, kv_mod in BOTH)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape and g.dtype == r.dtype, (g, r)
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-6 * max(np.abs(r).max(), 1))
    return got


@pytest.mark.parametrize("name", ["local", "device"])
def test_single_kv_pair(name):
    def case(mx, kv_mod):
        kv = _init_kv(mx, kv_mod, name)
        kv.push(3, mx.nd.array(_vals(1)[0]))
        out = mx.nd.empty(SHAPE)
        kv.pull(3, out=out)
        return [out.asnumpy(), kv.pull(3).asnumpy()]
    got = _same(case)
    np.testing.assert_array_equal(got[0], _vals(1)[0])


def test_init_twice_errors():
    for mx, kv_mod in BOTH:
        kv = _init_kv(mx, kv_mod)
        with pytest.raises(mx.MXNetError):
            kv.init(3, mx.nd.ones(SHAPE))


@pytest.mark.parametrize("n", [2, 3, 4, 7])
def test_push_list_sums_pairwise(n):
    """A pushed value list is summed, pairs first."""
    def case(mx, kv_mod):
        kv = _init_kv(mx, kv_mod, "device")
        kv.push(3, [mx.nd.array(v) for v in _vals(n, seed=n)])
        out = mx.nd.empty(SHAPE)
        kv.pull(3, out=out)
        return [out.asnumpy()]
    _same(case)


def test_list_kv_pairs():
    def case(mx, kv_mod):
        kv = _init_kv(mx, kv_mod)
        kv.push(KEYS, [mx.nd.array(v) for v in _vals(len(KEYS))])
        outs = [mx.nd.empty(SHAPE) for _ in KEYS]
        kv.pull(KEYS, out=outs)
        return [o.asnumpy() for o in outs]
    _same(case)


def test_updater_runs_on_push():
    def case(mx, kv_mod):
        kv = _init_kv(mx, kv_mod)
        updates = []

        def updater(key, merged, stored):
            updates.append(key)
            stored += merged * 2

        kv._set_updater(updater)
        out = mx.nd.empty(SHAPE)
        got = []
        for _ in range(2):
            kv.push(3, mx.nd.ones(SHAPE))
            kv.pull(3, out=out)
            got.append(out.asnumpy())
        assert updates == [3, 3]  # the original (int) key reaches it
        return got
    got = _same(case)
    np.testing.assert_array_equal(got[1], 4.0)


def test_pull_without_updater_replaces():
    def case(mx, kv_mod):
        kv = _init_kv(mx, kv_mod)
        kv.push(3, mx.nd.ones(SHAPE))
        kv.push(3, mx.nd.ones(SHAPE) * 5)
        out = mx.nd.empty(SHAPE)
        kv.pull(3, out=out)
        return [out.asnumpy()]
    got = _same(case)
    np.testing.assert_array_equal(got[0], 5.0)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_kvstore_with_optimizer(opt):
    """With an optimizer the push updates the stored weight (three pushes,
    so SGD's momentum and Adam's counts come into it)."""
    def case(mx, kv_mod):
        kv = kv_mod.create("local")
        kv.set_optimizer(mx.optimizer.create(
            opt, learning_rate=0.1, rescale_grad=0.5, wd=0.01,
            **({"momentum": 0.9} if opt == "sgd" else {})))
        w0, *grads = _vals(4, seed=1)
        kv.init(0, mx.nd.array(w0))
        out = mx.nd.empty(SHAPE)
        got = []
        for g in grads:
            kv.push(0, mx.nd.array(g))
            kv.pull(0, out=out)
            got.append(out.asnumpy())
        return got
    _same(case)


def test_kvstore_sgd_step_value():
    def case(mx, kv_mod):
        kv = kv_mod.create("local")
        kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1,
                                             rescale_grad=1.0, wd=0.0))
        kv.init(0, mx.nd.ones(SHAPE))
        kv.push(0, mx.nd.ones(SHAPE))
        out = mx.nd.empty(SHAPE)
        kv.pull(0, out=out)
        return [out.asnumpy()]
    got = _same(case)
    np.testing.assert_allclose(got[0], 0.9, rtol=1e-6)


def test_pushpull():
    def case(mx, kv_mod):
        kv = _init_kv(mx, kv_mod, "device")
        out = mx.nd.empty(SHAPE)
        kv.pushpull(3, [mx.nd.array(v) for v in _vals(3)], out=out)
        return [out.asnumpy()]
    _same(case)


def test_broadcast_list_value_and_multi_key():
    def case(mx, kv_mod):
        kv = kv_mod.create("local")
        out = mx.nd.zeros((3,))
        kv.broadcast("bk1", [mx.nd.ones((3,)) * 2, mx.nd.ones((3,)) * 2],
                     out)
        outs = [mx.nd.zeros((2,)), mx.nd.zeros((2,))]
        kv.broadcast(["bk2", "bk3"],
                     [mx.nd.ones((2,)), mx.nd.ones((2,)) * 3], outs)
        ts = kv_mod.create("teststore")
        o = mx.nd.zeros((3,))
        ts.broadcast("k", [mx.nd.ones((3,)) * 5], o)
        a, b = mx.nd.ones((2,)), mx.nd.ones((2,)) * 4
        ts.pushpull("k", [a, b])
        return [out.asnumpy(), outs[0].asnumpy(), outs[1].asnumpy(),
                o.asnumpy(), a.asnumpy(), b.asnumpy()]
    got = _same(case)
    np.testing.assert_array_equal(got[2], 3.0)
    np.testing.assert_array_equal(got[5], 5.0)


def test_broadcast_multi_key_mismatch_raises():
    for mx, kv_mod in BOTH:
        kv = kv_mod.create("local")
        with pytest.raises(mx.MXNetError):
            kv.broadcast(["mk1", "mk2"], [mx.nd.ones((2,))],
                         [mx.nd.zeros((2,))])


def test_pull_mismatched_out_raises():
    for mx, kv_mod in BOTH:
        kv = kv_mod.create("local")
        kv.init([1, 2, 3], [mx.nd.ones((2,)) for _ in range(3)])
        with pytest.raises(mx.MXNetError):
            kv.pull([1, 2, 3], out=[mx.nd.zeros((2,)), mx.nd.zeros((2,))])
        with pytest.raises(mx.MXNetError):
            kv.pull(9, out=mx.nd.zeros((2,)))


def test_pull_returns_independent_buffer():
    def case(mx, kv_mod):
        kv = kv_mod.create("local")
        kv.init("pw", mx.nd.ones((4, 3)))
        out = mx.nd.zeros((4, 3))
        kv.pull("pw", out=out)
        pulled = kv.pull("pw")
        kv.push("pw", mx.nd.ones((4, 3)) * 3)
        kv.pull("pw", out=mx.nd.zeros((4, 3)))
        return [out.asnumpy(), pulled.asnumpy(), kv.pull("pw").asnumpy()]
    got = _same(case)
    np.testing.assert_array_equal(got[0], 1.0)
    np.testing.assert_array_equal(got[2], 3.0)


def test_identity_and_optimizer_states(tmp_path):
    for mx, kv_mod in BOTH:
        kv = kv_mod.create("device")
        assert (kv.type, kv.rank, kv.num_workers) == ("device", 0, 1)
        assert kv.is_capable("optimizer")
        assert not kv_mod.create("teststore").is_capable("optimizer")
        with pytest.raises(mx.MXNetError):
            kv.save_optimizer_states(str(tmp_path / "none.states"))
        kv.barrier()
    # the states round-trip through the port's Updater
    kv = tkv.create("local")
    kv.set_optimizer(tmx.optimizer.create("sgd", learning_rate=0.1,
                                          momentum=0.9))
    kv.init(0, tmx.nd.ones(SHAPE))
    kv.push(0, tmx.nd.ones(SHAPE))
    kv.save_optimizer_states(str(tmp_path / "kv.states"))
    kv2 = tkv.create("local")
    kv2.set_optimizer(tmx.optimizer.create("sgd", learning_rate=0.1,
                                           momentum=0.9))
    kv2.load_optimizer_states(str(tmp_path / "kv.states"))
    np.testing.assert_allclose(kv2._updater.states[0].numpy(), -0.1,
                               rtol=1e-6)


@pytest.mark.parametrize("name", ["dist_sync", "dist_device_sync",
                                  "dist_tpu_sync", "dist_async",
                                  "dist_tpu_async"])
def test_dist_types_in_one_process_are_local(name):
    """With one process a dist store reduces locally, as the JAX
    package's does (its ``test_dist_async_single_process_is_local``):
    pushes of value lists, an updater, and ``barrier``.  Multi-process
    jobs: ``tests/test_torch_dist_kvstore.py``."""
    def case(mx, kv_mod):
        kv = kv_mod.create(name)
        assert kv.type == name and kv.rank == 0
        kv.init(3, mx.nd.zeros(SHAPE))
        kv.push(3, [mx.nd.array(v) for v in _vals(3, seed=4)])
        summed = kv.pull(3).asnumpy()
        kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1,
                                             momentum=0.9))
        kv.init(KEYS, [mx.nd.array(v) for v in _vals(len(KEYS), seed=5)])
        for g in _vals(2, seed=6):
            kv.push(KEYS, [mx.nd.array(g * k) for k in KEYS])
        outs = [mx.nd.empty(SHAPE) for _ in KEYS]
        kv.pull(KEYS, out=outs)
        kv.barrier()
        if "async" in name:
            kv.sync_all()
        return [summed] + [o.asnumpy() for o in outs]
    _same(case)
    assert tkv.create(name).num_workers == 1


@pytest.mark.parametrize("name", ["dist_sync", "dist_device_sync",
                                  "dist_tpu_sync", "dist_async",
                                  "dist_tpu_async"])
def test_dist_types_raise(name):
    """What the dist stores still refuse: row-sparse pulls (ROADMAP A15);
    an unknown type raises.  Their one-process pushes and pulls:
    ``test_dist_types_in_one_process_are_local``."""
    kv = _init_kv(tmx, tkv, name)
    with pytest.raises(MXNetError, match="A15"):
        kv.row_sparse_pull(3, out=tmx.nd.zeros(SHAPE),
                           row_ids=tmx.nd.array([0.0]))
    with pytest.raises(MXNetError, match="unknown kvstore"):
        tkv.create(name + "_nonesuch")


def test_row_sparse_and_compression_raise():
    """Row-sparse pulls raise (ROADMAP A15); a compression type other than
    2-bit raises in both packages (2-bit: ``test_gradient_compression``)."""
    kv = _init_kv(tmx, tkv)
    with pytest.raises(MXNetError, match="A15"):
        kv.row_sparse_pull(3, out=tmx.nd.zeros(SHAPE),
                           row_ids=tmx.nd.array([0.0]))
    for mx, kv_mod in BOTH:
        with pytest.raises(ValueError, match="1bit"):
            _init_kv(mx, kv_mod).set_gradient_compression({"type": "1bit"})


@pytest.mark.parametrize("name", ["local", "device"])
def test_gradient_compression(name):
    """2-bit compression with error feedback on the merged value, per key,
    with and without an updater, equal to the JAX package's."""
    def case(mx, kv_mod):
        kv = _init_kv(mx, kv_mod, name)
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.25})
        got = []
        for g in _vals(3, seed=8):
            kv.push(3, [mx.nd.array(g * 0.4), mx.nd.array(g * 0.2)])
            got.append(kv.pull(3).asnumpy())
        kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.5))
        for g in _vals(2, seed=9):
            kv.push(KEYS, [mx.nd.array(g * 0.3) for _ in KEYS])
            got += [kv.pull(k).asnumpy() for k in KEYS]
        return got
    got = _same(case)
    assert set(np.unique(got[0])) <= {-0.25, 0.0, 0.25}
