"""Port parity for the pipelined input path, on the CPU: the JAX
package's ``tests/test_io_pipeline.py`` run on the port's
``DevicePrefetchIter(ctx=mx.cpu())``, ``PrefetchingIter`` and
``ImageRecordIter`` (the mesh test stages over a CPU mesh and reshards),
and ``Module.fit(prefetch_to_device=True)`` against the JAX package's
weights after one epoch.

Every producer thread a test starts ends under a bound: the test closes
its iterator, joins the thread with a timeout of JOIN_S seconds and
asserts that it ended.

Tolerance: ``Module.fit`` runs the same SGD steps from the same weights on
the same batches in both packages; the weights agree within 1e-5 of each
tensor's largest |value| (XLA and PyTorch sum products in other orders).
"""
import gc
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import recordio
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.io import (DataBatch, DataIter, DevicePrefetchIter,
                                ImageRecordIter, NDArrayIter, PrefetchingIter)

JOIN_S = 10.0
REL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = mx.set_default_context(mx.cpu())
    yield
    mx.set_default_context(prev)


def _ended(it):
    """Close ``it`` and join its producer thread under a bound."""
    it.close()
    t = it._loop._thread
    if t is not None:
        t.join(timeout=JOIN_S)
        assert not t.is_alive()


def _seq_iter(n=32, d=4, batch=8):
    """An unshuffled iterator whose row i carries the value i."""
    x = np.arange(n * d, dtype=np.float32).reshape(n, d)
    y = np.arange(n, dtype=np.float32)
    return NDArrayIter(x, y, batch_size=batch)


def _prefetch(source, **kw):
    return DevicePrefetchIter(source, ctx=mx.cpu(), **kw)


# ---------------------------------------------------------------------------
# DevicePrefetchIter
# ---------------------------------------------------------------------------
def test_device_prefetch_yields_all_batches_in_order():
    it = _prefetch(_seq_iter(), queue_size=2)
    batches = list(it)
    assert [b.label[0].asnumpy()[0] for b in batches] == [0.0, 8.0, 16.0,
                                                          24.0]
    assert all(b.data[0].context == mx.cpu() for b in batches)
    _ended(it)


def test_device_prefetch_mesh_stages_and_reshards():
    """Over a mesh (given, or the one entered at construction) each batch
    is staged on the mesh's positions' device, the same values; reshard
    retargets the batches staged after it (``staged_by_dp``)."""
    from mxnet_tpu_torch.parallel import DeviceMesh
    cpu = [torch.device("cpu")] * 4
    m4, m2 = DeviceMesh({"dp": 4}, devices=cpu), DeviceMesh({"dp": 2},
                                                             devices=cpu[:2])
    with m4:
        it = _prefetch(_seq_iter(), queue_size=1)
    assert it.mesh is m4
    first = it.next()
    assert first.label[0].asnumpy()[0] == 0.0
    assert first.data[0].context == mx.cpu()
    it.reshard(m2)
    rest = list(it)
    assert [b.label[0].asnumpy()[0] for b in rest] == [8.0, 16.0, 24.0]
    assert it.mesh is m2
    assert set(it.staged_by_dp) == {4, 2} and sum(
        it.staged_by_dp.values()) == 4
    _ended(it)


def test_device_prefetch_wraps_dataloader_style_iterable():
    pairs = [(mx.nd.ones((4, 2)) * i, mx.nd.ones((4,)) * i)
             for i in range(3)]
    it = _prefetch(pairs, queue_size=2)
    got = [float(x.asnumpy()[0, 0]) for x, _ in it]
    assert got == [0.0, 1.0, 2.0]
    it.reset()  # iterables re-iterate per epoch
    assert len(list(it)) == 3
    _ended(it)


def test_device_prefetch_reset_mid_epoch_no_stale_batch():
    """Drain, then restart: after a mid-epoch reset the first batch is
    batch 0 of the new epoch, never one staged for the old one."""
    it = _prefetch(_seq_iter(), queue_size=3)
    assert it.next().label[0].asnumpy()[0] == 0.0
    time.sleep(0.1)  # let the producer stage batches 1..3 ahead
    it.reset()
    assert it.next().label[0].asnumpy()[0] == 0.0
    _ended(it)


class _Slow(DataIter):
    def __init__(self):
        super().__init__(4)
        self.n = 0

    def next(self):
        if self.n >= 3:
            raise StopIteration
        self.n += 1
        time.sleep(0.05)
        return DataBatch([mx.nd.ones((4, 2))], [mx.nd.ones((4,))])

    def reset(self):
        self.n = 0


def test_device_prefetch_starvation_accounting():
    it = _prefetch(_Slow(), queue_size=2)
    n = sum(1 for _ in it)
    stats = it.stats()
    assert n == 3 and stats["batches"] == 3
    assert stats["starved_steps"] >= 1        # the consumer outran it
    assert stats["wait_seconds"] > 0
    assert stats["queue_capacity"] == 2
    assert stats["pinned_bytes"] == 0         # no ring on the CPU
    _ended(it)


def test_device_prefetch_wait_goes_to_input_wait():
    from mxnet_tpu_torch.observability import goodput
    led = goodput.train()
    before = led.totals()["buckets"].get("input_wait", 0.0)
    it = _prefetch(_Slow(), queue_size=2)
    list(it)
    got = led.totals()["buckets"]["input_wait"] - before
    assert abs(got - it.stats()["wait_seconds"]) <= 1e-5
    _ended(it)


def test_device_prefetch_producer_error_reraises_in_consumer():
    class Boom(DataIter):
        def __init__(self):
            super().__init__(4)
            self.n = 0

        def next(self):
            self.n += 1
            if self.n == 2:
                raise RuntimeError("corrupt batch")
            return DataBatch([mx.nd.ones((4, 2))], [mx.nd.ones((4,))])

        def reset(self):
            self.n = 0

    it = _prefetch(Boom(), queue_size=2)
    assert it.next() is not None
    with pytest.raises(RuntimeError, match="corrupt batch"):
        while True:
            it.next()
    _ended(it)


def test_device_prefetch_terminal_states_never_hang():
    """next() after close(), after the end of the epoch, or after a
    delivered producer error raises StopIteration at once."""
    it = _prefetch(_seq_iter(), queue_size=2)
    assert it.next() is not None
    _ended(it)
    with pytest.raises(StopIteration):
        it.next()

    it = _prefetch([(mx.nd.ones((4, 2)), mx.nd.ones((4,)))], queue_size=2)
    assert len(list(it)) == 1
    for _ in range(2):                        # repeated next() past the end
        with pytest.raises(StopIteration):
            it.next()
    _ended(it)

    class Boom(DataIter):
        def __init__(self):
            super().__init__(4)

        def next(self):
            raise RuntimeError("corrupt batch")

        def reset(self):
            pass

    it = _prefetch(Boom(), queue_size=2)
    with pytest.raises(RuntimeError, match="corrupt batch"):
        it.next()
    with pytest.raises(StopIteration):        # retry after the error
        it.next()
    _ended(it)


def test_device_prefetch_first_reset_keeps_staged_batches():
    """A reset with nothing taken since construction is a no-op: the
    staged batches are the stream's head."""
    it = _prefetch(_seq_iter(), queue_size=3)
    time.sleep(0.1)                           # let the producer stage ahead
    staged = it.stats()["queue_depth"]
    it.reset()
    assert it.stats()["queue_depth"] == staged
    firsts = [b.label[0].asnumpy()[0] for b in it]
    assert firsts == [0.0, 8.0, 16.0, 24.0]
    it.reset()                                # a reset after an epoch rewinds
    assert it.next().label[0].asnumpy()[0] == 0.0
    _ended(it)


def test_device_prefetch_one_shot_source():
    gen = ((mx.nd.ones((2,)) * i, mx.nd.ones((2,))) for i in range(3))
    it = _prefetch(gen, queue_size=2)
    it.reset()                                # before any batch: a no-op
    assert float(it.next()[0].asnumpy()[0]) == 0.0
    with pytest.raises(MXNetError, match="one-shot"):
        it.reset()
    _ended(it)


def _toy_module(mx_):
    data = mx_.sym.var("data")
    fc = mx_.sym.FullyConnected(data, mx_.sym.var("fc_weight"),
                                mx_.sym.var("fc_bias"), num_hidden=3,
                                name="fc")
    sym = mx_.sym.SoftmaxOutput(fc, mx_.sym.var("softmax_label"),
                                name="softmax")
    return mx_.module.Module(sym, data_names=("data",),
                             label_names=("softmax_label",))


def _toy_data():
    rng = np.random.RandomState(0)
    X = rng.uniform(-1, 1, size=(60, 10)).astype(np.float32)
    W = rng.uniform(-1, 1, size=(10, 3)).astype(np.float32)
    return X, np.argmax(X @ W, axis=1).astype(np.float32)


def test_module_fit_prefetch_to_device_trains_and_closes():
    """fit(prefetch_to_device=True) trains through the wrapper and closes
    it on exit (the producer stopped, the staged batches dropped)."""
    X, Y = _toy_data()
    mod = _toy_module(mx)
    created = []
    orig_init = DevicePrefetchIter.__init__

    def spy_init(self, *a, **kw):
        orig_init(self, *a, **kw)
        created.append(self)

    DevicePrefetchIter.__init__ = spy_init
    try:
        mod.fit(NDArrayIter(X, Y, batch_size=20), num_epoch=2,
                optimizer="sgd", optimizer_params={"learning_rate": 0.1},
                kvstore="local", prefetch_to_device=True)
    finally:
        DevicePrefetchIter.__init__ = orig_init
    (wrapper,) = created
    assert wrapper.stats()["batches"] == 6     # 3 batches x 2 epochs
    assert wrapper._ctx == mx.cpu()            # the module's context
    assert wrapper._loop.done                  # fit closed its own wrapper
    wrapper._loop._thread.join(timeout=JOIN_S)
    assert not wrapper._loop._thread.is_alive()


def test_module_fit_prefetch_matches_jax():
    """One epoch of fit(prefetch_to_device=True) from the same weights in
    both packages (SGD, momentum 0.9, 'local' kvstore)."""
    X, Y = _toy_data()
    rng = np.random.RandomState(1)
    init = {"fc_weight": rng.randn(3, 10).astype(np.float32) * 0.1,
            "fc_bias": np.zeros(3, np.float32)}
    out = {}
    for side, mx_ in (("jax", jmx), ("port", mx)):
        mod = _toy_module(mx_)
        mod.fit(mx_.io.NDArrayIter(X, Y, batch_size=20), num_epoch=1,
                optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                  "rescale_grad": 1 / 20},
                kvstore="local",
                arg_params={k: mx_.nd.array(v) for k, v in init.items()},
                aux_params={}, prefetch_to_device=True)
        out[side] = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    for k, ref in out["jax"].items():
        got = out["port"][k]
        assert np.abs(got - ref).max() <= REL * np.abs(ref).max(), k
        assert not np.array_equal(got, init[k])


def test_device_prefetch_queue_size_validation_and_env(monkeypatch):
    with pytest.raises(MXNetError):
        _prefetch(_seq_iter(), queue_size=0)
    monkeypatch.setenv("MXNET_IO_DEVICE_QUEUE", "5")
    it = _prefetch(_seq_iter())
    assert it.stats()["queue_capacity"] == 5
    _ended(it)


def test_device_prefetch_metrics_registered_and_move():
    from mxnet_tpu_torch.observability import memory, metrics
    starved = metrics.registry().get("mxnet_tpu_io_starved_steps_total")
    depth = metrics.registry().get("mxnet_tpu_io_device_queue_depth")
    put_s = metrics.registry().get("mxnet_tpu_io_device_put_seconds")
    assert starved is not None and depth is not None and put_s is not None
    c0 = put_s.count
    it = _prefetch(_seq_iter(), queue_size=2)
    list(it)
    assert put_s.count - c0 == 4              # one staging per batch
    assert any(c.startswith("io:device_prefetch:")
               for c in memory.ledger().components())
    _ended(it)


# ---------------------------------------------------------------------------
# PrefetchingIter
# ---------------------------------------------------------------------------
def test_prefetching_iter_reset_mid_epoch_no_stale_batch():
    it = PrefetchingIter(_seq_iter(), capacity=3)
    assert it.next().label[0].asnumpy()[0] == 0.0
    time.sleep(0.1)  # the producer fills the queue with batches 1..3
    it.reset()
    assert it.next().label[0].asnumpy()[0] == 0.0
    rest = [b.label[0].asnumpy()[0] for b in it]
    assert rest == [8.0, 16.0, 24.0]
    _ended(it)


def test_prefetching_iter_producer_error_reraises():
    class Boom(DataIter):
        def __init__(self):
            super().__init__(4)

        def next(self):
            raise ValueError("decode failed")

        def reset(self):
            pass

    it = PrefetchingIter(Boom())
    with pytest.raises(ValueError, match="decode failed"):
        it.next()
    _ended(it)


# ---------------------------------------------------------------------------
# ImageRecordIter's decode pool
# ---------------------------------------------------------------------------
def _write_image_rec(tmp_path, n=12, hw=(24, 24)):
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    rng = np.random.RandomState(1)
    for i in range(n):
        img = (rng.rand(*hw, 3) * 255).astype(np.uint8)
        w.write_idx(i, recordio.pack_img(
            recordio.IRHeader(0, float(i % 10), i, 0), img, img_fmt=".png"))
    w.close()
    return rec, idx


def test_image_record_iter_close_joins_pool(tmp_path):
    rec, idx = _write_image_rec(tmp_path)
    it = ImageRecordIter(path_imgrec=rec, path_imgidx=idx,
                         data_shape=(3, 24, 24), batch_size=4)
    it.next()
    pool = it._pool
    assert pool is not None and not pool._shutdown
    it.close()
    assert pool._shutdown and it._pool is None
    it.close()  # idempotent
    with pytest.raises(StopIteration):
        it.next()
    it.reset()  # a fresh pool
    assert it._pool is not None and it.next() is not None
    it.close()


def test_image_record_iter_context_manager(tmp_path):
    rec, idx = _write_image_rec(tmp_path)
    with ImageRecordIter(path_imgrec=rec, path_imgidx=idx,
                         data_shape=(3, 24, 24), batch_size=4) as it:
        assert it.next() is not None
        pool = it._pool
    assert pool._shutdown


def test_image_record_iter_mid_epoch_error_shuts_pool(tmp_path):
    rec, idx = _write_image_rec(tmp_path)
    it = ImageRecordIter(path_imgrec=rec, path_imgidx=idx,
                         data_shape=(3, 24, 24), batch_size=4)
    it.next()
    pool = it._pool
    orig = it._decode_one

    def bad(s):
        raise OSError("truncated jpeg")

    it._decode_one = bad
    with pytest.raises(OSError):
        it.next()
    assert pool._shutdown and it._pool is None
    it._decode_one = orig
    it.reset()
    assert it.next().data[0].shape == (4, 3, 24, 24)
    it.close()


def test_image_record_iter_del_shuts_pool(tmp_path):
    """An abandoned iterator releases its workers when collected."""
    rec, idx = _write_image_rec(tmp_path)
    it = ImageRecordIter(path_imgrec=rec, path_imgidx=idx,
                         data_shape=(3, 24, 24), batch_size=4)
    it.next()
    pool = it._pool
    del it
    gc.collect()
    assert pool._shutdown
