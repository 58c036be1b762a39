"""Worker of the port's multi-process kvstore test (``tests/
test_torch_dist_kvstore.py``); it has no tests of its own.  Run it as a
job of N processes on the CPU over gloo:

    python tools/launch.py -n N python tests/test_torch_dist_worker.py ORACLE.npz

It holds ``mxnet_tpu_torch``'s dist kvstores to the reference worker's
contract (``tests/dist_sync_worker.py``, from the reference's
``tests/nightly/dist_sync_kvstore.py``): init from rank 0; every rank
pushes ``rank + 1`` to a dense fp32 key and pulls the sum; repeated
rounds; fp16; the big (600, 700) key.  Its row-sparse cases wait for the
row-sparse arrays (ROADMAP A15) and are not run.  Then a list-form
bucketed push against the per-key push (integer values, equal bit for
bit, one collective per bucket), ``dist_async`` diverging and averaging
at its interval and at ``sync_all``, and a ``gluon.Trainer`` step and a
``Module.fit`` step over ``dist_sync`` against the JAX package's oracle in
``ORACLE.npz`` (see the test for how it is made).  Every rank prints
``[rank r] port dist kvstore OK`` when all of it held; a failure exits 1.
"""
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

SHAPE = (4, 5)
BIG = (600, 700)


def _close(got, want, nproc, what):
    """Bit for bit with two processes; within 1e-6 relative with more (a
    ring all-reduce adds in another order than the pairwise sum)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got,
                                                                 want)
    if nproc <= 2:
        assert np.array_equal(got, want), (what, np.abs(got - want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=what)


def check_contract(mx, rank, nproc):
    kv = mx.kv.create("dist_sync")
    assert kv.rank == rank and kv.num_workers == nproc

    # rank 0's init reaches every rank
    kv.init("init_bcast", mx.nd.ones(SHAPE) * (rank + 10))
    np.testing.assert_array_equal(kv.pull("init_bcast").asnumpy(), 10.0)

    # dense fp32: every rank pushes rank + 1 and pulls the sum
    kv.init("3", mx.nd.ones(SHAPE))
    kv.push("3", mx.nd.ones(SHAPE) * (rank + 1))
    np.testing.assert_array_equal(kv.pull("3").asnumpy(),
                                  sum(range(1, nproc + 1)))

    # repeated rounds: with no updater a push replaces the stored value
    for _ in range(3):
        kv.push("3", mx.nd.ones(SHAPE))
        out = mx.nd.zeros(SHAPE)
        kv.pull("3", out=out)
    np.testing.assert_array_equal(out.asnumpy(), float(nproc))

    # a value list per rank: summed locally, then across ranks
    kv.push("3", [mx.nd.ones(SHAPE), mx.nd.ones(SHAPE) * 2])
    np.testing.assert_array_equal(kv.pull("3").asnumpy(), 3.0 * nproc)

    # fp16
    kv.init("fp16", mx.nd.zeros(SHAPE, dtype="float16"))
    kv.push("fp16", mx.nd.ones(SHAPE, dtype="float16"))
    out = kv.pull("fp16")
    assert out.dtype == np.float16, out.dtype
    np.testing.assert_array_equal(out.asnumpy(), float(nproc))

    # the big key (the reference's ps-lite split it across servers)
    kv.init("99", mx.nd.zeros(BIG))
    kv.push("99", mx.nd.ones(BIG))
    np.testing.assert_array_equal(kv.pull("99").asnumpy(), float(nproc))

    # row_sparse pushes and row_sparse_pull: not run until the row-sparse
    # arrays are ported (ROADMAP A15)
    kv.barrier()
    assert kv._rounds_completed["barrier"] == 1


def check_bucketed(mx, rank, nproc):
    """A list-form push through 1 KiB buckets equals the per-key push bit
    for bit (integer values, so any order of addition is exact), with one
    collective per bucket and one bucket per dtype group at least."""
    keys = list(range(12))
    shapes = [(64,)] * 10 + [(8, 4)] * 2          # 256 B fp32, 64 B bf16
    dtypes = ["float32"] * 10 + ["bfloat16"] * 2
    expected_buckets = math.ceil(10 * 256 / 1024) + 1
    got = {}
    for cap in ("1", "0"):
        os.environ["MXNET_KVSTORE_BUCKET_KB"] = cap
        kv = mx.kv.create("dist_sync")
        kv.init(keys, [mx.nd.zeros(s, dtype=d) for s, d in zip(shapes, dtypes)])
        vals = [mx.nd.ones(s, dtype=d) * ((k + rank) % 5 + 1)
                for k, s, d in zip(keys, shapes, dtypes)]
        outs = [mx.nd.zeros(s, dtype=d) for s, d in zip(shapes, dtypes)]
        kv.pushpull(keys, vals, out=outs, priority=[-k for k in keys])
        got[cap] = [o.asnumpy() for o in outs]
        rounds = kv._rounds_completed["allreduce"]
        if cap == "1":
            assert rounds == expected_buckets, rounds
            assert (kv.keys_staged, kv.buckets_issued) == (12, rounds)
        else:
            assert rounds == len(keys) and kv.buckets_issued == 0, rounds
    del os.environ["MXNET_KVSTORE_BUCKET_KB"]
    for k, (b, p) in enumerate(zip(got["1"], got["0"])):
        want = sum((k + r) % 5 + 1 for r in range(nproc))
        assert b.dtype == p.dtype and np.array_equal(b, p), k
        np.testing.assert_array_equal(b.astype(np.float32), want)


def check_async(mx, rank, nproc):
    """Pushes apply locally; every 4 pushes a key is averaged; sync_all
    averages every key (the JAX package's ``tests/async_worker.py``)."""
    os.environ["MXNET_ASYNC_SYNC_INTERVAL"] = "4"
    kv = mx.kv.create("dist_async")
    assert kv.rank == rank and kv.num_workers == nproc
    assert kv._fuse_dense_push is False
    shape = (4, 3)
    kv.init("w0", mx.nd.ones(shape) * (rank + 10))
    np.testing.assert_array_equal(kv.pull("w0").asnumpy(), 10.0)
    kv.init("w", mx.nd.zeros(shape))
    for _ in range(3):
        kv.push("w", mx.nd.ones(shape) * (rank + 1))
    np.testing.assert_array_equal(kv.pull("w").asnumpy(), float(rank + 1))
    kv.push("w", mx.nd.ones(shape) * (rank + 1))   # the 4th: averaged
    mean = sum(range(1, nproc + 1)) / nproc
    np.testing.assert_allclose(kv.pull("w").asnumpy(), mean, rtol=1e-6)
    kv.push("w", mx.nd.ones(shape) * (rank + 1))
    np.testing.assert_array_equal(kv.pull("w").asnumpy(), float(rank + 1))
    kv.sync_all()
    np.testing.assert_allclose(kv.pull("w").asnumpy(), mean, rtol=1e-6)
    assert kv._rounds_completed["average"] == 1 + 2   # the 4th push, 2 keys

    # with an updater the pushes accumulate locally, and sync_all mixes them
    os.environ["MXNET_ASYNC_SYNC_INTERVAL"] = "100"
    kv2 = mx.kv.create("dist_async")
    kv2.set_optimizer(mx.optimizer.create("sgd", learning_rate=1.0))
    kv2.init(0, mx.nd.zeros(shape))
    kv2.push([0], [mx.nd.ones(shape) * (rank + 1)])
    kv2.push(0, mx.nd.ones(shape) * (rank + 1))
    np.testing.assert_array_equal(kv2.pull(0).asnumpy(), -2.0 * (rank + 1))
    kv2.sync_all()
    np.testing.assert_allclose(kv2.pull(0).asnumpy(),
                               -2.0 * sum(range(1, nproc + 1)) / nproc,
                               rtol=1e-6)
    del os.environ["MXNET_ASYNC_SYNC_INTERVAL"]


def check_trainer(mx, rank, nproc, oracle):
    """Two ``Trainer.step``s over dist_sync from rank-divergent weights
    with the oracle's per-rank gradients, the update on the store and
    off it: every rank holds what the JAX package's 'device' kvstore
    pulls after pushing the N ranks' gradients as one list per key."""
    from mxnet_tpu_torch import gluon
    names = [str(n) for n in oracle["trainer_names"]]
    steps = int(oracle["trainer_steps"])
    batch = int(oracle["trainer_batch"])
    opt = {"learning_rate": float(oracle["trainer_lr"]),
           "momentum": float(oracle["trainer_momentum"]),
           "wd": float(oracle["trainer_wd"])}
    for on_kv in (True, False):
        params = gluon.ParameterDict("t_")
        for k, n in enumerate(names):
            w0 = oracle[f"trainer_w0_{k}"]
            p = params.get(n, shape=w0.shape)
            p.initialize(ctx=mx.cpu())
            p.set_data(mx.nd.array(w0 + rank))      # rank 0's value wins
        trainer = gluon.Trainer(params, "sgd", opt, kvstore="dist_sync",
                                update_on_kvstore=on_kv)
        plist = list(params.values())
        for s in range(steps):
            for k, p in enumerate(plist):
                p.grad()[:] = mx.nd.array(oracle[f"trainer_g_{s}_{rank}_{k}"])
            trainer.step(batch)
        assert trainer._kvstore is not None
        assert trainer._kvstore.buckets_issued == steps   # 4 small keys
        for k, p in enumerate(plist):
            _close(p.data().asnumpy(), oracle[f"trainer_want_{k}"], nproc,
                   f"trainer update_on_kvstore={on_kv} {names[k]}")


def check_module(mx, rank, nproc, oracle):
    """``Module.fit`` over dist_sync, two batches per rank, a linear
    regression on integer data (every gradient exact in both packages),
    from rank-divergent weights: every rank ends where the oracle does."""
    x, y = oracle[f"module_x_{rank}"], oracle[f"module_y_{rank}"]
    batch = int(oracle["module_batch"])
    data = mx.sym.var("data")
    fc = mx.sym.FullyConnected(data, num_hidden=y.shape[1], name="fc")
    sym = mx.sym.LinearRegressionOutput(fc, mx.sym.var("lro_label"),
                                        name="lro")
    it = mx.io.NDArrayIter(x, y, batch_size=batch, label_name="lro_label")
    mod = mx.module.Module(sym, label_names=("lro_label",), context=mx.cpu())
    arg = {n: mx.nd.array(oracle[f"module_w0_{n}"] + rank)
           for n in ("fc_weight", "fc_bias")}
    mod.fit(it, num_epoch=1, kvstore="dist_sync", optimizer="sgd",
            optimizer_params={"learning_rate": float(oracle["module_lr"]),
                              "momentum": float(oracle["module_momentum"])},
            arg_params=arg, aux_params={}, eval_metric="mse")
    assert mod._kvstore.type == "dist_sync"
    assert mod._kvstore._rounds_completed["allreduce"] == 2 * 2
    got = mod.get_params()[0]
    for n in ("fc_weight", "fc_bias"):
        _close(got[n].asnumpy(), oracle[f"module_want_{n}"], nproc,
               f"module {n}")


def main(oracle_path):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import distributed
    mx.set_default_context(mx.cpu())
    distributed.initialize()
    try:
        rank, nproc = distributed.process_index(), distributed.process_count()
        assert nproc == int(os.environ["MXNET_DIST_NUM_PROCESSES"]) > 1
        assert distributed.is_initialized()
        check_contract(mx, rank, nproc)
        check_bucketed(mx, rank, nproc)
        check_async(mx, rank, nproc)
        oracle = np.load(oracle_path)
        check_trainer(mx, rank, nproc, oracle)
        check_module(mx, rank, nproc, oracle)
        distributed.barrier()
    finally:
        distributed.finalize()
    assert not distributed.is_initialized()
    print(f"[rank {rank}] port dist kvstore OK", flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
