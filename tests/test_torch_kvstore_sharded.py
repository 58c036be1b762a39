"""Port parity: ZeRO optimizer-state sharding (``mxnet_tpu_torch/kvstore/
sharded.py``, the sharded ``CompiledTrainStep`` and ``Trainer``) against
``tests/test_kvstore_sharded.py``.

The port's mesh positions are 8 CPU devices, the JAX package's its 8
virtual CPU devices.  Port-internal contracts are bitwise: the sharded
push, Trainer, compiled step and ``MultiStepTrainStep`` give the
replicated path's parameters and optimizer states bit for bit.  Against
the JAX package's sharded runs from the same numpy inputs: fp32 within
1e-6 relative (of each tensor's largest |value|), bf16 within one bf16
ulp of that (2^-8).  The JAX oracles are computed once per file.
"""
import contextlib
import math
import os
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import kvstore as jkv
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.parallel import make_mesh as jmake_mesh

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import kvstore as tkv
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.executor import (CompiledTrainStep, MultiStepTrainStep,
                                      stack_batches)
from mxnet_tpu_torch.ndarray.ndarray import NDArray
from mxnet_tpu_torch.parallel import DeviceMesh, collectives as C

CPU8 = [torch.device("cpu")] * 8
SHAPES = [(37,), (16, 3), (5,), (64,), (7, 7)]  # 203 elements: 203 % 8 != 0
TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -8}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@contextlib.contextmanager
def _env(**kw):
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _grads(steps=4, seed=0):
    """Integer-valued gradients: bf16 sums stay exact in any order."""
    rng = np.random.RandomState(seed)
    return [[rng.randint(-4, 5, s).astype(np.float32) for s in SHAPES]
            for _ in range(steps)]


def _nd(a, dtype):
    return NDArray(torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dtype]),
                   tmx.cpu())


def _train_port(shard, dtype="float32", bucket_kb="2", compress=False,
                optimizer="adam", steps=4, **opt_kw):
    """``steps`` batched pushes of 8 replicas each through a dist_tpu_sync
    store with the optimizer on it: ``(store, pulled values)``."""
    with _env(MXNET_KVSTORE_BUCKET_KB=bucket_kb,
              MXNET_KVSTORE_SHARD="1" if shard else "0"), \
            DeviceMesh({"dp": 8}, devices=CPU8):
        kv = tkv.create("dist_tpu_sync")
        if compress:
            kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.set_optimizer(topt.create(optimizer, learning_rate=0.05,
                                     **opt_kw))
        keys = list(range(len(SHAPES)))
        kv.init(keys, [_nd(np.ones(s), dtype) for s in SHAPES])
        for g in _grads(steps):
            kv.push(keys, [[_nd(a, dtype) for _ in range(8)] for a in g],
                    priority=[-k for k in keys])
        return kv, [kv.pull(k)._data.float().numpy() for k in keys]


def _train_jax(dtype, bucket_kb, compress, optimizer="adam", steps=4):
    with _env(MXNET_KVSTORE_BUCKET_KB=bucket_kb, MXNET_KVSTORE_SHARD="1"), \
            jmake_mesh({"dp": 8}):
        kv = jkv.create("dist_tpu_sync")
        if compress:
            kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.set_optimizer(jopt.create(optimizer, learning_rate=0.05))
        keys = list(range(len(SHAPES)))
        kv.init(keys, [jmx.nd.ones(s, dtype=dtype) for s in SHAPES])
        for g in _grads(steps):
            kv.push(keys, [[jmx.nd.array(a, dtype=dtype) for _ in range(8)]
                           for a in g], priority=[-k for k in keys])
        outs = [jmx.nd.empty(s, dtype=dtype) for s in SHAPES]
        kv.pull(keys, out=outs)
        return [np.asarray(o.asnumpy(), np.float32) for o in outs]


PUSH_CASES = [("float32", "2", False), ("float32", "0", False),
              ("float32", "2", True), ("bfloat16", "2", False),
              ("bfloat16", "0", False), ("bfloat16", "2", True)]


@pytest.fixture(scope="module")
def jax_push():
    """The JAX package's sharded pushes: 2 fp32 cases and a bf16 one (the
    other cases' port runs are held to the port's replicated push)."""
    return {case: _train_jax(*case) for case in
            (("float32", "2", False), ("float32", "2", True),
             ("bfloat16", "2", False))}


def _close(got, ref, rel):
    for g, r in zip(got, ref):
        scale = max(float(np.abs(r).max()), 1e-30)
        assert float(np.abs(g - r).max()) <= rel * scale


# ---------------------------------------------------------------- parity
@pytest.mark.parametrize("dtype,bucket_kb,compress", PUSH_CASES)
def test_sharded_push_bitwise_parity(jax_push, dtype, bucket_kb, compress):
    """Scatter → sharded update → gather over 4 Adam steps is bit for bit
    the replicated all-reduce and per-key update, fp32 and bf16, with and
    without bucket fusion and 2-bit compression; and the JAX package's
    sharded push within the stated tolerance."""
    _, rep = _train_port(False, dtype, bucket_kb, compress)
    kv, sh = _train_port(True, dtype, bucket_kb, compress)
    assert kv._shard_engine is not None and kv._shard_engine.dp == 8
    for a, b in zip(rep, sh):
        assert np.array_equal(a, b)
    if (dtype, bucket_kb, compress) in jax_push:
        _close(sh, jax_push[(dtype, bucket_kb, compress)], TOL[dtype])


def test_sharded_sgd_momentum_parity():
    """SGD's momentum shards too (one flat slot buffer)."""
    _, rep = _train_port(False, optimizer="sgd", momentum=0.9)
    kv, sh = _train_port(True, optimizer="sgd", momentum=0.9)
    for a, b in zip(rep, sh):
        assert np.array_equal(a, b)
    (st,) = kv._shard_engine._states.values()
    assert len(st) == 8 and all(isinstance(t, torch.Tensor) for t in st)


def _trainer_run(pkg, shard):
    """4 steps of Trainer on a Dense net under a dp = 8 mesh: the
    parameters (port: ``kvstore="device"``; JAX: ``"dist_tpu_sync"``)."""
    with _env(MXNET_KVSTORE_BUCKET_KB="2"):
        rng = np.random.RandomState(3)
        w = [rng.uniform(-0.3, 0.3, s).astype(np.float32)
             for s in ((16, 10), (16,), (8, 16), (8,))]
        x = rng.randn(4, 10).astype(np.float32)
        if pkg is tmx:
            net = tmx.gluon.nn.HybridSequential()
            with net.name_scope():
                net.add(tmx.gluon.nn.Dense(16, activation="relu", in_units=10,
                                           device="cpu"),
                        tmx.gluon.nn.Dense(8, in_units=16, device="cpu"))
            net.initialize(ctx=tmx.cpu())
            mesh, kind = DeviceMesh({"dp": 8}, devices=CPU8), "device"

            def arr(a):
                return tmx.nd.array(a, ctx=tmx.cpu())
        else:
            net = jmx.gluon.nn.HybridSequential()
            net.add(jmx.gluon.nn.Dense(16, activation="relu", in_units=10),
                    jmx.gluon.nn.Dense(8, in_units=16))
            net.initialize()
            mesh, kind = jmake_mesh({"dp": 8}), "dist_tpu_sync"
            arr = jmx.nd.array
        for p, v in zip(net.collect_params().values(), w):
            p.set_data(arr(v))
        with mesh:
            trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                        {"learning_rate": 0.01}, kvstore=kind,
                                        optimizer_state_sharding=shard)
            xs = arr(x)
            for _ in range(4):
                with pkg.autograd.record():
                    loss = (net(xs) ** 2).sum()
                loss.backward()
                trainer.step(4)
        return ([p.data().asnumpy().copy()
                 for p in net.collect_params().values()], trainer)


def test_trainer_sharded_parity():
    """Trainer(optimizer_state_sharding=True) under a dp = 8 mesh engages
    its store and shards (the engine exists, 1/8 of the slots a
    position), bit for bit the replicated Trainer, and within 1e-6 of the
    JAX package's sharded Trainer."""
    rep, rtr = _trainer_run(tmx, False)
    sh, tr = _trainer_run(tmx, True)
    assert rtr._kvstore is None
    eng = tr._kvstore._shard_engine
    assert eng is not None and eng.dp == 8
    rep_bytes, rank = eng.state_bytes()
    assert rank * 8 == rep_bytes > 0
    for a, b in zip(rep, sh):
        assert np.array_equal(a, b)
    jsh, _ = _trainer_run(jmx, True)
    _close(sh, jsh, TOL["float32"])


def test_trainer_sharding_requires_update_on_kvstore():
    net = tmx.gluon.nn.Dense(4, in_units=4, device="cpu")
    with pytest.raises(ValueError):
        tmx.gluon.Trainer(net.collect_params(), "adam", {},
                          optimizer_state_sharding=True,
                          update_on_kvstore=False)


# ------------------------------------------------------- collective count
def test_collective_count_rs_ag_no_allreduce():
    """Per step: ceil(bytes / bucket) reduce-scatters and as many
    all-gathers through the store's guard, and no all-reduce; the mesh
    collectives count the same."""
    elems, n_keys = 1024, 50
    bucket_bytes = 10 * elems * 4
    expected = math.ceil(n_keys * elems * 4 / bucket_bytes)
    assert expected == 5
    with _env(MXNET_KVSTORE_BUCKET_KB=str(bucket_bytes // 1024),
              MXNET_KVSTORE_SHARD="1"), DeviceMesh({"dp": 8}, devices=CPU8):
        kv = tkv.create("dist_tpu_sync")
        kv.set_optimizer(topt.create("adam", learning_rate=0.05))
        counts = {}
        inner = kv._collective

        def counting(what, fn):
            kind = what.split("(", 1)[0]
            counts[kind] = counts.get(kind, 0) + 1
            return inner(what, fn)

        kv._collective = counting
        keys = list(range(n_keys))
        kv.init(keys, [_nd(np.zeros(elems), "float32") for _ in keys])
        vals = [[_nd(np.ones(elems), "float32") for _ in range(8)]
                for _ in keys]
        C.reset_collective_counts()
        kv.push(keys, vals, priority=[-k for k in keys])
        assert counts == {"reduce_scatter": expected, "all_gather": expected}
        counts.clear()
        kv.push(keys, vals, priority=[-k for k in keys])
        assert counts == {"reduce_scatter": expected, "all_gather": expected}
        got = C.collective_counts()
        assert got["reduce_scatter"] == got["all_gather"] == 2 * expected
        assert got["psum"] == got["pmean"] == 0


# ---------------------------------------------------------- uneven split
def test_uneven_partition_pads_and_splits_back():
    """203 elements over dp = 8 pad to 208: every position holds a shard
    of 26 elements of each slot, and the split back lands every real
    element in its key (bitwise against the replicated push)."""
    kv, sh = _train_port(True)
    _, rep = _train_port(False)
    for a, b in zip(rep, sh):
        assert np.array_equal(a, b)
    eng = kv._shard_engine
    assert eng._states
    for sig, shards in eng._states.items():
        payload = sum(int(np.prod(s)) for _sk, s in sig[1:])
        assert len(shards) == 8
        for leaf in shards[0]:
            assert leaf.numel() * 8 - payload < 8
            assert leaf.numel() == (payload + 7) // 8


def test_per_rank_state_bytes_are_one_nth():
    """The ZeRO accounting: a position's slot bytes are 1/8 of the
    replicated-equivalent (the padding inside both)."""
    from mxnet_tpu_torch.kvstore.sharded import live_accounting
    kv, _ = _train_port(True)
    rep, rank = kv._shard_engine.state_bytes()
    assert rep > 0 and rank == rep // 8
    acc = live_accounting()
    assert acc["state_bytes_per_rank"] >= rank and acc["dp"] == 8


# ------------------------------------------------------------- fallbacks
def test_unsupported_optimizer_warns_and_falls_back():
    """An optimizer without a flat-shard update warns once and takes the
    replicated push: the replicated results."""
    with pytest.warns(UserWarning, match="falling back"):
        _, sh = _train_port(True, optimizer="nag")
    _, rep = _train_port(False, optimizer="nag")
    for a, b in zip(rep, sh):
        assert np.array_equal(a, b)


def test_shard_metrics_exported():
    from mxnet_tpu_torch.observability import metrics
    reg = metrics.registry()
    gauge = reg.get("mxnet_tpu_kvstore_shard_bytes_per_rank")
    scat = reg.get("mxnet_tpu_kvstore_shard_scatter_seconds")
    gath = reg.get("mxnet_tpu_kvstore_shard_gather_seconds")
    assert gauge is not None and scat is not None and gath is not None
    c_s, c_g = scat._one().count, gath._one().count
    _train_port(True, steps=2)
    assert gauge.value > 0
    assert scat._one().count > c_s and gath._one().count > c_g
    from mxnet_tpu_torch.observability import memory
    assert "kvstore:optimizer_shards" in memory.ledger().snapshot()[
        "components"]


# ------------------------------------------------------- compiled / K-step
def _port_step(cls, shard, fuse=False, dtype="float32", **kw):
    rng = np.random.RandomState(5)
    net = torch.nn.Sequential(torch.nn.Linear(10, 16), torch.nn.ReLU(),
                              torch.nn.Linear(16, 8))
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.from_numpy(rng.uniform(-0.3, 0.3, tuple(p.shape))
                                     .astype(np.float32)))
    net = net.to(TDT[dtype])
    step = cls(net, lambda p, t: (p - t).square().mean(dim=1),
               topt.create("adam", learning_rate=1e-2), batch_size=8,
               mesh=DeviceMesh({"dp": 8}, devices=CPU8),
               fuse_grad_buckets=fuse, shard_optimizer_state=shard, **kw)
    return step, net


def _step_data(dtype="float32"):
    rs = np.random.RandomState(2)
    return (torch.from_numpy(rs.randn(8, 10).astype(np.float32)).to(
        TDT[dtype]), torch.from_numpy(rs.randn(8, 8).astype(np.float32)).to(
        TDT[dtype]))


def _states_of(step):
    out = []
    for st in step.optimizer_states():
        out.extend([st] if isinstance(st, torch.Tensor) else list(st))
    return [t.detach().clone() for t in out]


@pytest.fixture(scope="module")
def jax_step_params():
    """The JAX package's sharded step (dp = 8, 4 Adam steps) from the
    port's initial weights: the final parameters."""
    from mxnet_tpu.executor import CompiledTrainStep as JStep
    from mxnet_tpu.parallel import DeviceMesh as JMesh
    _, net = _port_step(CompiledTrainStep, False)
    init = [p.detach().numpy().copy() for p in net.parameters()]
    jnet = jmx.gluon.nn.HybridSequential()
    jnet.add(jmx.gluon.nn.Dense(16, activation="relu", in_units=10),
             jmx.gluon.nn.Dense(8, in_units=16))
    jnet.initialize()
    for p, v in zip(jnet.collect_params().values(), init):
        p.set_data(jmx.nd.array(v))
    with _env(MXNET_KVSTORE_BUCKET_KB="4096"):
        step = JStep(jnet, lambda p, t: ((p - t) ** 2).mean(axis=1),
                     jopt.create("adam", learning_rate=1e-2), batch_size=8,
                     mesh=JMesh({"dp": 8}), shard_optimizer_state=True)
        x, y = _step_data()
        for _ in range(4):
            step(jmx.nd.array(x.numpy()), jmx.nd.array(y.numpy()))
    return [p.data().asnumpy() for p in jnet.collect_params().values()]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fuse", [False, True])
def test_compiled_step_sharded_parity(jax_step_params, dtype, fuse):
    """CompiledTrainStep(shard_optimizer_state=True) is bit for bit the
    replicated step over 4 steps (losses, parameters and optimizer
    states), a position holds 1/8 of the slots, and each step issues one
    reduce-scatter and one all-gather per bucket and no psum; in fp32 the
    parameters are within 1e-6 of the JAX package's sharded step."""
    with _env(MXNET_KVSTORE_BUCKET_KB="1"):
        x, y = _step_data(dtype)
        runs = []
        for shard in (False, True):
            step, net = _port_step(CompiledTrainStep, shard, fuse, dtype)
            C.reset_collective_counts()
            losses = [step(x, y).clone() for _ in range(4)]
            runs.append((losses, [p.detach().clone()
                                  for p in net.parameters()],
                         _states_of(step), step, C.collective_counts()))
    (l0, p0, s0, _, _), (l1, p1, s1, step1, counts) = runs
    assert step1.shard_optimizer_state and step1._zero is not None
    for a, b in zip(l0 + p0 + s0, l1 + p1 + s1):
        assert torch.equal(a, b)
    assert len(s0) == len(s1) == 8
    rep, rank = step1.optimizer_state_bytes()
    assert rep > 0 and rank == rep // 8
    n_buckets = len(step1._zero.buckets)
    assert n_buckets == step1.grad_bucket_count >= 1
    assert counts["reduce_scatter"] == counts["all_gather"] == 4 * n_buckets
    assert counts["psum"] == 0 and counts["pmean"] == 4
    if dtype == "float32":
        _close([p.numpy() for p in p1], jax_step_params, TOL["float32"])


@pytest.mark.parametrize("fuse", [False, True])
def test_multistep_sharded_parity(fuse):
    """K = 4 steps per call on a dp = 8 mesh, sharded and not: bit for
    bit each other and 4 single steps of their kind; the
    states stay 1/8 a position between calls, and a second call goes
    on from them."""
    x, y = _step_data()
    xs, ys = stack_batches([(x, y)] * 4)
    out = {}
    for shard in (False, True):
        step, net = _port_step(MultiStepTrainStep, shard, fuse,
                               steps_per_call=4)
        losses = step(xs, ys).clone()
        out[shard] = (losses, [p.detach().clone() for p in net.parameters()],
                      _states_of(step), step)
    (l0, p0, s0, _), (l1, p1, s1, stepm) = out[False], out[True]
    assert torch.equal(l0, l1)
    for a, b in zip(p0 + s0, p1 + s1):
        assert torch.equal(a, b)
    for shard, ref in ((True, p1), (False, p0)):
        single, net1 = _port_step(CompiledTrainStep, shard, fuse)
        for _ in range(4):
            single(x, y)
        for a, b in zip(ref, net1.parameters()):
            assert torch.equal(a, b)
    rep, rank = stepm.optimizer_state_bytes()
    assert rep > 0 and rank == rep // 8
    # a second K-group continues from the sharded states, still bitwise
    out[True][3](xs, ys)
    rep_step = out[False][3]
    rep_step(xs, ys)
    for a, b in zip(_states_of(rep_step), _states_of(out[True][3])):
        assert torch.equal(a, b)


def test_unsupported_optimizer_step_warns_and_stays_replicated():
    """A step whose optimizer has no flat update keeps its states
    replicated (one warning), the replicated results."""
    net = torch.nn.Linear(4, 3)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        step = CompiledTrainStep(net, lambda p, t: (p - t).square().mean(1),
                                 topt.create("nag", learning_rate=0.1,
                                             momentum=0.9),
                                 mesh=DeviceMesh({"dp": 2},
                                                 devices=CPU8[:2]),
                                 shard_optimizer_state=True)
    assert step._zero is None
    assert any("no flat-shard update" in str(w.message) for w in caught)
    rep, rank = step.optimizer_state_bytes()
    assert rep == rank > 0


# ----------------------------------------------------------- collectives
def test_reduce_scatter_flat_matches_allreduce_slices():
    """The primitive layer: reduce_scatter_flat's shards joined are
    allreduce_flat's result bit for bit, and a single buffer (the sum
    already taken) is split where it is and counted as one
    reduce-scatter."""
    mesh = DeviceMesh({"dp": 8}, devices=CPU8)
    rng = np.random.RandomState(0)
    flats = [torch.from_numpy(rng.randn(48).astype(np.float32))
             for _ in range(8)]
    want = C.allreduce_flat(flats)
    scat = C.reduce_scatter_flat(flats, mesh=mesh)
    assert len(scat) == 8 and scat[0].numel() == 6
    assert torch.equal(C.all_gather_flat(scat, mesh=mesh), want)
    C.reset_collective_counts()
    one = C.reduce_scatter_flat([flats[0]], mesh=mesh)
    assert torch.equal(torch.cat(one), flats[0])
    assert C.collective_counts()["reduce_scatter"] == 1
