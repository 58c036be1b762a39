"""Port parity: ``mxnet_tpu_torch.resilience.training``, the Trainer's
``snapshot``/``execute`` fault site, the dist kvstore's collective guard
and the train goodput record, on CPU tensors, held against the JAX
package.

Each case builds the same net in both packages (the port's weights copied
from one numpy draw), runs the same ``FaultPlan`` script through each, and
compares: final parameters within 1e-6 relative, and replay counts, faults
injected, exception types, post-mortem keys and bucket names exactly.
Where the two random streams cannot match (a Dropout), the JAX leg runs
with dropout off and the port is held against its own fault-free run, bit
for bit.

From ``tests/test_resilience.py``'s ``TestResumeOnFault``: a
``FaultTolerantStep`` under transient ``execute`` faults (the inner retry
ladder exhausted, the outer replay restoring its copy) ends where the
fault-free run ends; a Trainer step that dies mid-update (the ``execute``
site fires once per parameter) is rewound by ``snapshot().restore()``,
and a batch loop that replays from the snapshot equals the fault-free
loop, dropout masks included, whether the Dropout draws from the device's
stream or from a generator of its own.  From its ``TestKVStoreTimeout``:
a hung ``allreduce`` raises ``RankFailureError`` within
``MXNET_KVSTORE_TIMEOUT`` naming the collective, with this rank's progress
in the post-mortem.  From ``tests/test_goodput.py``: a step record's
buckets sum to its wall.  The port's snapshots are device copies restored
in place: no tensor moves.
"""
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import optimizer as jopt
from mxnet_tpu import resilience as jrs
from mxnet_tpu.executor import CompiledTrainStep as JaxTrainStep
from mxnet_tpu.gluon import Trainer as JaxTrainer
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.loss import L2Loss as JaxL2

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch import optimizer as opt
from mxnet_tpu_torch import resilience as rs
from mxnet_tpu_torch.executor import CompiledTrainStep
from mxnet_tpu_torch.gluon import Trainer, nn
from mxnet_tpu_torch.gluon.loss import L2Loss
from mxnet_tpu_torch.observability import goodput
from mxnet_tpu_torch.resilience import (FaultInjected, FaultPlan,
                                        FaultTolerantStep, RankFailureError,
                                        counters)

REL = 1e-6


@pytest.fixture(autouse=True)
def _fresh_backend(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_RETRY_BACKOFF", "0.001")
    rs.reset_backend_state()
    jrs.reset_backend_state()
    prev = mx.set_default_context(mx.cpu())
    yield
    mx.set_default_context(prev)
    rs.reset_backend_state()
    jrs.reset_backend_state()


def _weights(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.uniform(-0.5, 0.5, s).astype(np.float32)
            for s in ((4, 3), (4,), (1, 4), (1,))]


def _data():
    x = np.random.RandomState(7).uniform(size=(8, 3)).astype(np.float32)
    y = np.random.RandomState(8).uniform(size=(8, 1)).astype(np.float32)
    return x, y


def _train_setup(seed=0, dropout=0.0, rng="module"):
    """Dense(4) -> [Dropout] -> Dense(1) on seeded weights and data; with
    ``rng="device"`` the Dropout draws from the device's stream (the Gluon
    boundary's), with ``"module"`` from a generator of its own."""
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(4, in_units=3, device="cpu"))
        if dropout:
            gen = (None if rng == "device"
                   else mx.random.generator(seed + 5, "cpu"))
            net.add(nn.Dropout(dropout, generator=gen))
        net.add(nn.Dense(1, in_units=4, device="cpu"))
    with torch.no_grad():
        for t, w in zip(net.parameters(), _weights(seed)):
            t.copy_(torch.from_numpy(w))
    x, y = _data()
    return net, x, y


def _jax_setup(seed=0):
    """The JAX twin of :func:`_train_setup` with dropout off."""
    net = jnn.HybridSequential()
    with net.name_scope():
        net.add(jnn.Dense(4, in_units=3), jnn.Dense(1, in_units=4))
    net.collect_params().initialize()
    for p, w in zip(net.collect_params().values(), _weights(seed)):
        p.set_data(jmx.nd.array(w))
    x, y = _data()
    return net, jmx.nd.array(x), jmx.nd.array(y)


def _params(net):
    return [t.detach().clone() for t in net.state_dict().values()]


def _jparams(jnet):
    return [p.data().asnumpy() for p in jnet.collect_params().values()]


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))


def _close(got, ref, what=""):
    """Port tensors against JAX arrays, within 1e-6 of each one's scale."""
    assert len(got) == len(ref), what
    for i, (g, r) in enumerate(zip(got, ref)):
        g = g.numpy().astype(np.float64)
        r = np.asarray(r, np.float64)
        assert g.shape == r.shape, (what, i)
        bound = REL * max(float(np.abs(r).max()), 1e-30)
        err = float(np.abs(g - r).max())
        assert err <= bound, f"{what}[{i}]: max err {err} > {bound}"


def _step(net):
    return CompiledTrainStep(net, L2Loss(),
                             opt.create("sgd", learning_rate=0.1,
                                        momentum=0.9))


def _jax_step(jnet, x):
    jnet(x)
    return JaxTrainStep(jnet, JaxL2(),
                        jopt.create("sgd", learning_rate=0.1, momentum=0.9))


_REPLAY_PLAN = {"execute": ["ok", "ok", "unavailable", "unavailable",
                            "unavailable"]}


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_fault_tolerant_step_bitwise(monkeypatch, dropout):
    """Three transient faults at step 3: the inner ladder (2 attempts)
    exhausts into BackendUnavailableError, the outer replay recovers."""
    monkeypatch.setenv("MXNET_TPU_RETRY_MAX", "2")
    net1, x, y = _train_setup(dropout=dropout)
    s1 = _step(net1)
    for _ in range(4):
        s1(torch.from_numpy(x), torch.from_numpy(y))
    clean = _params(net1)

    rs.reset_backend_state()
    net2, x, y = _train_setup(dropout=dropout)
    s2 = _step(net2)
    ft = FaultTolerantStep(s2)
    ptrs = [t.data_ptr() for t in net2.state_dict().values()]
    with FaultPlan(_REPLAY_PLAN):
        for _ in range(4):
            ft(torch.from_numpy(x), torch.from_numpy(y))
    assert counters.replays == 1
    assert s2._num_update == 4 and ft._num_update == 4
    assert s2._opt.num_update == 4
    assert _equal(_params(net2), clean)
    assert [t.data_ptr() for t in net2.state_dict().values()] == ptrs
    if dropout:
        return   # the two packages' dropout streams differ
    jnet, jx, jy = _jax_setup()
    jft = jrs.FaultTolerantStep(_jax_step(jnet, jx))
    with jrs.FaultPlan(_REPLAY_PLAN):
        for _ in range(4):
            jft(jx, jy)
    assert (jrs.counters.replays, jrs.counters.faults_injected) == \
        (counters.replays, counters.faults_injected) == (1, 3)
    assert jft._num_update == ft._num_update
    _close(_params(net2), _jparams(jnet), "params")


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_fault_tolerant_step_restores_a_half_applied_world(dropout):
    """The replay restores what a failed call changed: parameters,
    optimizer states and counts, and the dropout stream."""
    net, x, y = _train_setup(dropout=dropout)
    step = _step(net)
    ft = FaultTolerantStep(step)
    ft(torch.from_numpy(x), torch.from_numpy(y))
    snap = ft._capture()
    before = _params(net)
    gen = net[1].generator if dropout else None
    state = gen.get_state() if dropout else None
    step(torch.from_numpy(x), torch.from_numpy(y))
    moved = _params(net)
    assert not _equal(moved, before)
    ft._restore(snap)
    assert _equal(_params(net), before)
    if dropout:
        assert torch.equal(gen.get_state(), state)
    assert step._num_update == 1 and step._opt.num_update == 1
    assert counters.replays == 1
    if dropout:
        return
    jnet, jx, jy = _jax_setup()
    js = _jax_step(jnet, jx)
    jft = jrs.FaultTolerantStep(js)
    jft(jx, jy)
    jsnap = jft._capture()
    _close(before, _jparams(jnet), "before")
    js(jx, jy)
    _close(moved, _jparams(jnet), "after the step")
    jft._restore(jsnap)
    _close(_params(net), _jparams(jnet), "restored")
    assert js._num_update == step._num_update
    assert jrs.counters.replays == counters.replays


def test_fault_tolerant_step_exhausted_and_fatal(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_RETRY_MAX", "1")
    net, x, y = _train_setup()
    jnet, jx, jy = _jax_setup()
    legs = ((FaultTolerantStep(_step(net), max_replays=1), FaultPlan,
             counters, torch.from_numpy(x), torch.from_numpy(y)),
            (jrs.FaultTolerantStep(_jax_step(jnet, jx), max_replays=1),
             jrs.FaultPlan, jrs.counters, jx, jy))
    raised = []
    for ft, plan, cnt, a, b in legs:
        with plan({"execute": "unavailable*10"}):
            with pytest.raises(Exception) as e1:
                ft(a, b)
        after_exhausted = cnt.replays
        with plan({"execute": ["fatal"]}):
            with pytest.raises(Exception) as e2:
                ft(a, b)
        raised.append((type(e1.value).__name__, type(e2.value).__name__,
                       after_exhausted, cnt.replays))
    assert raised[0] == raised[1] == (
        "BackendUnavailableError", "FaultInjected", 1, 1)
    _close(_params(net), _jparams(jnet), "params")


def _backward(net, x, y):
    with autograd.record():
        loss = L2Loss()(net(mx.nd.array(x)), mx.nd.array(y))
    loss.backward()


def _jax_backward(jnet, x, y):
    with jmx.autograd.record():
        loss = JaxL2()(jnet(x), y)
    loss.backward()


def test_trainer_snapshot_restores_partial_update():
    net, x, y = _train_setup()
    trainer = Trainer(net.collect_params(), "sgd",
                      {"learning_rate": 0.1, "momentum": 0.9}, kvstore=None)
    _backward(net, x, y)
    snap = trainer.snapshot()
    before = _params(net)
    with FaultPlan({"execute": ["ok", "ok", "unavailable"]}):
        with pytest.raises(FaultInjected):
            trainer.step(8)   # dies mid-loop: two parameters updated
    after = _params(net)
    assert not torch.equal(after[0], before[0])
    assert torch.equal(after[3], before[3])
    snap.restore()
    assert _equal(_params(net), before)
    assert trainer._optimizer.num_update == 0
    assert trainer._updaters[0].states == {}
    assert counters.replays == 1

    jnet, jx, jy = _jax_setup()
    jtrainer = JaxTrainer(jnet.collect_params(), "sgd",
                          {"learning_rate": 0.1, "momentum": 0.9},
                          kvstore=None)
    _jax_backward(jnet, jx, jy)
    jsnap = jtrainer.snapshot()
    with jrs.FaultPlan({"execute": ["ok", "ok", "unavailable"]}):
        with pytest.raises(jrs.FaultInjected):
            jtrainer.step(8)
    jafter = _jparams(jnet)
    _close(after, jafter, "half-applied")
    assert [torch.equal(a, b) for a, b in zip(after, before)] == \
        [bool(np.array_equal(a, b.numpy())) for a, b in zip(jafter, before)]
    jsnap.restore()
    _close(_params(net), _jparams(jnet), "restored")
    assert jtrainer._optimizer.num_update == trainer._optimizer.num_update
    assert (jrs.counters.replays, jrs.counters.faults_injected) == \
        (counters.replays, counters.faults_injected)


_LOOP_PLAN = {"execute": ["ok", "unavailable", "ok", "ok", "ok", "ok",
                          "ok", "ok", "unavailable"]}


def _replay_loop(snapshot, fwd_bwd, step, faulted, plan):
    """Three batches, each snapshotted first and replayed (forward,
    backward and update again) on a transient fault."""
    with plan(_LOOP_PLAN if faulted else {}):
        for _ in range(3):
            snap = snapshot()
            for attempt in range(3):
                try:
                    fwd_bwd()
                    step(8)
                    break
                except Exception as e:  # noqa: BLE001 - checked below
                    assert getattr(e, "transient", False) and attempt < 2
                    snap.restore()


@pytest.mark.parametrize("rng", ["off", "device", "module"])
def test_trainer_replay_loop_is_bitwise_with_dropout(rng):
    """A batch loop that replays from the snapshot equals the fault-free
    loop bit for bit, the dropout masks too: the snapshot rewinds the
    device's stream and the Dropout's own generator.  Dropout off, it
    ends where the JAX Trainer's replay loop ends."""
    def run(faulted):
        net, x, y = _train_setup(dropout=0.0 if rng == "off" else 0.5,
                                 rng=rng)
        mx.random.seed(3)
        trainer = Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1, "momentum": 0.9},
                          kvstore=None)
        _replay_loop(trainer.snapshot, lambda: _backward(net, x, y),
                     trainer.step, faulted, FaultPlan)
        return _params(net)

    clean = run(False)
    n0 = counters.replays
    faulted = run(True)
    assert counters.replays - n0 == 2
    assert _equal(faulted, clean)
    if rng != "off":
        return
    jnet, jx, jy = _jax_setup()
    jtrainer = JaxTrainer(jnet.collect_params(), "sgd",
                          {"learning_rate": 0.1, "momentum": 0.9},
                          kvstore=None)
    _replay_loop(jtrainer.snapshot, lambda: _jax_backward(jnet, jx, jy),
                 jtrainer.step, True, jrs.FaultPlan)
    assert jrs.counters.replays == 2
    _close(faulted, _jparams(jnet), "params")


def test_trainer_snapshot_rewinds_the_kvstore():
    def stored(kv):
        return [np.asarray(kv._store[k].asnumpy()) for k in sorted(kv._store)]

    net, x, y = _train_setup()
    kv = mx.kv.create("device")
    kv.force_use = True
    trainer = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                      kvstore=kv, update_on_kvstore=True)
    _backward(net, x, y)
    trainer.step(8)
    _backward(net, x, y)
    snap = trainer.snapshot()
    saved = {k: v._data.clone() for k, v in kv._store.items()}
    before = _params(net)
    with FaultPlan({"execute": ["ok", "unavailable"]}):
        with pytest.raises(FaultInjected):
            trainer.step(8)
    torn = stored(kv)
    assert any(not torch.equal(v._data, saved[k])
               for k, v in kv._store.items())
    snap.restore()
    assert all(torch.equal(v._data, saved[k]) for k, v in kv._store.items())
    assert _equal(_params(net), before)

    jnet, jx, jy = _jax_setup()
    jkv = jmx.kv.create("device")
    jkv.force_use = True
    jtrainer = JaxTrainer(jnet.collect_params(), "sgd",
                          {"learning_rate": 0.1}, kvstore=jkv,
                          update_on_kvstore=True)
    _jax_backward(jnet, jx, jy)
    jtrainer.step(8)
    _jax_backward(jnet, jx, jy)
    jsnap = jtrainer.snapshot()
    with jrs.FaultPlan({"execute": ["ok", "unavailable"]}):
        with pytest.raises(jrs.FaultInjected):
            jtrainer.step(8)
    assert sorted(jkv._store) == sorted(kv._store)
    _close([torch.from_numpy(a) for a in torn], stored(jkv), "torn store")
    jsnap.restore()
    _close([v._data for _, v in sorted(kv._store.items())], stored(jkv),
           "restored store")
    _close(_params(net), _jparams(jnet), "params")


# ===========================================================================
# the dist kvstore's collective guard
# ===========================================================================
def _hung_push(kvstore, nd, plan, recorder):
    """One completed round, then a push whose allreduce hangs: (the error,
    the seconds it took, the post-mortem)."""
    kv = kvstore.create("dist_sync")
    kv.init("w", nd.zeros((2, 2)))
    kv.push("w", nd.ones((2, 2)))
    t0 = time.monotonic()
    with plan({"allreduce": ["hang:10"]}):
        with pytest.raises(Exception) as ei:
            kv.push("w", nd.ones((2, 2)))
    seconds = time.monotonic() - t0
    crash = recorder.get().last_crash
    kv.push("w", nd.ones((2, 2)))          # the store survives
    np.testing.assert_allclose(kv.pull("w").asnumpy(), np.ones((2, 2)))
    return ei.value, seconds, crash


def test_hung_allreduce_raises_rank_failure_within_timeout(monkeypatch):
    from mxnet_tpu.observability import flight_recorder as jfr
    from mxnet_tpu_torch.observability import flight_recorder
    monkeypatch.setenv("MXNET_KVSTORE_TIMEOUT", "0.5")
    monkeypatch.setattr(flight_recorder.get(), "_last_auto_dump", (None, 0.0))
    monkeypatch.setattr(jfr.get(), "_last_auto_dump", ("", 0.0))
    err, seconds, crash = _hung_push(mx.kv, mx.nd, FaultPlan, flight_recorder)
    jerr, jseconds, jcrash = _hung_push(jmx.kv, jmx.nd, jrs.FaultPlan, jfr)
    assert isinstance(err, RankFailureError)
    assert type(jerr).__name__ == type(err).__name__
    assert seconds < 5 and jseconds < 5
    for e in (err, jerr):
        assert "allreduce" in str(e) and "'w'" in str(e)
    assert sorted(crash) == sorted(jcrash)
    ctx, jctx = crash["context"], jcrash["context"]
    assert sorted(ctx) == sorted(jctx)
    for k in ("kind", "collective", "rank", "nproc", "rounds_completed"):
        assert ctx[k] == jctx[k], k
    assert ctx["rounds_completed"] == {"allreduce": 1}
    assert crash["exception"]["type"] == jcrash["exception"]["type"] \
        == "RankFailureError"
    assert crash["exception"]["site"] == jcrash["exception"]["site"]


def test_barrier_timeout_and_fault_site(monkeypatch):
    raised = []
    for kvstore, nd, plan in ((mx.kv, mx.nd, FaultPlan),
                              (jmx.kv, jmx.nd, jrs.FaultPlan)):
        monkeypatch.setenv("MXNET_KVSTORE_TIMEOUT", "0.5")
        kv = kvstore.create("dist_sync")
        with plan({"allreduce": ["hang:10"]}):
            with pytest.raises(Exception, match="barrier") as e1:
                kv.barrier()
        monkeypatch.setenv("MXNET_KVSTORE_TIMEOUT", "0")
        kv.init("k", nd.zeros((2,)))
        with plan({"allreduce": ["fatal"]}):
            with pytest.raises(Exception) as e2:
                kv.push("k", nd.ones((2,)))
        raised.append((type(e1.value).__name__, type(e2.value).__name__,
                       e2.value.site, dict(kv._rounds_completed)))
    assert raised[0] == raised[1]
    assert raised[0][:3] == ("RankFailureError", "FaultInjected",
                             "allreduce")


def test_collective_metrics_and_goodput():
    from mxnet_tpu.observability import metrics as jmetrics
    from mxnet_tpu_torch.observability import metrics
    moved = []
    for kvstore, nd, reg in ((mx.kv, mx.nd, metrics.registry()),
                             (jmx.kv, jmx.nd, jmetrics.registry())):
        fam = reg.get("mxnet_tpu_kvstore_collectives_total")
        seconds = reg.get("mxnet_tpu_kvstore_collective_seconds")
        base, n = fam.labels(kind="allreduce").value, seconds.count
        kv = kvstore.create("dist_sync")
        kv.init("k", nd.zeros((3,)))
        kv.push("k", nd.ones((3,)))
        moved.append((fam.labels(kind="allreduce").value - base,
                      seconds.count - n, dict(kv._rounds_completed)))
    assert moved[0] == moved[1] == (1, 1, {"allreduce": 1})


# ===========================================================================
# the train goodput record
# ===========================================================================
def test_step_record_reconciles_exactly():
    from mxnet_tpu.observability import goodput as jgoodput
    net, x, y = _train_setup()
    step = _step(net)
    for _ in range(3):
        step(mx.nd.array(x), mx.nd.array(y))
    rec = goodput.train().last_step
    jnet, jx, jy = _jax_setup()
    jstep = _jax_step(jnet, jx)
    for _ in range(3):
        jstep(jx, jy)
    jrec = jgoodput.train().last_step
    assert rec["kind"] == jrec["kind"] == "train_step"
    assert rec["steps"] == jrec["steps"] == 1
    assert sorted(rec) == sorted(jrec)
    assert sorted(rec["buckets"]) == sorted(jrec["buckets"])
    assert sum(rec["buckets"].values()) == pytest.approx(
        rec["wall_seconds"], abs=1e-9)
    assert rec["trace_id"] is not None
    assert rec["buckets"]["device_compute"] > 0
    assert rec["buckets"]["dispatch"] > 0
    _close(_params(net), _jparams(jnet), "params")
