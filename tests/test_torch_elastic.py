"""Port parity: elastic training's mesh reformation
(``mxnet_tpu_torch/resilience/elastic.py``: ``ElasticTrainStep``,
``ElasticConfig``, ``elastic_recoverable``; ``Estimator.fit(elastic=)``)
against the tier-1 cases of ``tests/test_elastic.py``, on 8 CPU mesh
positions.

A rank's death is modeled at the ``execute`` and ``allreduce`` fault
sites by a ``FaultPlan``, as in the JAX package.  The acceptance gate:
the mesh reforms dp 8 → 4, the step is rebuilt for it, the last durable
checkpoint restored and the buffered batches replayed, and the
parameters and optimizer states end bit for bit where a cold restart
from that checkpoint on dp = 4 ends (fp32 and bf16, sharded states or
not, one step or K = 4 per call; dropout included: the checkpoint
carries the random streams).  The port's K-step call is K replays of the
one-step graph, so it passes the ``execute`` site K times a call (the
JAX package's once): its plans count steps, not calls.  The classifier
and the configuration's defaults are the JAX package's; the multi-process
world agreement (``_agree_world`` over ``torch.distributed``) has no test
here.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu.base import env as jenv
from mxnet_tpu.observability.health import NumericsError as JNumericsError
from mxnet_tpu.resilience import FaultInjected as JFaultInjected
from mxnet_tpu.resilience import RankFailureError as JRankFailureError
from mxnet_tpu.resilience import elastic as jelastic

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import optimizer as opt
from mxnet_tpu_torch.base import MXNetError, env
from mxnet_tpu_torch.executor import (CompiledTrainStep, MultiStepTrainStep,
                                      stack_batches)
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.observability.health import NumericsError
from mxnet_tpu_torch.parallel import DeviceMesh
from mxnet_tpu_torch.resilience import (BackendUnavailableError,
                                        ElasticConfig, ElasticTrainStep,
                                        FaultInjected, FaultPlan,
                                        RankFailureError)
from mxnet_tpu_torch.resilience.elastic import (elastic_recoverable,
                                                load_elastic_checkpoint)

CPU8 = [torch.device("cpu")] * 8
CADENCE = 2          # a checkpoint every 2 calls
FAULT_CALL = 2       # the third call dies, after a durable cadence point
N_CALLS = 4
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _fast_retry(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_RETRY_BACKOFF", "0.001")


def _mesh(dp):
    return DeviceMesh({"dp": dp}, devices=CPU8[:dp])


def _net(dtype="float32", seed=0):
    """Dense, Dropout(0.25) drawing from its own generator, Dense: numpy
    weights from ``seed``."""
    rng = np.random.RandomState(seed)
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu", in_units=6, device="cpu"))
        net.add(nn.Dropout(0.25, generator=mx.random.generator(seed + 1000,
                                                               "cpu")))
        net.add(nn.Dense(3, in_units=16, device="cpu"))
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.from_numpy(rng.uniform(-0.4, 0.4, tuple(p.shape))
                                     .astype(np.float32)))
    if dtype != "float32":
        net.cast(dtype)
    return net


def _call_batches(dtype="float32", k=1, n_calls=N_CALLS):
    rng = np.random.RandomState(7)
    pairs = [(torch.from_numpy(rng.uniform(size=(8, 6)).astype(np.float32))
              .to(TDT[dtype]),
              torch.from_numpy(rng.randint(0, 3, (8,)).astype(np.float32)))
             for _ in range(n_calls * k)]
    if k == 1:
        return pairs
    return [stack_batches(pairs[i * k:(i + 1) * k]) for i in range(n_calls)]


def _builder(net, k, shard):
    def build(mesh):
        o = opt.create("adam", learning_rate=0.05)
        if k > 1:
            return MultiStepTrainStep(net, SoftmaxCrossEntropyLoss(), o,
                                      batch_size=8, steps_per_call=k,
                                      mesh=mesh, shard_optimizer_state=shard)
        return CompiledTrainStep(net, SoftmaxCrossEntropyLoss(), o,
                                 batch_size=8, mesh=mesh,
                                 shard_optimizer_state=shard)
    return build


def _params(net):
    return [p.detach().clone() for p in net.parameters()]


def _flat_state(step):
    out = []
    for st in step.optimizer_states():
        out.extend(t.detach().clone() for t in st)
    return out


def _elastic_run(tmp_path, dtype, k, shard, plan=None, max_reforms=2,
                 n_calls=N_CALLS, every=None):
    batches = _call_batches(dtype, k, n_calls)
    net = _net(dtype)
    es = ElasticTrainStep(
        _builder(net, k, shard), mesh=_mesh(8),
        config=ElasticConfig(directory=str(tmp_path / "ckpt"),
                             every=CADENCE * k if every is None else every,
                             max_reforms=max_reforms))
    try:
        with FaultPlan(plan or {}):
            for x, y in batches:
                es(x, y)
        es.finish()
    finally:
        es.close()
    return es, net


def _cold_restart(tmp_path, dtype, k, shard, from_call=FAULT_CALL, dp=4):
    """The oracle: a new net from other weights and another dropout
    stream, a step on dp = 4, the checkpoint the reformation restored,
    the remaining batches."""
    batches = _call_batches(dtype, k)
    net = _net(dtype, seed=99)
    step = _builder(net, k, shard)(_mesh(dp))
    meta = load_elastic_checkpoint(
        str(tmp_path / "ckpt" / f"step-{from_call * k:08d}"), step)
    assert meta["step"] == step._num_update == from_call * k
    assert meta["world_dp"] == 8
    for x, y in batches[from_call:]:
        step(x, y)
    return step, net


_GATE_TIER1 = [("float32", False, 1), ("float32", True, 4),
               ("bfloat16", True, 1), ("bfloat16", False, 4)]


@pytest.mark.faults
@pytest.mark.parametrize("dtype,shard,k", _GATE_TIER1)
def test_rank_loss_recovery_bitwise(tmp_path, dtype, shard, k):
    """dp = 8, a rank dies in the third call → the mesh reforms to dp = 4
    from the old mesh's positions, the last durable checkpoint is
    restored (sharded states re-sliced), the buffered batches replay,
    and the parameters and optimizer states end bit for bit at a cold
    dp = 4 restart's from that checkpoint."""
    es, net = _elastic_run(
        tmp_path, dtype, k, shard,
        plan={"execute": ["ok"] * (FAULT_CALL * k) + ["fatal"]})
    assert es.reformations == 1 and es.world_size == 4
    assert es.mesh.devices == CPU8[:4]
    assert es.step._num_update == N_CALLS * k
    assert (es.step._zero is not None) == shard
    cold_step, cold_net = _cold_restart(tmp_path, dtype, k, shard)
    for a, b in zip(_params(net), _params(cold_net)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    got, want = _flat_state(es.step), _flat_state(cold_step)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.faults
def test_second_rank_loss_reforms_again_and_budget_bounds(tmp_path):
    """A second loss reforms 4 → 2 (the largest power of two under the
    survivors); with ``max_reforms=0`` the first loss is a typed error."""
    es, _ = _elastic_run(
        tmp_path, "float32", 1, False, n_calls=6,
        plan={"execute": ["ok", "ok", "fatal", "ok", "fatal"]})
    assert es.reformations == 2 and es.world_size == 2
    assert es.step._num_update == 6
    with pytest.raises(MXNetError, match="budget exhausted"):
        _elastic_run(tmp_path / "b", "float32", 1, False, max_reforms=0,
                     plan={"allreduce": ["ok", "ok", "fatal"]})


@pytest.mark.faults
def test_zero_cadence_bounds_buffer_and_meters_lost_steps(tmp_path):
    """``every=0`` keeps no batches for replay; a reformation restores the
    step-0 anchor and the rolled-back steps are lost, and metered."""
    from mxnet_tpu_torch.observability import metrics
    lost = metrics.registry().get("mxnet_tpu_elastic_lost_steps_total")
    reforms = metrics.registry().get("mxnet_tpu_elastic_reformations_total")
    before, r0 = lost.value, reforms.value
    batches = _call_batches()
    net = _net()
    es = ElasticTrainStep(_builder(net, 1, False), mesh=_mesh(8),
                          config=ElasticConfig(directory=str(tmp_path / "c"),
                                               every=0, max_reforms=2))
    try:
        with FaultPlan({"execute": ["ok", "ok", "fatal"]}):
            for x, y in batches:
                es(x, y)
                assert len(es._buffer) <= 1
        assert es.reformations == 1 and es.world_size == 4
        assert es.step._num_update == 2
        assert lost.value - before == 2 and reforms.value - r0 == 1
        assert metrics.registry().get(
            "mxnet_tpu_elastic_world_size").value == 4
    finally:
        es.close()


def _est_net():
    return _net()


def _est_data(n):
    return [(mx.nd.array(x.numpy(), ctx=mx.cpu()),
             mx.nd.array(y.numpy(), ctx=mx.cpu()))
            for x, y in _call_batches(n_calls=n)]


@pytest.mark.faults
def test_estimator_elastic_fit_survives_rank_loss(tmp_path):
    """``fit(elastic=...)`` over a DevicePrefetchIter made under a dp = 8
    mesh: a rank dies, the fused driver reforms to dp = 4, the iterator's
    staging follows (``on_reform``), and every batch trains."""
    from mxnet_tpu_torch.gluon.contrib.estimator import Estimator
    from mxnet_tpu_torch.io import DevicePrefetchIter
    net = _est_net()
    est = Estimator(net, SoftmaxCrossEntropyLoss(), context=mx.cpu())
    with _mesh(8):
        pf = DevicePrefetchIter(_est_data(6))
        try:
            with FaultPlan({"allreduce": ["ok", "fatal"]}):
                est.fit(pf, epochs=1, steps_per_call=2,
                        elastic={"directory": str(tmp_path / "ck"),
                                 "every": 2, "max_reforms": 2})
        finally:
            pf.close()
    (wrapper,) = est._fused_steps.values()
    assert wrapper.reformations == 1 and wrapper.world_size == 4
    assert wrapper.step._num_update == 6
    assert pf.mesh.axis_size("dp") == 4
    for p in net.parameters():
        assert torch.isfinite(p).all()
    wrapper.close()


def test_estimator_elastic_multi_epoch_reuses_driver(tmp_path):
    """With no mesh entered, a two-epoch elastic fit resolves its mesh
    once: one driver, its optimizer states carried across the epochs."""
    from mxnet_tpu_torch.gluon.contrib.estimator import Estimator
    est = Estimator(_est_net(), SoftmaxCrossEntropyLoss(), context=mx.cpu())
    est.fit(_est_data(3), epochs=2,
            elastic={"directory": str(tmp_path / "ck"), "every": 2})
    assert len(est._fused_steps) == 1
    (wrapper,) = est._fused_steps.values()
    assert wrapper.step._num_update == 6
    wrapper.close()


def _exceptions(pkg):
    fi, rf, ne = ((FaultInjected, RankFailureError, NumericsError)
                  if pkg == "port" else
                  (JFaultInjected, JRankFailureError, JNumericsError))
    return [rf("peer gone"),
            fi("allreduce", "fatal", "m", False),
            fi("allreduce", "x", "m", True),
            fi("execute", "fatal", "m", False),
            fi("execute", "x", "m", True),
            fi("compile", "fatal", "m", False),
            ne("diverged", diverging_rank=3), ne("nan"),
            ValueError("bug"), RuntimeError("cuda")]


def test_elastic_recoverable_matches_jax():
    """The classifier gives the JAX package's answer on the same
    exceptions; a backend that is gone is not one rank lost."""
    got = [elastic_recoverable(e) for e in _exceptions("port")]
    want = [jelastic.elastic_recoverable(e) for e in _exceptions("jax")]
    assert got == want
    assert got[:4] == [True, True, True, True] and not got[4]
    assert not elastic_recoverable(BackendUnavailableError("gone"))


def test_elastic_config_env_defaults(monkeypatch):
    """The four knobs under the JAX package's names and defaults, read at
    construction; a dict and True coerce."""
    names = ("MXNET_TPU_ELASTIC_DIR", "MXNET_TPU_ELASTIC_CKPT_STEPS",
             "MXNET_TPU_ELASTIC_MAX_REFORMS", "MXNET_TPU_ELASTIC_MIN_DP")
    for name in names:
        monkeypatch.delenv(name, raising=False)
        assert getattr(env, name) == getattr(jenv, name)
    cfg = ElasticConfig()
    jcfg = jelastic.ElasticConfig()
    assert (cfg.directory, cfg.every, cfg.max_reforms, cfg.min_dp) == \
        (jcfg.directory, jcfg.every, jcfg.max_reforms, jcfg.min_dp) == \
        ("", 8, 2, 1)
    monkeypatch.setenv("MXNET_TPU_ELASTIC_MAX_REFORMS", "5")
    monkeypatch.setenv("MXNET_TPU_ELASTIC_MIN_DP", "0")
    cfg = ElasticConfig.coerce(True)
    assert cfg.max_reforms == 5 and cfg.min_dp == 1
    cfg = ElasticConfig.coerce({"directory": "d", "every": 3})
    assert (cfg.directory, cfg.every) == ("d", 3)
    assert ElasticConfig.coerce(cfg) is cfg


@pytest.mark.faults
def test_min_dp_refuses_to_limp(tmp_path):
    """Fewer survivors than ``min_dp`` end the job with a typed error."""
    net = _net()
    es = ElasticTrainStep(_builder(net, 1, False), mesh=_mesh(2),
                          config=ElasticConfig(directory=str(tmp_path / "c"),
                                               every=2, min_dp=2))
    try:
        with FaultPlan({"allreduce": ["ok", "fatal"]}), \
                pytest.raises(MXNetError, match="min_dp"):
            for x, y in _call_batches():
                es(x, y)
    finally:
        es.close()
