"""Port parity: the training health sentinel of
``mxnet_tpu_torch.observability.health`` against the JAX package's, on CPU
tensors.

The same small net (three Dense layers, the JAX package's names
``dense0``..``dense2``) is built in both packages from the JAX net's
weights; the same seeded numpy batches go through both.  Held to the JAX
package: the layers localization names (fwd and bwd, NaN and Inf, an
unknown layer), ``graph_stats`` and a step's fetched norms, the spike
detector's flags, ``clip_global_norm`` and the divergence digests (fp32
and bf16).  Held within the port: health on against off bit for bit
(single step and ``MultiStepTrainStep`` with K = 4 rows), ``skip`` and
``raise``, the Trainer's clip, the cadences, one localization per
episode, no leftover ``forward``, the graph-signature salt, the
post-mortem's ``"health"`` key, the kvstore's divergence round under the
collective guard, and a two-process gloo job in which a perturbed rank
is named.

Tolerance: fp32 values within 1e-6 of each quantity's magnitude
(reductions summed in other orders); counts, names and digests exact.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.executor import CompiledTrainStep as JaxTrainStep
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JaxCE
from mxnet_tpu.observability import health as jhealth

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import optimizer as opt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.executor import (CompiledTrainStep, MultiStepTrainStep,
                                      stack_batches)
from mxnet_tpu_torch.gluon import Trainer, nn
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.observability import health, metrics

REL = 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCHER = os.path.join(ROOT, "tools", "launch.py")


def _jax_net(seed=0, layers=(16, 16), classes=3, feat=6):
    jmx.random.seed(seed)
    np.random.seed(seed)
    net = jnn.HybridSequential(prefix="net_")
    for i, n in enumerate(layers):
        net.add(jnn.Dense(n, activation="relu", prefix=f"dense{i}_"))
    net.add(jnn.Dense(classes, prefix=f"dense{len(layers)}_"))
    net.collect_params().initialize()
    net(jmx.nd.zeros((8, feat)))
    return net


def _net(seed=0, layers=(16, 16), classes=3, feat=6, dropout=0.0,
         jax_net=None):
    """The port twin of :func:`_jax_net` (its weights copied in)."""
    jnet = jax_net or _jax_net(seed, layers, classes, feat)
    net = nn.HybridSequential(prefix="net_")
    widths = (feat,) + tuple(layers)
    for i, n in enumerate(layers):
        net.add(nn.Dense(n, activation="relu", prefix=f"dense{i}_",
                         in_units=widths[i], device="cpu"))
    if dropout:
        net.add(nn.Dropout(dropout, generator=mx.random.generator(
            seed + 100, "cpu")))
    net.add(nn.Dense(classes, prefix=f"dense{len(layers)}_",
                     in_units=widths[-1], device="cpu"))
    with torch.no_grad():
        for jp, t in zip(jnet.collect_params().values(), net.parameters()):
            t.copy_(torch.from_numpy(jp.data().asnumpy().copy()))
    return net


def _batches(n, batch=8, feat=6, classes=3, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.uniform(size=(batch, feat)).astype(np.float32),
             rng.randint(0, classes, (batch,)).astype(np.float32))
            for _ in range(n)]


def _t(pair):
    return torch.from_numpy(pair[0]), torch.from_numpy(pair[1])


def _params(net):
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def _states(step):
    from mxnet_tpu_torch.executor import _leaves
    return [t.detach().clone() for s in step._states for t in _leaves(s)]


def _equal(a, b):
    return len(a) == len(b) and all(
        torch.equal(x, y) for x, y in zip(
            a.values() if isinstance(a, dict) else a,
            b.values() if isinstance(b, dict) else b))


def _close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    bound = REL * max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= bound, f"{what}: max err {err} > {bound}"


# ===========================================================================
# localization: the same layers as the JAX package's
# ===========================================================================
@pytest.mark.parametrize("plan", [{"dense1": "fwd:nan"}, {"dense1": "bwd:nan"},
                                  {}, {"dense0": "fwd:inf"},
                                  {"dense2": "bwd:inf"}],
                         ids=["fwd_nan", "bwd_nan", "clean", "fwd_inf",
                              "bwd_inf"])
def test_localize_names_the_jax_layers(plan):
    jnet = _jax_net()
    net = _net(jax_net=jnet)
    x, y = _batches(1, seed=3)[0]
    with jhealth.NumericsFaultPlan(jnet, plan):
        jrep = jhealth.localize(jnet, JaxCE(), x, y)
    with health.NumericsFaultPlan(net, plan):
        rep = health.localize(net, SoftmaxCrossEntropyLoss(),
                              torch.from_numpy(x), torch.from_numpy(y))
    assert "error" not in rep, rep
    assert rep["first_fwd"] == jrep["first_fwd"], (rep, jrep)
    assert [(n, c > 0) for n, c in rep["fwd"]] == \
        [(n, c > 0) for n, c in jrep["fwd"]]
    assert (rep["loss_nonfinite"] > 0) == (jrep["loss_nonfinite"] > 0)
    if not any(s.startswith("fwd") for s in plan.values()):
        # a forward fault poisons the whole backward, where inf - inf and
        # 0 * inf fall by each package's arithmetic: the fwd probe is the
        # attribution there, the bwd pass for the other plans
        for key in ("first_bwd", "nonfinite_params"):
            assert rep[key] == jrep[key], (key, rep, jrep)
        assert [(n, c > 0) for n, c in rep["bwd"]] == \
            [(n, c > 0) for n, c in jrep["bwd"]]


def test_unknown_layer_and_bad_spec_raise():
    net = _net()
    with pytest.raises(ValueError):
        health.NumericsFaultPlan(net, {"nosuch": "fwd:nan"}).__enter__()
    for spec in ("fw:nan", "nan", "fwd:naan"):
        with pytest.raises(ValueError):
            health.NumericsFaultPlan(net, {"dense0": spec}).__enter__()
    assert health.hook_fingerprint(net) == ()


def test_probe_restore_leaves_no_instance_forward():
    net = _net(seed=21)
    assert health.hook_fingerprint(net) == ()
    x, y = _t(_batches(1, seed=21)[0])
    with health.NumericsFaultPlan(net, {"dense0": "fwd:nan"}):
        assert health.hook_fingerprint(net) != ()
        health.localize(net, SoftmaxCrossEntropyLoss(), x, y)
    assert health.hook_fingerprint(net) == ()
    assert all("forward" not in vars(m) for m in net.modules())


def test_localize_writes_no_live_tensor_and_keeps_the_rng():
    net = _net(seed=4, dropout=0.5)
    x, y = _t(_batches(1, seed=4)[0])
    before = _params(net)
    gen = net[2].generator
    state = gen.get_state()
    rep = health.localize(net, SoftmaxCrossEntropyLoss(), x, y,
                          params=([t * 0.5 for t in net.parameters()], []))
    assert "error" not in rep and rep["first_fwd"] is None
    assert _equal(_params(net), before)
    assert torch.equal(gen.get_state(), state)


# ===========================================================================
# watchpoints: graph_stats and the fetched record against the JAX package
# ===========================================================================
def test_graph_stats_match_jax():
    import jax.numpy as jnp
    rng = np.random.RandomState(5)
    shapes = [(7, 5), (5,), (3, 7)]
    grads = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads[1][2] = np.nan
    grads[2][0, 1] = np.inf
    old = [rng.randn(*s).astype(np.float32) for s in shapes]
    new = [o - 0.1 * rng.randn(*o.shape).astype(np.float32) for o in old]
    loss = np.float32(np.nan)
    j = jhealth.graph_stats([jnp.asarray(a) for a in grads],
                            [jnp.asarray(a) for a in old],
                            [jnp.asarray(a) for a in new], jnp.asarray(loss))
    t = health.graph_stats([torch.from_numpy(a) for a in grads],
                           [torch.from_numpy(a) for a in old],
                           [torch.from_numpy(a) for a in new],
                           torch.tensor(loss))
    for key in ("param_sq", "upd_sq"):
        _close(t[key].numpy(), np.asarray(j[key]), key)
    _close(t["grad_sq"].numpy()[0], np.asarray(j["grad_sq"])[0], "grad_sq")
    for key in ("grad_nonfinite", "loss_nonfinite"):
        assert t[key].dtype == torch.int32
        np.testing.assert_array_equal(t[key].numpy(), np.asarray(j[key]))


def test_step_record_matches_jax():
    """One SGD step with health at every=1 in both packages: the fetched
    grad norm, parameter norm, update ratio and per-parameter names."""
    jnet = _jax_net(seed=1)
    net = _net(jax_net=jnet)
    x, y = _batches(1, seed=1)[0]
    jstep = JaxTrainStep(jnet, JaxCE(), jopt.create("sgd", learning_rate=0.1),
                         health={"every": 1})
    jstep(jmx.nd.array(x), jmx.nd.array(y))
    jrec = jhealth.ledger().last_step
    step = CompiledTrainStep(net, SoftmaxCrossEntropyLoss(),
                             opt.create("sgd", learning_rate=0.1),
                             health={"every": 1})
    step(torch.from_numpy(x), torch.from_numpy(y))
    rec = health.ledger().last_step
    for key in ("grad_norm", "param_norm", "update_ratio", "loss"):
        _close(rec[key], jrec[key], key)
    assert list(rec["per_param"]) == list(jrec["per_param"])
    assert rec["step"] == jrec["step"] == 1


def test_env_arms_the_step(monkeypatch):
    net = _net()
    assert CompiledTrainStep(net, SoftmaxCrossEntropyLoss(),
                             opt.create("sgd"))._hmon is None
    monkeypatch.setenv("MXNET_TPU_HEALTH", "1")
    step = CompiledTrainStep(net, SoftmaxCrossEntropyLoss(), opt.create("sgd"))
    assert step._hmon is not None and step._health
    assert CompiledTrainStep(net, SoftmaxCrossEntropyLoss(), opt.create("sgd"),
                             health=False)._hmon is None
    assert isinstance(CompiledTrainStep(
        net, SoftmaxCrossEntropyLoss(), opt.create("sgd"),
        health=health.HealthConfig(every=3))._hmon.config, health.HealthConfig)


# ===========================================================================
# health on against off, bit for bit
# ===========================================================================
@pytest.mark.parametrize("k", [1, 4])
def test_health_on_is_bitwise_health_off(k):
    data = _batches(8, seed=2)

    def run(cfg):
        net = _net(seed=2, dropout=0.25)
        mx.random.seed(7)
        cls = MultiStepTrainStep if k > 1 else CompiledTrainStep
        step = cls(net, SoftmaxCrossEntropyLoss(),
                   opt.create("adam", learning_rate=1e-2), health=cfg)
        losses = []
        for i in range(0, len(data), k):
            if k > 1:
                xs, ys = stack_batches([_t(b) for b in data[i:i + k]])
                losses.append(step(xs, ys))
            else:
                losses.append(step(*_t(data[i])))
        return _params(net), _states(step), torch.cat(
            [v.reshape(-1) for v in losses]), step

    p_off, s_off, l_off, _ = run(False)
    p_on, s_on, l_on, step = run({"every": 1})
    assert _equal(p_on, p_off) and _equal(s_on, s_off)
    assert torch.equal(l_on, l_off)
    rec = health.ledger().last_step
    assert rec["step"] == 8 and rec["grad_norm"] > 0
    if k > 1:
        assert step._stats_stacked
        fam = metrics.registry().get("mxnet_tpu_health_fetches_total")
        base = fam.value
        xs, ys = stack_batches([_t(b) for b in data[:4]])
        loss, stats = step._steps(tuple([xs]), ys)
        assert stats["grad_sq"].shape == (4, 6)
        assert stats["grad_nonfinite"].shape == (4, 6)
        assert stats["loss_nonfinite"].shape == (4,)
        assert fam.value == base


def test_action_skip_restores_pre_step_world_and_counts():
    net = _net(seed=5)
    o = opt.create("adam", learning_rate=1e-3)
    step = CompiledTrainStep(net, SoftmaxCrossEntropyLoss(), o,
                             health={"every": 1, "action": "skip",
                                     "localize": False})
    x, y = _t(_batches(1, seed=5)[0])
    step(x, y)
    before, before_states = _params(net), _states(step)
    counts = (o.num_update, dict(o._index_update_count))
    n_before = step._num_update
    step(torch.full_like(x, float("nan")), y)
    assert _equal(_params(net), before)
    assert _equal(_states(step), before_states)
    assert step._num_update == n_before
    assert (o.num_update, dict(o._index_update_count)) == counts
    step(x, y)
    assert step._num_update == n_before + 1
    assert o.num_update == counts[0] + 1
    assert all(torch.isfinite(t).all() for t in net.parameters())


def test_action_raise_is_typed_and_names_layer():
    net = _net(seed=6)
    step = CompiledTrainStep(net, SoftmaxCrossEntropyLoss(),
                             opt.create("sgd", learning_rate=0.1),
                             health={"every": 1, "action": "raise"})
    data = _batches(2, seed=6)
    step(*_t(data[0]))
    x, y = _t(data[1])
    x[0, :] = float("inf")
    with pytest.raises(health.NumericsError) as ei:
        step(x, y)
    assert "first faulting layer" in str(ei.value)
    assert "dense0" in str(ei.value)


def test_trip_localizes_from_healthy_snapshot():
    net = _net()
    step = CompiledTrainStep(net, SoftmaxCrossEntropyLoss(),
                             opt.create("sgd", learning_rate=0.1),
                             health={"every": 1, "action": "log"})
    data = _batches(4)
    for b in data[:3]:
        step(*_t(b))
    led = health.ledger()
    n0 = len(led.trips)
    fam = metrics.registry().get("mxnet_tpu_health_nonfinite_total")
    base = fam.labels(where="grad").value
    x, y = _t(data[3])
    x[0, 0] = float("nan")
    step(x, y)
    trips = led.trips
    assert len(trips) == n0 + 1
    trip = trips[-1]
    assert trip["kind"] == "nonfinite" and trip["first_fwd"] == "dense0"
    assert trip["localization"]["healthy_snapshot_step"] == 3
    assert trip["params"] and fam.labels(where="grad").value > base


def test_bwd_plan_after_capture_fires_through_the_signature():
    """A fault plan entered after the step's first call changes the
    signature (armed health salts it), so the plan reaches the step."""
    net = _net(seed=8)
    step = CompiledTrainStep(net, SoftmaxCrossEntropyLoss(),
                             opt.create("sgd", learning_rate=0.1),
                             health={"every": 1, "action": "raise"})
    data = _batches(2, seed=8)
    step(*_t(data[0]))
    sig0 = step._signature(*_t(data[0]))[0]
    with health.NumericsFaultPlan(net, {"dense1": "bwd:nan"}):
        assert step._signature(*_t(data[0]))[0] != sig0
        with pytest.raises(health.NumericsError) as ei:
            step(*_t(data[1]))
    assert ei.value.detail["first_bwd"] == "dense1"
    assert step._signature(*_t(data[0]))[0] == sig0


def test_hook_salt_only_when_health_armed():
    def sig(cfg, hooked):
        net = _net(seed=29)
        handle = (net[1].register_forward_hook(lambda m, a, o: None)
                  if hooked else None)
        try:
            step = CompiledTrainStep(net, SoftmaxCrossEntropyLoss(),
                                     opt.create("sgd"), health=cfg)
            return step._signature(*_t(_batches(1)[0]))[0]
        finally:
            if handle is not None:
                handle.detach()

    assert sig(False, True) == sig(False, False)
    assert sig({"every": 1}, True) != sig({"every": 1}, False)


def test_localization_runs_once_per_trip_episode():
    net = _net(seed=27)
    step = CompiledTrainStep(net, SoftmaxCrossEntropyLoss(),
                             opt.create("sgd", learning_rate=0.1),
                             health={"every": 1, "action": "log"})
    data = _batches(3, seed=27)
    step(*_t(data[0]))
    led = health.ledger()
    n0 = len(led.trips)
    x, y = _t(data[1])
    step(torch.full_like(x, float("nan")), y)   # poisons the parameters:
    step(*_t(data[2]))                           # every later step trips
    trips = led.trips[n0:]
    assert len(trips) == 2
    assert trips[0]["localization"].get("fwd"), trips[0]
    assert "suppressed" in trips[1]["localization"], trips[1]
    assert step._hmon._in_trip_episode


def test_e2e_sentinel_gate(tmp_path, monkeypatch):
    """Clean data: health on equals off bit for bit.  NaN data with
    action=raise and a flight directory: a typed error, the nonfinite
    counter in /metrics, and a post-mortem whose "health" key names the
    first faulting layer."""
    from mxnet_tpu_torch.observability import render_prometheus

    def run(data, cfg):
        net = _net(seed=9)
        step = CompiledTrainStep(net, SoftmaxCrossEntropyLoss(),
                                 opt.create("adam", learning_rate=1e-3),
                                 health=cfg)
        for b in data:
            step(*b)
        return _params(net)

    clean = [_t(b) for b in _batches(6, seed=9)]
    assert _equal(run(clean, {"every": 1}), run(clean, False))
    bad = list(clean)
    x = bad[3][0].clone()
    x[2, 1] = float("nan")
    bad[3] = (x, bad[3][1])
    from mxnet_tpu_torch.observability import flight_recorder
    monkeypatch.setenv("MXNET_TPU_FLIGHT_DIR", str(tmp_path))
    # the recorder writes one artifact per crash kind per 5 s; the earlier
    # raises of this file must not swallow this one
    monkeypatch.setattr(flight_recorder.get(), "_last_auto_dump", (None, 0.0))
    fam = metrics.registry().get("mxnet_tpu_health_nonfinite_total")
    base = fam.labels(where="grad").value
    with pytest.raises(health.NumericsError):
        run(bad, {"every": 1, "action": "raise"})
    assert fam.labels(where="grad").value > base
    assert 'mxnet_tpu_health_nonfinite_total{where="grad"}' in \
        render_prometheus()
    dumps = sorted(p for p in os.listdir(tmp_path) if p.startswith("flight-"))
    assert dumps
    with open(tmp_path / dumps[-1]) as f:
        artifact = json.load(f)
    trip = artifact["health"]["trips"][-1]
    assert trip["first_fwd"] == "dense0" and trip["params"]


# ===========================================================================
# cadences
# ===========================================================================
def test_skip_action_forces_per_step_cadence():
    assert health.HealthConfig(every=16, action="skip").every == 1
    assert health.HealthConfig(every=16, action="log").every == 16
    with pytest.raises(MXNetError):
        health.HealthConfig(action="nope")


def test_fetch_cadence_and_checksum_cadence():
    net = _net(seed=22)
    step = CompiledTrainStep(net, SoftmaxCrossEntropyLoss(),
                             opt.create("sgd", learning_rate=0.1),
                             health={"every": 3, "checksum_every": 2,
                                     "localize": False})
    fetches = metrics.registry().get("mxnet_tpu_health_fetches_total")
    rounds = metrics.registry().get("mxnet_tpu_health_checksum_rounds_total")
    f0, r0 = fetches.value, rounds.value
    for b in _batches(6, seed=22):
        step(*_t(b))
    assert fetches.value == f0 + 2     # steps 3 and 6
    assert rounds.value == r0 + 3      # steps 2, 4 and 6
    rec = health.ledger().snapshot()["checksums"][-1]
    assert rec["agree"] and rec["nproc"] == 1
    assert set(rec["keys"]) == set(step._names)


def test_reconfigure_keeps_the_watchpoint_flag():
    mon = health.HealthMonitor(health.HealthConfig(every=1))
    mon.reconfigure(health.HealthConfig(every=2, window=8))
    assert mon.config.every == 2 and mon.loss_detector.window == 8
    with pytest.raises(MXNetError):
        mon.reconfigure(health.HealthConfig(watchpoints=False))


# ===========================================================================
# spikes, clip, digests: against the JAX package
# ===========================================================================
def test_spike_detector_flags_the_jax_indices():
    rng = np.random.RandomState(0)
    seq = list(1.0 + 0.01 * rng.randn(30)) + [10.0, 1.0, float("nan"),
                                             1.02, 25.0]
    a = jhealth.SpikeDetector(window=16, zscore=6.0, min_points=8)
    b = health.SpikeDetector(window=16, zscore=6.0, min_points=8)
    ja = [a.update(v) for v in seq]
    tb = [b.update(v) for v in seq]
    assert ja == tb and tb[30] and not tb[32]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_global_norm_bitwise_vs_two_pass(dtype):
    rng = np.random.RandomState(0)
    dt = getattr(torch, dtype)
    raws = [torch.from_numpy(rng.randn(5, 3).astype(np.float32)).to(dt),
            torch.from_numpy(rng.randn(17).astype(np.float32)).to(dt)]
    norm, fused = health.clip_global_norm(raws, 0.5)
    n2 = health.global_norm(raws)
    assert torch.equal(norm, n2)
    scale = torch.where(n2 > 0.5, torch.tensor(0.5) / n2, torch.tensor(1.0))
    for a, g in zip(fused, raws):
        assert torch.equal(a, (g.float() * scale).to(g.dtype))
    assert float(health.global_norm(fused)) == pytest.approx(0.5, rel=0.02)
    _, same = health.clip_global_norm(raws, 1e6)
    assert all(torch.equal(a, b) for a, b in zip(same, raws))


def test_clip_global_norm_matches_jax():
    import jax.numpy as jnp
    rng = np.random.RandomState(1)
    arrs = [rng.randn(9, 4).astype(np.float32), rng.randn(31).astype(np.float32)]
    jnorm, jscaled = jhealth.clip_global_norm([jnp.asarray(a) for a in arrs],
                                              0.75)
    norm, scaled = health.clip_global_norm(
        [torch.from_numpy(a) for a in arrs], 0.75)
    _close(float(norm), float(np.asarray(jnorm)), "norm")
    for a, b in zip(scaled, jscaled):
        _close(a.numpy(), np.asarray(b), "scaled")
    assert health.global_norm_value([torch.from_numpy(a) for a in arrs]) == \
        pytest.approx(float(np.asarray(jnorm)), rel=REL)


def test_trainer_clip_global_norm_end_to_end():
    from mxnet_tpu_torch import autograd
    prev = mx.set_default_context(mx.cpu())
    try:
        net = _net(seed=13)
        trainer = Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1}, kvstore=None)
        x, y = _batches(1, seed=13)[0]
        with autograd.record():
            loss = SoftmaxCrossEntropyLoss()(net(mx.nd.array(x)),
                                             mx.nd.array(y))
        loss.backward()
        params = list(net.collect_params().values())
        grads = {p.name: p.grad().asnumpy().copy() for p in params}
        total = float(np.sqrt(sum(np.sum(np.square(g))
                                  for g in grads.values())))
        norm = trainer.clip_global_norm(total * 2)
        assert norm == pytest.approx(total, rel=1e-5)
        for p in params:
            assert p.grad().asnumpy().tobytes() == grads[p.name].tobytes()
        norm2 = trainer.clip_global_norm(total / 4)
        assert norm2 == pytest.approx(total, rel=1e-5)
        name = params[0].name
        clipped = params[0].grad().asnumpy()
        mask = grads[name] != 0
        ratio = clipped[mask] / grads[name][mask]
        assert ratio.size and np.allclose(ratio, ratio.flat[0], rtol=1e-5)
        assert metrics.registry().get(
            "mxnet_tpu_health_grad_norm").value == pytest.approx(norm2)
        trainer.step(8)
    finally:
        mx.set_default_context(prev)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_digests_equal_the_jax_digests(dtype):
    import jax.numpy as jnp
    rng = np.random.RandomState(2)
    a = rng.randn(6, 5).astype(np.float32)
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    j = jnp.asarray(a).astype(dtype)
    assert health.checksum_arrays({"w": t}) == \
        jhealth.checksum_arrays({"w": j})
    rec = health.divergence_report({"w": t}, buckets=[["w"]])
    jrec = jhealth.divergence_report({"w": j}, buckets=[["w"]])
    assert rec["keys"] == jrec["keys"] and rec["buckets"] == jrec["buckets"]
    assert rec["agree"] and rec["diverging"] == []


# ===========================================================================
# the kvstore's divergence round and a two-process job
# ===========================================================================
def test_kvstore_divergence_round_rides_collective_guard():
    from mxnet_tpu_torch import kvstore as kv_mod
    from mxnet_tpu_torch.resilience import FaultInjected, FaultPlan
    store = kv_mod.create("dist_sync")
    named = {"w": torch.ones(8)}
    rec = store.divergence_round(named)
    assert rec["agree"]
    assert store._rounds_completed["divergence_checksum"] == 1
    with FaultPlan({"allreduce": ["fatal"]}):
        with pytest.raises(FaultInjected):
            store.divergence_round(named)
    assert store._rounds_completed["divergence_checksum"] == 1


_WORKER = r'''
import os, sys
sys.path.insert(0, sys.argv[1])
import torch
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import distributed
mx.set_default_context(mx.cpu())
distributed.initialize()
try:
    rank = distributed.process_index()
    kv = mx.kv.create("dist_sync")
    named = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
             "b": torch.ones(5, dtype=torch.bfloat16)}
    first = kv.divergence_round(named)
    if rank == 1:
        named["w"][1, 2] = torch.nextafter(named["w"][1, 2],
                                           torch.tensor(float("inf")))
    second = kv.divergence_round(named)
    assert kv._rounds_completed["divergence_checksum"] == 2
    if rank == 0:
        assert first["agree"], first
        assert second["diverging"] == [{"rank": 1, "key": "w",
                                        "scope": "process"}], second
    distributed.barrier()
finally:
    distributed.finalize()
print(f"[rank {rank}] divergence OK", flush=True)
'''


def test_two_process_divergence_names_the_perturbed_rank(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    r = subprocess.run([sys.executable, LAUNCHER, "-n", "2", sys.executable,
                        str(worker), ROOT], capture_output=True, text=True,
                       timeout=180, env=env, cwd=ROOT)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    for rank in range(2):
        assert f"[rank {rank}] divergence OK" in r.stdout, r.stdout
