"""Port parity: ``gluon.contrib.estimator`` (``Estimator`` and its event
handlers) against the JAX package's, on the CPU; the cases of
``tests/test_estimator.py`` run through both packages.

Each case builds the same small classifier in both packages under the
same ``prefix=`` (the port's weights carried from the JAX net with
``convert.params_from_mxnet``), trains it on the same seeded batches and
compares the parameters, the metrics and the handlers' decisions.  The
eager loop (record, backward, ``trainer.step``) is held against the JAX
eager loop; the fused driver (``MultiStepTrainStep`` for every K) at
K = 1 against the JAX eager loop too (its K = 1 driver), and against a
bare ``CompiledTrainStep`` loop bit for bit; at K = 2 against the JAX
fused driver at K = 2.
Checkpoints the port writes load into the JAX net and Trainer.  Health
checks and fault replays compare outcomes: the exception raised, the
parameters after a replay bit for bit against a run without the fault.

Tolerances: parameters after training within 1e-5 of each tensor's
largest |value| (a few SGD steps; JAX and PyTorch sum the products in
other orders), metrics within 1e-5; replays bit for bit.
"""
import logging
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import resilience as jrs
from mxnet_tpu.gluon.contrib import estimator as jest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import resilience as rs
from mxnet_tpu_torch.convert import params_from_mxnet
from mxnet_tpu_torch.gluon.contrib import estimator as test_
from mxnet_tpu_torch.observability.health import NumericsError

REL = 1e-5


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_RETRY_BACKOFF", "0.001")
    rs.reset_backend_state()
    jrs.reset_backend_state()
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)
    rs.reset_backend_state()
    jrs.reset_backend_state()


def _data(pkg, n=32, d=8, classes=3, batch=8, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    y = rng.randint(0, classes, n).astype(np.float32)
    return [(pkg.nd.array(x[i:i + batch]), pkg.nd.array(y[i:i + batch]))
            for i in range(0, n, batch)]


def _net(pkg, d=8, classes=3):
    net = pkg.gluon.nn.HybridSequential(prefix="est_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(16, activation="relu", in_units=d))
        net.add(pkg.gluon.nn.Dense(classes, in_units=16))
    return net


def _pair(opt="sgd", opt_params=None):
    """``(jax estimator, port estimator)`` over the same weights."""
    opt_params = opt_params or {"learning_rate": 0.1, "momentum": 0.9}
    jmx.random.seed(0)
    jnet = _net(jmx)
    jnet.collect_params().initialize()
    tnet = _net(tmx)
    tnet.collect_params().initialize(ctx=tmx.cpu())
    params_from_mxnet({k: p.data().asnumpy() for k, p in
                       jnet.collect_params().items()}, tnet)
    je = jest.Estimator(jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                        train_metrics=jmx.metric.Accuracy(),
                        val_metrics=jmx.metric.Accuracy(),
                        trainer=jmx.gluon.Trainer(jnet.collect_params(), opt,
                                                  dict(opt_params)))
    te = test_.Estimator(tnet, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                         train_metrics=tmx.metric.Accuracy(),
                         val_metrics=tmx.metric.Accuracy(),
                         trainer=tmx.gluon.Trainer(tnet.collect_params(),
                                                   opt, dict(opt_params)),
                         context=tmx.cpu())
    return je, te


def _params(est):
    return {k: p.data().asnumpy() for k, p in
            est.net.collect_params().items()}


def _close_params(te, je, rel=REL):
    got, ref = _params(te), _params(je)
    assert sorted(got) == sorted(ref)
    for k in ref:
        bound = rel * float(np.abs(ref[k]).max()) + 1e-7
        err = float(np.abs(got[k] - ref[k]).max())
        assert err <= bound, f"{k}: max err {err} > {bound}"


def test_fit_reduces_the_loss_like_jax():
    je, te = _pair()
    for est, pkg in ((je, jmx), (te, tmx)):
        est.fit(_data(pkg), epochs=1)
    first = te.train_loss_metric.get()[1]
    assert abs(first - je.train_loss_metric.get()[1]) <= REL * abs(first)
    for est, pkg in ((je, jmx), (te, tmx)):
        est.fit(_data(pkg), epochs=5)
    assert te.train_loss_metric.get()[1] < first
    _close_params(te, je)


# driver: (port steps_per_call, JAX steps_per_call)
DRIVERS = {"eager": (None, None), "fused_k1": (1, None),
           "fused_k2": (2, 2), "fused_k3_tail": (3, 3)}


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_drivers_match_the_jax_estimator(driver):
    """The port's eager loop, its fused driver at K = 1, 2 and 3 (a
    2-batch tail group) after 2 epochs of 5 batches: every parameter and
    the training loss metric as the JAX Estimator's."""
    k_port, k_jax = DRIVERS[driver]
    je, te = _pair()
    je.fit(_data(jmx, n=40), epochs=2, steps_per_call=k_jax)
    te.fit(_data(tmx, n=40), epochs=2, steps_per_call=k_port)
    _close_params(te, je)
    assert abs(te.train_loss_metric.get()[1]
               - je.train_loss_metric.get()[1]) <= REL
    assert len(te._fused_steps) == (0 if k_port is None else 1)


def test_fused_k1_equals_a_bare_compiled_step_loop():
    """The fused driver at K = 1 runs MultiStepTrainStep over one-batch
    groups: its parameters after 2 epochs equal, bit for bit, those of a
    hand-written CompiledTrainStep loop over the same batches from the
    same weights with the same optimizer settings."""
    from mxnet_tpu_torch import optimizer
    from mxnet_tpu_torch.executor import CompiledTrainStep, MultiStepTrainStep
    _, te = _pair()
    _, bare = _pair()
    te.fit(_data(tmx, n=40), epochs=2, steps_per_call=1)
    assert type(te._fused_steps[(1, False)]) is MultiStepTrainStep
    step = CompiledTrainStep(bare.net, bare.loss,
                             optimizer.create("sgd", learning_rate=0.1,
                                              momentum=0.9))
    for _ in range(2):
        for x, y in _data(tmx, n=40):
            step(x, y)
    for name, v in _params(bare).items():
        assert np.array_equal(_params(te)[name], v), name


def test_prefetch_to_device_gives_the_same_run():
    """``prefetch_to_device=True`` stages the batches through a
    DevicePrefetchIter onto the Estimator's context (here the CPU) and
    trains to the same bits; the goodput window counts ``input_wait``."""
    _, plain = _pair()
    _, pre = _pair()
    plain.fit(_data(tmx), epochs=2, steps_per_call=2)
    pre.fit(_data(tmx), epochs=2, steps_per_call=2, prefetch_to_device=True)
    for k, v in _params(plain).items():
        assert np.array_equal(_params(pre)[k], v)
    assert "input_wait" in pre.last_goodput["buckets"]


@pytest.mark.parametrize("k", [None, 2])
def test_goodput_window_reconciles(k):
    _, te = _pair()
    te.fit(_data(tmx), epochs=1, steps_per_call=k)
    report = te.last_goodput
    assert report["label"] == "fit" and report["kind"] == "train_window"
    total = sum(report["buckets"].values()) + report["unattributed_seconds"]
    assert abs(total - report["wall_seconds"]) < 1e-9
    if k:
        assert report["buckets"]["device_compute"] > 0


def test_validation_and_metrics_match_jax():
    je, te = _pair()
    je.fit(_data(jmx), val_data=_data(jmx, seed=1), epochs=2)
    te.fit(_data(tmx), val_data=_data(tmx, seed=1), epochs=2)
    for attr in ("val_metrics", "train_metrics"):
        (jn, jv), (tn, tv) = (getattr(je, attr)[0].get(),
                              getattr(te, attr)[0].get())
        assert tn == jn and abs(tv - jv) <= REL
    assert abs(te.val_loss_metric.get()[1]
               - je.val_loss_metric.get()[1]) <= REL
    te.evaluate(_data(tmx, seed=2))
    je.evaluate(_data(jmx, seed=2))
    assert abs(te.val_metrics[0].get()[1] - je.val_metrics[0].get()[1]) \
        <= REL


@pytest.mark.parametrize("k", [None, 2])
def test_batches_stops_the_run(k):
    """``batches=3`` / a StoppingHandler's ``max_batch``: 3 batches, also
    when K = 2 groups would overrun (the last group is capped at 1)."""
    seen = {}
    for pkg, est_mod, est in ((jmx, jest, _pair()[0]),
                              (tmx, test_, _pair()[1])):
        log = seen[pkg.__name__] = []

        class Counter(est_mod.StoppingHandler):
            def batch_end(self, estimator, *a, **kw):
                super().batch_end(estimator, *a, **kw)
                log.append(self.current_batch)

        est.fit(_data(pkg, n=64), event_handlers=[Counter(max_batch=3)],
                steps_per_call=k)
    assert seen["mxnet_tpu_torch"] == seen["mxnet_tpu"]
    assert max(seen["mxnet_tpu_torch"]) == 3


def test_checkpoints_load_into_the_jax_net_and_trainer(tmp_path):
    """CheckpointHandler keeps ``max_checkpoints`` epochs of ``.params``
    and the trainer's ``.states``; the port's files load into the JAX net
    and Trainer and both continue to the same parameters; ``save_best``
    writes ``-best.params`` when the monitored metric improves."""
    je, te = _pair()
    ckpt = test_.CheckpointHandler(str(tmp_path), model_prefix="m",
                                   max_checkpoints=2,
                                   monitor=te.train_loss_metric,
                                   save_best=True)
    te.fit(_data(tmx), epochs=3, event_handlers=[ckpt])
    files = sorted(os.listdir(tmp_path))
    assert [f for f in files if f.endswith(".params")] == \
        ["m-best.params", "m-epoch2.params", "m-epoch3.params"]
    assert [f for f in files if f.endswith(".states")] == \
        ["m-epoch2.states", "m-epoch3.states"]
    je.net.load_parameters(str(tmp_path / "m-epoch3.params"))
    je.trainer.load_states(str(tmp_path / "m-epoch3.states"))
    _close_params(te, je, rel=0.0)
    je.fit(_data(jmx, seed=3), epochs=1)
    te.fit(_data(tmx, seed=3), epochs=1)
    _close_params(te, je)


def test_early_stopping_at_the_same_epoch_as_jax():
    stopped = {}
    for name, pkg, est_mod, est in (("jax", jmx, jest, _pair()[0]),
                                    ("port", tmx, test_, _pair()[1])):
        class NeverImproves:
            def get(self):
                return "loss", 1.0

        h = est_mod.EarlyStoppingHandler(NeverImproves(), patience=2,
                                         mode="min")

        class Bridge(est_mod.StoppingHandler):
            def __init__(self):
                super().__init__(max_epoch=50)

            def epoch_end(self, estimator, *a, **kw):
                super().epoch_end(estimator, *a, **kw)
                if h.stop_training:
                    self.stop_training = True

        est.fit(_data(pkg), epochs=50, event_handlers=[h, Bridge()])
        stopped[name] = h.stopped_epoch
    assert stopped["port"] == stopped["jax"] and 0 < stopped["port"] <= 4


def test_dataiter_with_pad_and_epochs_like_jax():
    """A DataIter rewinds every epoch, and a wrapped tail's ``pad`` rows
    are dropped (4 + 4 + 2 samples an epoch), as in the JAX package."""
    rng = np.random.RandomState(0)
    x = rng.randn(10, 8).astype("f")
    y = rng.randint(0, 3, 10).astype("f")
    je, te = _pair()
    seen = []
    te.net.register_forward_pre_hook(
        lambda block, args: seen.append(args[0].shape[0]))
    je.fit(jmx.io.NDArrayIter(x, y, batch_size=4), epochs=2)
    te.fit(tmx.io.NDArrayIter(x, y, batch_size=4), epochs=2)
    assert sum(seen) == 20, seen
    _close_params(te, je)
    d, l = te._batch_fn(tmx.io.DataBatch([tmx.nd.ones((2, 3))],
                                         tmx.nd.array([0.0, 1.0])))
    assert d.shape == (2, 3) and l.shape == (2,)
    with pytest.raises(ValueError, match="labels"):
        te._batch_fn(tmx.io.DataBatch([tmx.nd.ones((2, 3))], None))


def _poisoned(pkg):
    batches = _data(pkg)
    bad = batches[2][0].asnumpy().copy()
    bad[0, 0] = np.nan
    batches[2] = (pkg.nd.array(bad), batches[2][1])
    return batches


@pytest.mark.parametrize("k", [None, 1], ids=["eager_handler",
                                              "fused_watchpoints"])
def test_health_raise_on_a_poisoned_batch_like_jax(k):
    """``health={'action': 'raise'}``: a NaN in the third batch raises
    NumericsError from the TrainingHealthHandler on the eager loop, and
    from the fused step's in-graph watchpoints, as the JAX Estimator's
    eager loop raises."""
    je, te = _pair()
    cfg = {"action": "raise", "every": 1}
    from mxnet_tpu.observability.health import NumericsError as JErr
    with pytest.raises(JErr):
        je.fit(_poisoned(jmx), epochs=1, health=dict(cfg))
    with pytest.raises(NumericsError):
        te.fit(_poisoned(tmx), epochs=1, health=dict(cfg), steps_per_call=k)
    handlers = k is None
    assert (len(te._fused_steps) == 0) == handlers
    if not handlers:
        step = next(iter(te._fused_steps.values()))
        assert step._hmon is not None


@pytest.mark.parametrize("k", [None, 1, 2])
def test_resume_on_fault_replays_to_the_same_bits(k, monkeypatch):
    """``resume_on_fault=2`` under a FaultPlan of transient faults at the
    ``execute`` site: on the eager loop the Trainer's update dies at its
    second parameter and the trainer's snapshot replays it; on the fused
    driver two faults exhaust the step's inner retry ladder (2 attempts)
    and FaultTolerantStep replays the step.  The run ends on the
    parameters of the run without faults, bit for bit, and the JAX
    eager loop, under the eager plan, replays too."""
    monkeypatch.setenv("MXNET_TPU_RETRY_MAX", "2")
    _, clean = _pair()
    clean.fit(_data(tmx), epochs=1, steps_per_call=k)
    _, faulted = _pair()
    eager_plan = {"execute": ["ok", "unavailable"]}
    plan = eager_plan if k is None else \
        {"execute": ["ok", "unavailable", "unavailable"]}
    with rs.FaultPlan(plan):
        faulted.fit(_data(tmx), epochs=1, steps_per_call=k,
                    resume_on_fault=2)
    assert rs.counters.replays == 1
    for name, v in _params(clean).items():
        assert np.array_equal(_params(faulted)[name], v), name
    je, _ = _pair()
    with jrs.FaultPlan(eager_plan):
        je.fit(_data(jmx), epochs=1, resume_on_fault=2)
    assert jrs.counters.replays == 1
    _close_params(faulted, je)


def test_elastic_fit_runs_the_fused_driver(tmp_path):
    """``fit(elastic=...)`` runs the fused driver under ElasticTrainStep
    (K = 1 included) on a mesh of the visible devices and trains every
    batch, with the step-0 anchor and the cadence points durable."""
    _, te = _pair()
    te.fit(_data(tmx), elastic={"directory": str(tmp_path / "ck"),
                                "every": 2})
    (wrapper,) = te._fused_steps.values()
    assert isinstance(wrapper, rs.ElasticTrainStep)
    assert wrapper.step._num_update == 4 and wrapper.reformations == 0
    wrapper.finish()
    assert wrapper.checkpointer.latest()[1] == 4
    wrapper.close()


def test_logging_and_gradient_update_handlers(caplog):
    """LoggingHandler logs the interval's samples/sec and the metrics;
    GradientUpdateHandler steps the trainer by the loss's length."""
    _, te = _pair()
    with caplog.at_level(logging.INFO, logger="mxnet_tpu_torch.estimator"):
        te.fit(_data(tmx), epochs=1, event_handlers=[
            test_.LoggingHandler(log_interval=2,
                                 metrics=[te.train_loss_metric])])
    text = caplog.text
    assert "Training begin" in text and "samples/sec" in text
    assert "epoch[0] batch[2]" in text and "Training end" in text
    calls = []
    te.trainer.step = lambda n: calls.append(n)
    test_.GradientUpdateHandler().batch_end(te, loss=tmx.nd.ones((5,)))
    assert calls == [5]
