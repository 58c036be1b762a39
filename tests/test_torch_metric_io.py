"""Port parity: ``mx.metric``, ``mx.io.NDArrayIter`` and
``mx.lr_scheduler`` against mxnet_tpu's, on the CPU.

Every ported metric takes the same three seeded batches in both packages
and reports the same local and global values; every ``NDArrayIter``
option walks two epochs and gives the same batches, pads and indices,
``shuffle`` under the same ``numpy.random`` seed included; every
scheduler gives the same rate at updates 0-50.

Tolerance: the metrics compute in numpy on both sides, over the same
fp32 arrays, so their values agree within 1e-6 relative (the order of
numpy's float64 sums is the same; the slack covers float32 inputs read
back through another array type); batches and rates are compared
exactly.
"""
import numpy as np
import pytest

from mxnet_tpu import io as jio
from mxnet_tpu import lr_scheduler as jls
from mxnet_tpu import metric as jmetric
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import lr_scheduler as tls
from mxnet_tpu_torch import metric as tmetric
from mxnet_tpu_torch import nd as tnd

REL = 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = mx.set_default_context(mx.cpu())
    yield
    mx.set_default_context(prev)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
def _classes(rng, n=12, c=5):
    probs = rng.dirichlet(np.ones(c), n).astype(np.float32)
    return [rng.randint(0, c, n).astype(np.float32)], [probs]


def _binary(rng, n=12):
    return ([rng.randint(0, 2, n).astype(np.float32)],
            [rng.rand(n, 2).astype(np.float32)])


def _regression(rng, n=12):
    return ([rng.randn(n, 3).astype(np.float32)],
            [rng.randn(n, 3).astype(np.float32)])


def _losses(rng, n=12):
    return [None], [rng.rand(n).astype(np.float32)]


def _custom(label, pred):
    return float(np.abs(label - pred.argmax(axis=1)).sum()), label.size


METRICS = {
    "accuracy": (lambda m: m.Accuracy(), _classes),
    "top_k_accuracy": (lambda m: m.TopKAccuracy(top_k=3), _classes),
    "f1_macro": (lambda m: m.F1(), _binary),
    "f1_micro": (lambda m: m.F1(average="micro"), _binary),
    "perplexity": (lambda m: m.Perplexity(), _classes),
    "perplexity_ignore": (lambda m: m.Perplexity(ignore_label=0), _classes),
    "mae": (lambda m: m.MAE(), _regression),
    "mse": (lambda m: m.MSE(), _regression),
    "rmse": (lambda m: m.RMSE(), _regression),
    "cross_entropy": (lambda m: m.CrossEntropy(), _classes),
    "nll": (lambda m: m.NegativeLogLikelihood(), _classes),
    "loss": (lambda m: m.Loss(), _losses),
    "composite": (lambda m: m.CompositeEvalMetric(["acc", "ce"]), _classes),
    "create_by_name": (lambda m: m.create("top_k_acc", top_k=2), _classes),
    "create_custom": (lambda m: m.create(_custom), _classes),
}


def _arrays(nd, values):
    return [None if v is None else nd.array(v) for v in values]


@pytest.mark.parametrize("case", sorted(METRICS))
def test_metric_matches_jax(case):
    make, data = METRICS[case]
    jm, tm = make(jmetric), make(tmetric)
    rng = np.random.RandomState(sorted(METRICS).index(case))
    batches = [data(rng) for _ in range(3)]
    for i, (labels, preds) in enumerate(batches):
        if i == 2:
            jm.reset_local()
            tm.reset_local()
        jm.update(_arrays(jnd, labels), _arrays(jnd, preds))
        tm.update(_arrays(tnd, labels), _arrays(tnd, preds))
    if case == "composite":
        # the reference's composite has no global value of its own (its
        # reset never sets one); the port's gathers its members'
        ref_global = tuple(list(x) for x in zip(*[m.get_global()
                                                  for m in jm.metrics]))
    else:
        ref_global = jm.get_global()
    for got, ref in ((tm.get(), jm.get()), (tm.get_global(), ref_global)):
        assert got[0] == ref[0]
        np.testing.assert_allclose(np.asarray(got[1], np.float64),
                                   np.asarray(ref[1], np.float64), rtol=REL)
    (tn, tv), (jn, jv) = (zip(*tm.get_name_value()),
                          zip(*jm.get_name_value()))
    assert tn == jn
    np.testing.assert_allclose(tv, jv, rtol=REL)
    tm.reset()
    assert np.isnan(np.asarray(tm.get()[1], np.float64)).all()


# ---------------------------------------------------------------------------
# NDArrayIter
# ---------------------------------------------------------------------------
ITERS = [(handle, shuffle) for handle in ("pad", "discard", "roll_over")
         for shuffle in (False, True)]


def _walk(it, epochs=2):
    out = []
    for _ in range(epochs):
        for batch in it:
            out.append(([d.asnumpy() for d in batch.data],
                        [l.asnumpy() for l in batch.label], batch.pad,
                        None if batch.index is None else
                        np.asarray(batch.index)))
        it.reset()
    return out


@pytest.mark.parametrize("handle,shuffle", ITERS)
def test_ndarray_iter_matches_jax(handle, shuffle):
    """10 samples in batches of 4, two epochs: the same batches, labels,
    pads and indices; with ``shuffle`` the same order from the same numpy
    seed."""
    rng = np.random.RandomState(9)
    data = rng.rand(10, 3, 2).astype(np.float32)
    label = np.arange(10, dtype=np.float32)
    walks, descs = [], []
    for io, nd in ((jio, jnd), (tio, tnd)):
        np.random.seed(17)
        it = io.NDArrayIter(nd.array(data), nd.array(label), batch_size=4,
                            shuffle=shuffle, last_batch_handle=handle)
        descs.append([(d.name, d.shape) for d in it.provide_data
                      + it.provide_label])
        walks.append(_walk(it))
    assert descs[1] == descs[0]
    assert len(walks[1]) == len(walks[0])
    for (jd, jl, jp, ji), (td, tl, tp, ti) in zip(*walks):
        assert tp == jp
        np.testing.assert_array_equal(ti, ji)
        for got, ref in zip(td + tl, jd + jl):
            np.testing.assert_array_equal(got, ref)


def test_ndarray_iter_named_inputs_and_context():
    """A dict of inputs keeps its names; numpy inputs become arrays on the
    iterator's context, NDArray inputs stay on theirs."""
    rng = np.random.RandomState(3)
    a, b = rng.rand(6, 2).astype(np.float32), rng.rand(6).astype(np.float64)
    for io in (jio, tio):
        it = io.NDArrayIter({"x": a, "y": b}, batch_size=3)
        assert [d.name for d in it.provide_data] == ["x", "y"]
        batch = it.next()
        assert [d.shape for d in batch.data] == [(3, 2), (3,)]
        assert str(batch.data[1].dtype) == "float32"
    it = tio.NDArrayIter(tnd.array(a), batch_size=3)
    assert it.ctx == mx.cpu() and it.next().data[0].context == mx.cpu()


# ---------------------------------------------------------------------------
# learning-rate schedulers
# ---------------------------------------------------------------------------
SCHEDULERS = {
    "factor": lambda ls: ls.FactorScheduler(step=5, factor=0.7,
                                            stop_factor_lr=0.02,
                                            base_lr=0.1),
    "factor_warmup": lambda ls: ls.FactorScheduler(
        step=3, factor=0.9, base_lr=0.1, warmup_steps=6,
        warmup_begin_lr=0.01),
    "multifactor": lambda ls: ls.MultiFactorScheduler(
        step=[10, 20, 35], factor=0.5, base_lr=0.2),
    "multifactor_warmup": lambda ls: ls.MultiFactorScheduler(
        step=[10, 20], factor=0.1, base_lr=0.2, warmup_steps=5,
        warmup_mode="constant", warmup_begin_lr=0.05),
    "poly": lambda ls: ls.PolyScheduler(max_update=40, base_lr=0.1, pwr=2,
                                        final_lr=0.01),
    "poly_warmup": lambda ls: ls.PolyScheduler(
        max_update=40, base_lr=0.1, pwr=1, warmup_steps=8),
    "cosine": lambda ls: ls.CosineScheduler(max_update=40, base_lr=0.1,
                                            final_lr=0.001),
    "cosine_warmup": lambda ls: ls.CosineScheduler(
        max_update=45, base_lr=0.3, warmup_steps=10, warmup_begin_lr=0.0),
}


@pytest.mark.parametrize("case", sorted(SCHEDULERS))
def test_lr_scheduler_matches_jax(case):
    jsched, tsched = SCHEDULERS[case](jls), SCHEDULERS[case](tls)
    got = [tsched(n) for n in range(51)]
    assert got == [jsched(n) for n in range(51)]
    assert len(set(got)) > 1
