"""Port parity: the checkpoint half of ``mxnet_tpu_torch.resilience.elastic``
against ``mxnet_tpu/resilience/elastic.py``, on CPU tensors.

From ``tests/test_elastic.py``, the cases that need no mesh: an
``AsyncCheckpointer`` driven at its cadence leaves durable
``step-NNNNNNNN`` checkpoints (the step-0 anchor, then every window); a
fresh step built from other weights, restored by
``load_elastic_checkpoint`` (in place: no tensor moves) and fed the
remaining batches, ends bit for bit where the uninterrupted run ends,
dropout included (``meta.json`` carries the random streams), and within
1e-6 of each tensor's largest |value| of the JAX package's uninterrupted
trajectory without dropout; the write is off the critical path (a
slowed writer does not slow the steps between cadence points, and the
wait at a cadence point is the goodput ``checkpoint`` bucket); torn,
truncated and bit-flipped checkpoints are never loaded or selected;
cadence rounding and a zero cadence; ``ElasticTrainStep`` needs a
directory (its reformations are in ``test_torch_elastic.py``).
"""
import json
import os
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.executor import CompiledTrainStep as JaxTrainStep
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JaxCE

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import optimizer as opt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.checkpoint import MANIFEST_NAME, CheckpointCorruptError
from mxnet_tpu_torch.executor import CompiledTrainStep
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.observability import goodput
from mxnet_tpu_torch.resilience import ElasticTrainStep
from mxnet_tpu_torch.resilience.elastic import (AsyncCheckpointer,
                                                latest_checkpoint,
                                                load_elastic_checkpoint)

REL = 1e-6
N_STEPS = 4
CADENCE = 2


def _jax_net(seed=0):
    jmx.random.seed(seed)
    net = jnn.HybridSequential()
    net.add(jnn.Dense(16, activation="relu", in_units=6))
    net.add(jnn.Dense(3, in_units=16))
    net.collect_params().initialize()
    return net


def _net(seed=0, dropout=0.25, jax_net=None):
    jnet = jax_net or _jax_net(seed)
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu", in_units=6, device="cpu"))
        if dropout:
            net.add(nn.Dropout(dropout, generator=mx.random.generator(
                seed + 1000, "cpu")))
        net.add(nn.Dense(3, in_units=16, device="cpu"))
    with torch.no_grad():
        for jp, t in zip(jnet.collect_params().values(), net.parameters()):
            t.copy_(torch.from_numpy(jp.data().asnumpy().copy()))
    return net


def _batches(n=N_STEPS):
    rng = np.random.RandomState(7)
    return [(rng.uniform(size=(8, 6)).astype(np.float32),
             rng.randint(0, 3, (8,)).astype(np.float32)) for _ in range(n)]


def _t(pair):
    return torch.from_numpy(pair[0]), torch.from_numpy(pair[1])


def _step(net):
    return CompiledTrainStep(net, SoftmaxCrossEntropyLoss(),
                             opt.create("adam", learning_rate=0.05),
                             batch_size=8)


def _world(step):
    from mxnet_tpu_torch.executor import _leaves
    return ([t.detach().clone() for t in step._learnable]
            + [t.detach().clone() for s in step._states for t in _leaves(s)])


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))


def _drive(step, ck, batches):
    """ElasticTrainStep's cadence: the step-0 anchor, then a save at
    every due step count; drained at the end."""
    ck.save(step)
    for b in batches:
        step(*_t(b))
        if ck.due(step._num_update):
            ck.save(step)
    ck.wait()


def _uninterrupted(tmp_path, dropout=0.25):
    net = _net(dropout=dropout)
    step = _step(net)
    ck = AsyncCheckpointer(str(tmp_path / "ckpt"), every=CADENCE)
    try:
        _drive(step, ck, _batches())
    finally:
        ck.close()
    return step, ck


def test_cadence_leaves_durable_checkpoints(tmp_path):
    step, ck = _uninterrupted(tmp_path)
    d = str(tmp_path / "ckpt")
    assert sorted(os.listdir(d)) == [f"step-{i:08d}" for i in (0, 2, 4)]
    assert latest_checkpoint(d) == (os.path.join(d, "step-00000004"), 4)
    assert [w["step"] for w in ck.writes] == [0, 2, 4]
    nbytes = sum(t.numel() * 4 for t in _world(step))
    assert all(w["bytes"] == nbytes for w in ck.writes)
    assert len(ck.waits) == 3
    with open(os.path.join(d, "step-00000004", "meta.json")) as f:
        meta = json.load(f)
    assert meta["step"] == 4 and meta["opt_num_update"] == 4
    assert meta["world_dp"] == 1 and len(meta["rng_states"]) == 2
    assert os.path.exists(os.path.join(d, "step-00000004", MANIFEST_NAME))
    assert not [n for n in os.listdir(d) if n.startswith(".tmp")]


@pytest.mark.parametrize("dropout", [0.0, 0.25])
def test_resume_in_a_fresh_step_is_bitwise(tmp_path, dropout):
    step, _ = _uninterrupted(tmp_path, dropout)
    ref = _world(step)
    fresh = _step(_net(seed=99, dropout=dropout))
    fresh(*_t(_batches()[0]))          # warmed on purpose: overwritten
    ptrs = [t.data_ptr() for t in fresh._learnable]
    meta = load_elastic_checkpoint(
        str(tmp_path / "ckpt" / "step-00000002"), fresh)
    assert meta["step"] == 2 and fresh._num_update == 2
    assert fresh._opt.num_update == 2
    assert [t.data_ptr() for t in fresh._learnable] == ptrs
    for b in _batches()[2:]:
        fresh(*_t(b))
    assert _equal(_world(fresh), ref)
    if dropout:
        return
    jnet = _jax_net()
    jstep = JaxTrainStep(jnet, JaxCE(), jopt.create("adam", learning_rate=0.05),
                         batch_size=8)
    for x, y in _batches():
        jstep(jmx.nd.array(x), jmx.nd.array(y))
    for jp, t in zip(jnet.collect_params().values(), fresh._learnable):
        want = jp.data().asnumpy()
        err = float(np.abs(t.detach().numpy() - want).max())
        assert err <= REL * float(np.abs(want).max()), jp.name


class _SlowCheckpointer(AsyncCheckpointer):
    """Writer slowed so that blocking on it would show."""

    DELAY = 0.5

    def _write(self, tree, meta, ready=None):
        time.sleep(self.DELAY)
        super()._write(tree, meta, ready)


def test_async_checkpoint_off_critical_path(tmp_path):
    step = _step(_net())
    ck = _SlowCheckpointer(str(tmp_path / "ck"), every=3)
    led = goodput.train()
    waited0 = led.totals()["buckets"].get("checkpoint", 0.0)
    try:
        ck.save(step)
        durations = []
        for b in _batches(6):
            t0 = time.perf_counter()
            step(*_t(b))
            if ck.due(step._num_update):
                ck.save(step)
            durations.append(time.perf_counter() - t0)
        # steps 2, 4 and 5 are not cadence points: a write is in flight
        # underneath them, and they must not wait for it
        for i in (1, 3, 4):
            assert durations[i] < _SlowCheckpointer.DELAY * 0.8, (i, durations)
        ck.wait()
        assert latest_checkpoint(str(tmp_path / "ck"))[1] == 6
    finally:
        ck.close()
    waited = led.totals()["buckets"].get("checkpoint", 0.0) - waited0
    assert waited == pytest.approx(sum(ck.waits), abs=1e-9)


def test_torn_elastic_checkpoint_never_selected(tmp_path):
    step, _ = _uninterrupted(tmp_path)
    d = str(tmp_path / "ckpt")
    os.remove(os.path.join(d, "step-00000004", MANIFEST_NAME))
    assert latest_checkpoint(d)[1] == 2
    victim = os.path.join(d, "step-00000002", "params", "p0.bin")
    with open(victim, "r+b") as f:
        f.truncate(1)
    assert latest_checkpoint(d)[1] == 0
    with pytest.raises(CheckpointCorruptError, match="p0.bin"):
        load_elastic_checkpoint(os.path.join(d, "step-00000002"), step)
    with pytest.raises(CheckpointCorruptError):
        load_elastic_checkpoint(os.path.join(d, "step-00000004"), step)
    os.makedirs(os.path.join(d, "step-00000009"))
    os.makedirs(os.path.join(d, ".tmp-step-00000010-1"))
    assert latest_checkpoint(d)[1] == 0


def test_bitflip_in_meta_fails_its_hash(tmp_path):
    step, _ = _uninterrupted(tmp_path)
    meta = str(tmp_path / "ckpt" / "step-00000002" / "meta.json")
    with open(meta, "r+b") as f:
        f.seek(1)
        byte = f.read(1)
        f.seek(1)
        f.write(bytes([byte[0] ^ 0x01]))
    with pytest.raises(CheckpointCorruptError, match="meta.json"):
        load_elastic_checkpoint(os.path.dirname(meta), step)


def test_cadence_rounds_to_call_boundary_not_lcm():
    ck = AsyncCheckpointer.__new__(AsyncCheckpointer)   # due() is pure
    ck.every = 8
    ck._last_saved_step = 0
    assert not ck.due(3) and not ck.due(6)
    assert ck.due(9)
    ck._last_saved_step = 9
    assert not ck.due(12) and not ck.due(15) and ck.due(18)
    ck._last_saved_step = None
    assert ck.due(0)
    ck.every = 0
    assert not ck.due(100)


def test_zero_cadence_writes_only_the_anchor(tmp_path):
    step = _step(_net())
    ck = AsyncCheckpointer(str(tmp_path / "ck"), every=0)
    try:
        _drive(step, ck, _batches())
    finally:
        ck.close()
    assert os.listdir(str(tmp_path / "ck")) == ["step-00000000"]
    with pytest.raises(MXNetError, match="closed"):
        ck.save(step)


def test_failed_write_surfaces_on_the_train_thread(tmp_path):
    class _Broken(AsyncCheckpointer):
        def _write(self, tree, meta, ready=None):
            raise OSError("disk full")

    step = _step(_net())
    ck = _Broken(str(tmp_path / "ck"), every=1)
    try:
        ck.save(step)
        with pytest.raises(MXNetError, match="disk full"):
            ck.wait()
    finally:
        ck.close()


def test_elastic_train_step_needs_a_directory(monkeypatch):
    """ElasticTrainStep's checkpointer needs a directory (here or in
    MXNET_TPU_ELASTIC_DIR), as AsyncCheckpointer does; the reformations
    are in ``test_torch_elastic.py``."""
    from mxnet_tpu_torch.resilience import ElasticConfig
    monkeypatch.delenv("MXNET_TPU_ELASTIC_DIR", raising=False)
    with pytest.raises(MXNetError, match="directory"):
        ElasticTrainStep(lambda mesh: _step(_net(dropout=0)),
                         config=ElasticConfig(every=2))
    with pytest.raises(MXNetError, match="directory"):
        AsyncCheckpointer("")


def test_checkpointer_reads_the_elastic_knobs(monkeypatch, tmp_path):
    """The two knobs the checkpoint half reads, under the JAX names and
    defaults: the directory (when none is passed) and the cadence."""
    from mxnet_tpu.base import env as jenv
    from mxnet_tpu_torch.base import env
    for name in ("MXNET_TPU_ELASTIC_DIR", "MXNET_TPU_ELASTIC_CKPT_STEPS"):
        monkeypatch.delenv(name, raising=False)
        assert getattr(env, name) == getattr(jenv, name)
    with pytest.raises(MXNetError, match="MXNET_TPU_ELASTIC_DIR"):
        AsyncCheckpointer()
    monkeypatch.setenv("MXNET_TPU_ELASTIC_DIR", str(tmp_path / "env"))
    monkeypatch.setenv("MXNET_TPU_ELASTIC_CKPT_STEPS", "5")
    ck = AsyncCheckpointer()
    try:
        assert ck.directory == str(tmp_path / "env") and ck.every == 5
        assert os.path.isdir(ck.directory)
    finally:
        ck.close()
