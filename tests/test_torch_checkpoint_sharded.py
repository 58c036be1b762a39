"""Port parity: the ZeRO-sharded optimizer checkpoints of
``mxnet_tpu_torch/checkpoint.py`` against ``tests/test_checkpoint_sharded.py``
(the cases at lines 137-332), on 8 CPU mesh positions.

A kvstore's sharded Adam slots are saved in the port's format
(``tree.json`` and raw files) with the JAX package's ``meta.json`` keys; a
fresh store resumes bit for bit at the same ``dp`` and after a
re-partition onto another (8 → 4, and back to 8 with the payload
unchanged); a truncated shard, a tampered ``meta.json`` and a torn write
raise :class:`CheckpointCorruptError` naming the file or leave the old
checkpoint loadable; the load needs the optimizer.  A sharded
``CompiledTrainStep``'s ``TrainStepCheckpoint`` stores each slot at its
parameter's global shape, so a restore onto another ``dp`` continues bit
for bit.  Every comparison here is port-internal and bitwise.
"""
import contextlib
import json
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import checkpoint as jckpt
from mxnet_tpu import kvstore as jkv
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.parallel import make_mesh as jmake_mesh

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import checkpoint as ckpt_mod
from mxnet_tpu_torch import kvstore as tkv
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.checkpoint import (MANIFEST_NAME, CheckpointCorruptError,
                                        TrainStepCheckpoint,
                                        load_sharded_optimizer,
                                        save_sharded_optimizer)
from mxnet_tpu_torch.executor import CompiledTrainStep
from mxnet_tpu_torch.ndarray.ndarray import NDArray
from mxnet_tpu_torch.parallel import DeviceMesh

CPU8 = [torch.device("cpu")] * 8
SHAPES = [(37,), (16, 3), (5,), (64,), (7, 7)]  # 203 elements: odd partition
KEYS = list(range(len(SHAPES)))


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


@pytest.fixture(autouse=True)
def _sharded_env(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_SHARD", "1")
    monkeypatch.setenv("MXNET_KVSTORE_BUCKET_KB", "2")


def _mesh(dp):
    return DeviceMesh({"dp": dp}, devices=CPU8[:dp])


def _grads(steps, start=0):
    rng = np.random.RandomState(11)
    every = [[rng.randint(-4, 5, s).astype(np.float32) for s in SHAPES]
             for _ in range(6)]
    return every[start:start + steps]


def _nd(a):
    return NDArray(torch.from_numpy(np.array(a, np.float32)), tmx.cpu())


def _store(init):
    kv = tkv.create("dist_tpu_sync")
    kv.set_optimizer(topt.create("adam", learning_rate=0.05))
    kv.init(KEYS, [_nd(v) for v in init])
    return kv


def _push(kv, grads):
    for g in grads:
        kv.push(KEYS, [[_nd(a)] for a in g], priority=[-k for k in KEYS])


def _pull(kv):
    return [kv.pull(k)._data.numpy().copy() for k in KEYS]


def _init():
    return [np.ones(s, np.float32) for s in SHAPES]


def _equal(a, b):
    return len(a) == len(b) and all(np.array_equal(u, v) for u, v in zip(a, b))


def test_sharded_optimizer_save_resume_same_dp(tmp_path):
    """A fresh store with ``load_sharded_optimizer`` resumes the exact
    trajectory (the slots and the per-key counts): steps 5-6 after the
    resume are bit for bit an uninterrupted 6-step run."""
    with _mesh(8):
        ref = _store(_init())
        _push(ref, _grads(6))
        want = _pull(ref)
        a = _store(_init())
        _push(a, _grads(4))
        mid = _pull(a)
        save_sharded_optimizer(str(tmp_path / "opt"), a)
        assert os.path.exists(str(tmp_path / "opt") + ".meta.json")
        b = _store(mid)
        load_sharded_optimizer(str(tmp_path / "opt"), b)
        assert b._optimizer._index_update_count[0] == 4
        _push(b, _grads(2, start=4))
        assert _equal(want, _pull(b))


def test_sharded_optimizer_resharding_roundtrip(tmp_path):
    """A dp = 8 save re-partitions onto dp = 4 (padding stripped and laid
    again), training goes on bit for bit, and the dp = 4 save loaded back
    onto dp = 8 holds the payload unchanged."""
    with _mesh(8):
        ref = _store(_init())
        _push(ref, _grads(6))
        want = _pull(ref)
        a = _store(_init())
        _push(a, _grads(4))
        mid = _pull(a)
        save_sharded_optimizer(str(tmp_path / "o8"), a)
    with _mesh(4):
        c = _store(mid)
        load_sharded_optimizer(str(tmp_path / "o8"), c)
        for sig, shards in c._shard_engine._states.items():
            payload = sum(int(np.prod(s)) for _sk, s in sig[1:])
            assert len(shards) == 4
            for leaf in shards[0]:
                assert 0 <= leaf.numel() * 4 - payload < 4
        _push(c, _grads(2, start=4))
        got4 = _pull(c)
        save_sharded_optimizer(str(tmp_path / "o4"), c)
    assert _equal(want, got4)
    with _mesh(8):
        d = _store(got4)
        load_sharded_optimizer(str(tmp_path / "o4"), d)
        ref_states = ref._shard_engine._states
        for sig, shards in d._shard_engine._states.items():
            payload = sum(int(np.prod(s)) for _sk, s in sig[1:])
            for slot in range(2):
                got = torch.cat([s[slot] for s in shards])[:payload]
                exp = torch.cat([s[slot] for s in ref_states[sig]])[:payload]
                assert torch.equal(got, exp)


def test_sharded_truncated_shard_raises_named(tmp_path):
    with _mesh(8):
        a = _store(_init())
        _push(a, _grads(1))
        path = save_sharded_optimizer(str(tmp_path / "o"), a)
        victim, size = None, -1
        for root, _dirs, names in os.walk(path):
            for name in names:
                full = os.path.join(root, name)
                if name != MANIFEST_NAME and os.path.getsize(full) > size:
                    victim, size = full, os.path.getsize(full)
        with open(victim, "r+b") as f:
            f.truncate(size // 2)
        with pytest.raises(CheckpointCorruptError,
                           match=os.path.basename(victim)):
            load_sharded_optimizer(path, _store(_init()))


def test_sharded_tampered_meta_sidecar_raises(tmp_path):
    """``meta.json`` inside the tree is covered by the manifest: one digit
    changed (the signatures and ``dp`` drive the re-partition) refuses
    the load, naming the file."""
    with _mesh(8):
        a = _store(_init())
        _push(a, _grads(1))
        path = save_sharded_optimizer(str(tmp_path / "o"), a)
        meta = os.path.join(path, "meta.json")
        raw = open(meta, "rb").read()
        assert b'"dp": 8' in raw
        with open(meta, "wb") as f:
            f.write(raw.replace(b'"dp": 8', b'"dp": 4', 1))
        with pytest.raises(CheckpointCorruptError, match="meta"):
            load_sharded_optimizer(path, _store(_init()))


def test_sharded_torn_write_leaves_no_final_path(tmp_path, monkeypatch):
    """A save that dies before its publish leaves no final path; one that
    dies while replacing a good checkpoint leaves the old one loadable."""
    def boom(*_a, **_k):
        raise OSError("disk died mid-manifest")

    with _mesh(8):
        a = _store(_init())
        _push(a, _grads(1))
        with monkeypatch.context() as m:
            m.setattr(ckpt_mod, "write_manifest", boom)
            with pytest.raises(OSError):
                save_sharded_optimizer(str(tmp_path / "o"), a)
        assert not os.path.exists(str(tmp_path / "o"))
        path = save_sharded_optimizer(str(tmp_path / "o"), a)
        _push(a, _grads(1, start=1))
        with monkeypatch.context() as m:
            m.setattr(ckpt_mod, "write_manifest", boom)
            with pytest.raises(OSError):
                save_sharded_optimizer(path, a, force=True)
        b = _store(_init())
        load_sharded_optimizer(path, b)
        assert b._optimizer._index_update_count[0] == 1
        with pytest.raises(MXNetError, match="exists"):
            save_sharded_optimizer(path, a)


def test_load_sharded_optimizer_requires_optimizer(tmp_path):
    with _mesh(8):
        a = _store(_init())
        _push(a, _grads(1))
        save_sharded_optimizer(str(tmp_path / "o"), a)
        with pytest.raises(MXNetError, match="set_optimizer"):
            load_sharded_optimizer(str(tmp_path / "o"),
                                   tkv.create("dist_tpu_sync"))


def test_meta_keys_match_the_jax_package(tmp_path):
    """``meta.json`` carries the JAX package's keys, with the same
    signatures, ``dp`` and counts for the same pushes."""
    with _mesh(8):
        a = _store(_init())
        _push(a, _grads(2))
        path = save_sharded_optimizer(str(tmp_path / "t"), a)
    with jmake_mesh({"dp": 8}):
        kv = jkv.create("dist_tpu_sync")
        kv.set_optimizer(jopt.create("adam", learning_rate=0.05))
        kv.init(KEYS, [jmx.nd.array(v) for v in _init()])
        for g in _grads(2):
            kv.push(KEYS, [[jmx.nd.array(x)] for x in g],
                    priority=[-k for k in KEYS])
        jpath = jckpt.save_sharded_optimizer(str(tmp_path / "j"), kv)
    ours = json.load(open(os.path.join(path, "meta.json")))
    theirs = json.load(open(os.path.join(jpath, "meta.json")))
    assert sorted(ours) == sorted(theirs) == ["counts", "dp", "none",
                                              "num_update", "signatures"]
    for key in ("dp", "num_update", "none", "counts"):
        assert ours[key] == theirs[key], key
    assert [[s[0][1]] + s[1:] for s in ours["signatures"]] == \
        [[s[0][1]] + s[1:] for s in theirs["signatures"]]


# ------------------------------------------------- a sharded training step
def _step(mesh, seed=0, shard=True):
    rng = np.random.RandomState(seed)
    net = torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.ReLU(),
                              torch.nn.Linear(16, 3))
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.from_numpy(rng.uniform(-0.4, 0.4, tuple(p.shape))
                                     .astype(np.float32)))
    return CompiledTrainStep(net, lambda o, y: (o - y).square().mean(1),
                             topt.create("adam", learning_rate=0.05),
                             batch_size=8, mesh=mesh,
                             shard_optimizer_state=shard), net


def _batches(n):
    rng = np.random.RandomState(4)
    return [(torch.from_numpy(rng.randn(8, 6).astype(np.float32)),
             torch.from_numpy(rng.randn(8, 3).astype(np.float32)))
            for _ in range(n)]


def _leaves(step):
    return [t for st in step.optimizer_states() for t in st]


def test_train_step_checkpoint_of_a_sharded_step_reslices(tmp_path):
    """A sharded step on dp = 8 saved after 2 steps stores each Adam slot
    at its parameter's shape.  Restored into a dp = 4 sharded step built
    from other weights (in place: no tensor moves), its slots are the
    saved ones, and 2 more steps end bit for bit where the same checkpoint
    restored into a replicated dp = 4 step ends."""
    batches = _batches(4)
    with _env(MXNET_KVSTORE_BUCKET_KB="1"):
        a, _ = _step(_mesh(8))
        for b in batches[:2]:
            a(*b)
        TrainStepCheckpoint(a).save(str(tmp_path / "ck"))
        tree = json.load(open(tmp_path / "ck" / "tree.json"))["tree"]
        slots = tree["dict"]["opt_state"]["dict"]["p0"]["list"]
        assert [s["shape"] for s in slots] == [[16, 6], [16, 6]]
        c, c_net = _step(_mesh(4), seed=9)
        d, d_net = _step(_mesh(4), seed=8, shard=False)
        addrs = [t.data_ptr() for s in c._states for st in s for t in st]
        for step in (c, d):
            TrainStepCheckpoint(step).restore(str(tmp_path / "ck"))
        assert addrs == [t.data_ptr() for s in c._states for st in s
                         for t in st]
        assert c._num_update == d._num_update == 2
        for u, v in zip(_leaves(a), _leaves(c)):
            assert torch.equal(u, v)
        for b in batches[2:]:
            c(*b)
            d(*b)
    for p, q in zip(c_net.parameters(), d_net.parameters()):
        assert torch.equal(p, q)
    for u, v in zip(_leaves(c), _leaves(d)):
        assert torch.equal(u, v)
