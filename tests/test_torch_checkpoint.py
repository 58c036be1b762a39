"""Port parity: ``mxnet_tpu_torch.checkpoint`` against
``mxnet_tpu/checkpoint.py``, on CPU tensors.

The non-sharded cases of ``tests/test_checkpoint_sharded.py``: a tree
round trip (the port's own format: ``tree.json`` and one raw file per
tensor, bfloat16 as its int16 bits, nothing pickled) and the exact resume
of a training step from a :class:`TrainStepCheckpoint` in a fresh step
whose weights were other (bit for bit the uninterrupted port run, and
within 1e-6 of each tensor's largest |value| of the JAX package's
four-step trajectory from the same weights and batches).  The restore
writes in place: every tensor keeps its address.  The layout names are the
JAX package's; the manifest catches a truncated file (naming it) and a
flipped bit; ``force`` keeps its meaning; the ZeRO-sharded functions need
a stepped store (their round trips are in
``test_torch_checkpoint_sharded.py``).
"""
import json
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.checkpoint import TrainStepCheckpoint as JaxCheckpoint
from mxnet_tpu.executor import CompiledTrainStep as JaxTrainStep

from mxnet_tpu_torch import optimizer as opt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.checkpoint import (MANIFEST_NAME, CheckpointCorruptError,
                                        TrainStepCheckpoint, load_pytree,
                                        load_sharded_optimizer, save_pytree,
                                        save_sharded_optimizer, verify_manifest)
from mxnet_tpu_torch.executor import CompiledTrainStep
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

REL = 1e-6


def _jax_build(seed=0):
    jmx.random.seed(seed)
    net = jgluon.nn.HybridSequential()
    with net.name_scope():
        net.add(jgluon.nn.Dense(32, activation="relu", in_units=16,
                                prefix="fc1_"))
        net.add(jgluon.nn.Dense(8, in_units=32, prefix="fc2_"))
    net.collect_params().initialize()
    return net


def _build(seed=0, jax_net=None):
    """The port twin of :func:`_jax_build`, its weights copied in."""
    jnet = jax_net or _jax_build(seed)
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(32, activation="relu", in_units=16, prefix="fc1_",
                         device="cpu"))
        net.add(nn.Dense(8, in_units=32, prefix="fc2_", device="cpu"))
    with torch.no_grad():
        for jp, t in zip(jnet.collect_params().values(), net.parameters()):
            t.copy_(torch.from_numpy(jp.data().asnumpy().copy()))
    return net


def _data(seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(8, 16).astype(np.float32),
            rng.randint(0, 8, (8,)).astype(np.float32))


def _step_for(net):
    return CompiledTrainStep(net, SoftmaxCrossEntropyLoss(),
                             opt.create("adam", learning_rate=1e-3),
                             batch_size=8)


def _flat(step):
    from mxnet_tpu_torch.executor import _leaves
    return ([p.detach().clone() for p in step._learnable]
            + [t.detach().clone() for s in step._states for t in _leaves(s)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_pytree_roundtrip(tmp_path, dtype):
    dt = getattr(torch, dtype)
    tree = {"a": torch.arange(6).reshape(2, 3).to(dt),
            "b": {"c": torch.ones(4, dtype=dt), "n": 7, "s": "x"},
            "l": [None, torch.full((3,), -2.5).to(dt), [1.5]]}
    path = str(tmp_path / "t")
    save_pytree(path, tree)
    assert verify_manifest(path, required=True)
    with open(os.path.join(path, "tree.json")) as f:
        index = json.load(f)
    assert index["tree"]["dict"]["a"]["dtype"] == dtype
    assert sorted(os.listdir(path)) == sorted(
        ["tree.json", MANIFEST_NAME, "a.bin", "b", "l"])
    back = load_pytree(path)
    for got, want in ((back["a"], tree["a"]), (back["b"]["c"], tree["b"]["c"]),
                      (back["l"][1], tree["l"][1])):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert back["b"]["n"] == 7 and back["b"]["s"] == "x"
    assert back["l"][0] is None and back["l"][2] == [1.5]
    like = load_pytree(path, {"a": torch.zeros(2, 3, dtype=torch.float64)})
    assert like["a"].dtype == torch.float64


def test_bf16_file_holds_the_int16_bits(tmp_path):
    t = torch.tensor([1.0, -2.0, 3.140625], dtype=torch.bfloat16)
    save_pytree(str(tmp_path / "t"), {"w": t})
    raw = np.fromfile(str(tmp_path / "t" / "w.bin"), dtype=np.int16)
    np.testing.assert_array_equal(raw, t.view(torch.int16).numpy())


def test_force_and_bad_leaves(tmp_path):
    path = str(tmp_path / "t")
    save_pytree(path, {"a": torch.ones(2)})
    with pytest.raises(MXNetError, match="exists"):
        save_pytree(path, {"a": torch.zeros(2)})
    save_pytree(path, {"a": torch.zeros(2)}, force=True)
    assert torch.equal(load_pytree(path)["a"], torch.zeros(2))
    with pytest.raises(MXNetError):
        save_pytree(str(tmp_path / "u"), {"a": object()})
    with pytest.raises(MXNetError):
        save_pytree(str(tmp_path / "v"), {"../x": torch.ones(1)})


def _largest_payload_file(path):
    best, size = None, -1
    for root, _dirs, names in os.walk(path):
        for name in names:
            if name == MANIFEST_NAME:
                continue
            full = os.path.join(root, name)
            if os.path.getsize(full) > size:
                best, size = full, os.path.getsize(full)
    return best


def test_pytree_truncated_file_raises_named(tmp_path):
    p = str(tmp_path / "t")
    save_pytree(p, {"a": torch.arange(512.0), "b": torch.ones(4)})
    victim = _largest_payload_file(p)
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    with pytest.raises(CheckpointCorruptError,
                       match=os.path.basename(victim)):
        load_pytree(p)


def test_pytree_bitflip_fails_hash(tmp_path):
    p = str(tmp_path / "t")
    save_pytree(p, {"a": torch.arange(512.0)})
    victim = _largest_payload_file(p)
    with open(victim, "r+b") as f:
        f.seek(os.path.getsize(victim) - 1)
        byte = f.read(1)
        f.seek(os.path.getsize(victim) - 1)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(CheckpointCorruptError, match="hash"):
        load_pytree(p)


def test_layout_names_are_the_jax_names():
    jnet = _jax_build()
    jstep = JaxTrainStep(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(),
                         jopt.create("adam", learning_rate=1e-3), batch_size=8)
    x, y = _data()
    jstep(jmx.nd.array(x), jmx.nd.array(y))
    jtree = JaxCheckpoint(jstep)._state_tree()
    step = _step_for(_build(jax_net=jnet))
    step(*map(torch.from_numpy, _data()))
    tree = TrainStepCheckpoint(step)._state_tree()
    assert list(tree) == list(jtree)
    for part in ("params", "aux", "opt_state"):
        assert list(tree[part]) == list(jtree[part]), part
    for k, v in tree["opt_state"].items():
        assert len(v) == len(jtree["opt_state"][k])
    assert tree["num_update"] == jtree["num_update"] == 1


def test_train_step_resume_exact_trajectory(tmp_path):
    """Save at step 2, restore into a FRESH step (other weights, already
    stepped once), steps 3-4 equal the uninterrupted run bit for bit and
    the JAX package's four steps within 1e-6."""
    x, y = map(torch.from_numpy, _data())
    jnet = _jax_build()
    jstep = JaxTrainStep(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(),
                         jopt.create("adam", learning_rate=1e-3), batch_size=8)
    for _ in range(4):
        jstep(jmx.nd.array(x.numpy()), jmx.nd.array(y.numpy()))
    ref = _step_for(_build(jax_net=_jax_build()))
    ref_losses = [ref(x, y) for _ in range(4)]

    a = _step_for(_build())
    for _ in range(2):
        a(x, y)
    TrainStepCheckpoint(a).save(str(tmp_path / "ckpt"))
    b = _step_for(_build(seed=42))
    b(x, y)
    ptrs = [t.data_ptr() for t in _flat_live(b)]
    TrainStepCheckpoint(b).restore(str(tmp_path / "ckpt"))
    assert [t.data_ptr() for t in _flat_live(b)] == ptrs
    assert b._num_update == 2
    resumed = [b(x, y) for _ in range(2)]
    assert all(torch.equal(u, v) for u, v in zip(resumed, ref_losses[2:]))
    assert all(torch.equal(u, v) for u, v in zip(_flat(b), _flat(ref)))
    for jp, t in zip(jnet.collect_params().values(), b._learnable):
        want = jp.data().asnumpy()
        err = float(np.abs(t.detach().numpy() - want).max())
        assert err <= REL * float(np.abs(want).max()), jp.name


def _flat_live(step):
    from mxnet_tpu_torch.executor import _leaves
    return (list(step._learnable) + list(step._aux)
            + [t for s in step._states for t in _leaves(s)])


def test_restore_refuses_another_architecture(tmp_path):
    a = _step_for(_build())
    a(*map(torch.from_numpy, _data()))
    TrainStepCheckpoint(a).save(str(tmp_path / "ck"))
    other = nn.Dense(8, in_units=16, device="cpu")
    torch.nn.init.zeros_(other.weight)
    b = _step_for(other)
    with pytest.raises(MXNetError):
        TrainStepCheckpoint(b).restore(str(tmp_path / "ck"))


def test_sharded_optimizer_needs_a_stepped_store(tmp_path):
    """A store that has not run a sharded step has nothing to save, and a
    load needs the optimizer the slots belong to (the round trips are in
    ``test_torch_checkpoint_sharded.py``)."""
    from mxnet_tpu_torch import kvstore
    kv = kvstore.create("device")
    with pytest.raises(MXNetError, match="has not stepped"):
        save_sharded_optimizer(str(tmp_path / "s"), kv)
    with pytest.raises(MXNetError, match="set_optimizer"):
        load_sharded_optimizer(str(tmp_path / "s"), kv)
