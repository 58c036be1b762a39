"""Port parity: the dist kvstores of ``mxnet_tpu_torch`` in real jobs of
2 and 4 processes on the CPU (gloo), through ``tools/launch.py``.

Each job runs ``tests/test_torch_dist_worker.py`` on every rank: the
reference worker's contract (``tests/dist_sync_worker.py``) without its
row-sparse cases (ROADMAP A15), the bucketed push against the per-key
push, ``dist_async``'s averaging, and a ``gluon.Trainer`` and a
``Module.fit`` run over ``dist_sync`` against an oracle the JAX package
computes here, in the pytest process.  The oracle: the JAX package's
``'device'`` kvstore, with the same SGD set on it, pushes each key's list
of the N ranks' gradients (the Trainer's gradients are seeded numpy
inputs; the Module's are the JAX ``Module``'s own ``forward_backward`` on
each rank's shard of a seeded integer dataset) and pulls; what it pulls
after the last step is what every rank must hold.

Tolerance: bit for bit at n = 2 (gloo's a + b is the pairwise sum); at
n = 4 within 1e-6 relative, since a ring all-reduce adds the four values
in another order than ``(a + b) + (c + d)``.  The Module's data are
integers, so its gradients are exact in both packages.  Each job runs
with ``OMP_NUM_THREADS=1`` under a 180 s limit, so a hung rank ends in
the subprocess timeout.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "test_torch_dist_worker.py")
LAUNCHER = os.path.join(ROOT, "tools", "launch.py")

TRAINER = dict(shapes={"w1": (8, 6), "b1": (8,), "w2": (3, 8), "b2": (3,)},
               steps=2, batch=4, lr=0.1, momentum=0.9, wd=0.01)
MODULE = dict(rows=8, batch=4, features=6, outputs=3, lr=0.25, momentum=0.5)


def _trainer_oracle(nproc, out):
    t = TRAINER
    rng = np.random.RandomState(11)
    names = list(t["shapes"])
    out["trainer_names"] = np.array(names)
    for key, value in (("steps", t["steps"]), ("batch", t["batch"]),
                       ("lr", t["lr"]), ("momentum", t["momentum"]),
                       ("wd", t["wd"])):
        out[f"trainer_{key}"] = np.array(value)
    kv = jmx.kv.create("device")
    kv.set_optimizer(jmx.optimizer.create(
        "sgd", learning_rate=t["lr"], momentum=t["momentum"], wd=t["wd"],
        rescale_grad=1.0 / t["batch"]))
    for k, n in enumerate(names):
        w0 = rng.randn(*t["shapes"][n]).astype(np.float32)
        out[f"trainer_w0_{k}"] = w0
        kv.init(k, jmx.nd.array(w0))
    for s in range(t["steps"]):
        for k, n in enumerate(names):
            grads = []
            for r in range(nproc):
                g = rng.randn(*t["shapes"][n]).astype(np.float32)
                out[f"trainer_g_{s}_{r}_{k}"] = g
                grads.append(jmx.nd.array(g))
            kv.push(k, grads)
    for k in range(len(names)):
        out[f"trainer_want_{k}"] = kv.pull(k).asnumpy()


def _module_oracle(nproc, out):
    m = MODULE
    rng = np.random.RandomState(12)
    for r in range(nproc):
        out[f"module_x_{r}"] = rng.randint(
            -2, 3, (m["rows"], m["features"])).astype(np.float32)
        out[f"module_y_{r}"] = rng.randint(
            -3, 4, (m["rows"], m["outputs"])).astype(np.float32)
    w0 = {"fc_weight": rng.randint(-2, 3, (m["outputs"], m["features"])),
          "fc_bias": rng.randint(-2, 3, (m["outputs"],))}
    for n, w in w0.items():
        out[f"module_w0_{n}"] = w.astype(np.float32)
    for key in ("batch", "lr", "momentum"):
        out[f"module_{key}"] = np.array(m[key])
    sym = jmx.sym.LinearRegressionOutput(
        jmx.sym.FullyConnected(jmx.sym.var("data"), num_hidden=m["outputs"],
                               name="fc"),
        jmx.sym.var("lro_label"), name="lro")
    mod = jmx.module.Module(sym, label_names=("lro_label",))
    mod.bind([("data", (m["batch"], m["features"]))],
             [("lro_label", (m["batch"], m["outputs"]))])
    names = ["fc_weight", "fc_bias"]
    weights = {n: jmx.nd.array(out[f"module_w0_{n}"]) for n in names}
    kv = jmx.kv.create("device")
    kv.set_optimizer(jmx.optimizer.create(
        "sgd", learning_rate=m["lr"], momentum=m["momentum"]))
    for i, n in enumerate(names):
        kv.init(i, weights[n])
    for b in range(m["rows"] // m["batch"]):
        rows = slice(b * m["batch"], (b + 1) * m["batch"])
        grads = {n: [] for n in names}
        for r in range(nproc):
            mod.set_params(weights, {})
            mod.forward_backward(jmx.io.DataBatch(
                [jmx.nd.array(out[f"module_x_{r}"][rows])],
                [jmx.nd.array(out[f"module_y_{r}"][rows])]))
            for n in names:
                grads[n].append(mod._exec.grad_dict[n].copy())
        for i, n in enumerate(names):
            kv.push(i, grads[n])
            weights[n] = kv.pull(i)
    for n in names:
        out[f"module_want_{n}"] = weights[n].asnumpy()


def _oracle(nproc, path):
    out = {}
    _trainer_oracle(nproc, out)
    _module_oracle(nproc, out)
    np.savez(path, **out)


@pytest.mark.parametrize("nproc", [2, 4])
def test_dist_kvstore_job_matches_reference_contract(nproc, tmp_path):
    oracle = tmp_path / "oracle.npz"
    _oracle(nproc, oracle)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, LAUNCHER, "-n", str(nproc), sys.executable, WORKER,
         str(oracle)],
        capture_output=True, text=True, timeout=180, env=env, cwd=ROOT)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    for rank in range(nproc):
        assert f"[rank {rank}] port dist kvstore OK" in r.stdout, r.stdout


_DIST_ENV = ("MXNET_DIST_COORDINATOR", "MXNET_DIST_NUM_PROCESSES",
             "MXNET_DIST_PROCESS_ID", "DMLC_PS_ROOT_URI", "DMLC_PS_ROOT_PORT",
             "DMLC_NUM_WORKER", "DMLC_WORKER_ID", "LOCAL_WORLD_SIZE")


def test_initialize_single_process_noop(monkeypatch):
    """No coordinator anywhere: a one-process no-op, as in the JAX
    package (``tests/test_distributed.py``)."""
    from mxnet_tpu_torch import distributed
    for k in _DIST_ENV:
        monkeypatch.delenv(k, raising=False)
    distributed.initialize()
    assert not distributed.is_initialized()
    assert (distributed.process_count(), distributed.process_index()) == (1, 0)
    distributed.barrier()
    distributed.finalize()
    monkeypatch.setenv("MXNET_DIST_NUM_PROCESSES", "2")
    with pytest.raises(distributed.MXNetError, match="coordinator"):
        distributed.initialize()


def test_nccl_refuses_ranks_sharing_a_card(monkeypatch):
    """Two ranks of an NCCL job on a host with fewer cards raise before
    any group is made, naming gloo; nothing switches the backend."""
    from mxnet_tpu_torch import distributed
    for k in _DIST_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(distributed.MXNetError, match="backend='gloo'"):
        distributed.initialize("127.0.0.1:1", 2, 0, backend="nccl")
    assert not distributed.is_initialized()
