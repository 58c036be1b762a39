"""Ring and Ulysses attention (``mxnet_tpu_torch/parallel/
ring_attention.py``) against the JAX package's on its 8 virtual CPU
devices: outputs and the gradients of q, k and v, causal and full, with
grouped-query K/V (4 query heads over 2 KV heads: on sp = 4 Ulysses
expands K/V before its exchange, on dp = 2 x sp = 2 it moves the 2 unique
heads), fp32 within 1e-5.  The port's positions are CPU devices."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu_torch as tmx
from mxnet_tpu.ops.attention import attention_reference as jref
from mxnet_tpu.parallel import DeviceMesh as JMesh
from mxnet_tpu.parallel import ring_attention as jring
from mxnet_tpu.parallel import ulysses_attention as july
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.parallel import collectives as C

CPU8 = [torch.device("cpu")] * 8
TOL = dict(rtol=1e-5, atol=1e-5)
B, H, HKV, S, D = 2, 4, 2, 32, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from torch's thread pool; one thread keeps
    this file from crowding the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, S, D).astype(np.float32) * 0.5,
            rng.randn(B, HKV, S, D).astype(np.float32) * 0.5,
            rng.randn(B, HKV, S, D).astype(np.float32) * 0.5,
            rng.randn(B, H, S, D).astype(np.float32))


@pytest.mark.parametrize("mode,causal,axes", [
    (mode, causal, axes) for mode in ("ring", "ulysses")
    for causal, axes in ((False, {"sp": 4}), (True, {"sp": 4}),
                         (True, {"dp": 2, "sp": 2}))],
    ids=lambda v: ("causal" if v else "full") if isinstance(v, bool)
    else "x".join(f"{k}{n}" for k, n in v.items()) if isinstance(v, dict)
    else v)
def test_matches_jax_with_gradients(mode, causal, axes):
    q, k, v, dout = _inputs(len(axes) + 2 * causal)
    jf = jring if mode == "ring" else july
    tf = tpar.ring_attention if mode == "ring" else tpar.ulysses_attention
    jm = JMesh(axes)

    def jloss(a, b, c):
        out = jf(a, b, c, jm, causal=causal)
        return (out * dout).sum(), out
    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                               has_aux=True))(
        *(jnp.asarray(a) for a in (q, k, v)))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = tf(*ts, tpar.DeviceMesh(axes, devices=CPU8), causal=causal)
    (out * torch.tensor(dout)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    for t, g in zip(ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)
    # and both against the dense oracle (K/V expanded over their groups)
    ref = jref(jnp.asarray(q), jnp.asarray(np.repeat(k, H // HKV, 1)),
               jnp.asarray(np.repeat(v, H // HKV, 1)), causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_collective_counts_and_recomputed_backward(mode):
    """A forward over sp = 4 makes 2(n - 1) = 6 ppermutes (ring) or 4
    all_to_alls (Ulysses); the backward runs the forward again (the same
    count once more) and keeps nothing of the first one."""
    q, k, v, _ = _inputs(7)
    mesh = tpar.DeviceMesh({"sp": 4}, devices=CPU8)
    fn = tpar.ring_attention if mode == "ring" else tpar.ulysses_attention
    name, per = ("ppermute", 6) if mode == "ring" else ("all_to_all", 4)
    C.reset_collective_counts()
    with torch.no_grad():
        fn(*(torch.tensor(a) for a in (q, k, v)), mesh, causal=True)
    assert C.collective_counts()[name] == per
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    C.reset_collective_counts()
    out = fn(*ts, mesh, causal=True)
    assert C.collective_counts()[name] == per
    assert type(out.grad_fn).__name__ == "_RecomputedBackward"
    assert len(out.grad_fn.saved_tensors) == 3
    out.sum().backward()
    assert C.collective_counts()[name] == 2 * per


def test_registered_ops_record_on_the_tape():
    """``mx.nd._ring_attention`` / ``_ulysses_attention`` on NDArrays under
    ``autograd.record()`` give the global-view functions' gradients."""
    q, k, v, dout = _inputs(9)
    mesh = tpar.DeviceMesh({"sp": 2}, devices=CPU8)
    prev = tmx.set_default_context(tmx.cpu())
    try:
        for name, fn in (("ring", tpar.ring_attention),
                         ("ulysses", tpar.ulysses_attention)):
            arrs = [tmx.nd.array(a) for a in (q, k, v)]
            for a in arrs:
                a.attach_grad()
            with tmx.autograd.record():
                out = fn(*arrs, mesh=mesh, causal=True)
                loss = (out * tmx.nd.array(dout)).sum()
            loss.backward()
            ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
            ref = fn(*ts, mesh, causal=True)
            (ref * torch.tensor(dout)).sum().backward()
            np.testing.assert_allclose(out.asnumpy(), ref.detach().numpy(),
                                       **TOL)
            for a, t in zip(arrs, ts):
                np.testing.assert_allclose(a.grad.asnumpy(), t.grad.numpy(),
                                           **TOL)
            assert callable(getattr(tmx.nd, f"_{name}_attention"))
    finally:
        tmx.set_default_context(prev)


def test_needs_a_mesh_with_the_axis():
    q = torch.zeros(1, 4, 8, 8)
    with pytest.raises(MXNetError, match="needs a mesh"):
        tpar.ring_attention(q, q, q)
    with pytest.raises(MXNetError, match="no axis"):
        tpar.ulysses_attention(q, q, q, tpar.DeviceMesh({"dp": 2},
                                                        devices=CPU8))
    # the entered mesh serves when none is passed
    with tpar.DeviceMesh({"sp": 2}, devices=CPU8):
        out = tpar.ring_attention(q, q, q, causal=True)
    assert out.shape == q.shape
