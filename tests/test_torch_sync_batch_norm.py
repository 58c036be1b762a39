"""Port parity: ``SyncBatchNorm(axis_name=)`` (``mxnet_tpu_torch/ops/nn.py``
``sync_batch_norm``, the Gluon layer) against the JAX package's
``_contrib_SyncBatchNorm`` under ``jax.shard_map`` on 4 of its 8 virtual
CPU devices.

Inside a body the per-position moments are averaged over the named axis
(``lax.pmean`` in the JAX op, :func:`~mxnet_tpu_torch.parallel.pmean` in
the port): the outputs, the averaged mean and variance and the gradients
of the input, gamma and beta match the JAX op within 1e-5 relative of
each tensor's largest |value| (fp32; the two packages sum the moments in
other orders).  The same body run by the op itself under an entered mesh,
and by the Gluon layer on the positions' list, give the body's result bit
for bit.  Outside a body and a mesh with that axis, the op raises (the
case is in ``test_torch_gluon_layers.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import nn as jnn_ops
from mxnet_tpu.parallel import DeviceMesh as JMesh
from mxnet_tpu.parallel import collectives as jcoll
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.ops import nn as tnn_ops
from mxnet_tpu_torch.parallel import DeviceMesh, PartitionSpec as P
from mxnet_tpu_torch.parallel import collectives as C

REL = 1e-5
CPU4 = [torch.device("cpu")] * 4
SHAPE = (8, 3, 5, 5)      # 2 rows a position
EPS = 1e-3


def _inputs():
    rng = np.random.RandomState(13)
    x = (rng.randn(*SHAPE) * 2.0 + 0.5).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, SHAPE[1]).astype(np.float32)
    beta = rng.randn(SHAPE[1]).astype(np.float32)
    w = rng.randn(*SHAPE).astype(np.float32)     # the loss's weights
    return x, gamma, beta, w


def _shard_map(body, mesh, in_specs, out_specs):
    try:
        return jcoll.shard_map(body, mesh=mesh, in_specs=in_specs,
                               out_specs=out_specs, check_vma=False)
    except TypeError:  # older jax spelling
        return jcoll.shard_map(body, mesh=mesh, in_specs=in_specs,
                               out_specs=out_specs, check_rep=False)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX op in a shard_map body over dp = 4: (out, mean, var) and
    the gradients of sum(out · w) for x, gamma, beta."""
    x, gamma, beta, w = _inputs()
    mesh = JMesh({"dp": 4}, devices=jax.devices()[:4]).mesh
    c = SHAPE[1]

    def body(xs, g, b):
        return jnn_ops._sync_batch_norm(
            xs, g, b, jnp.zeros(c), jnp.ones(c), eps=EPS, fix_gamma=False,
            axis_name="dp")

    fn = _shard_map(body, mesh, (JP("dp"), JP(), JP()),
                    (JP("dp"), JP(), JP()))

    def loss(xs, g, b):
        out = fn(xs, g, b)
        return (out[0] * jnp.asarray(w)).sum(), out

    grad = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, JP("dp")))
    (_, (out, mean, var)), grads = grad(xs, jnp.asarray(gamma),
                                        jnp.asarray(beta))
    return ([np.asarray(a) for a in (out, mean, var)],
            [np.asarray(g) for g in grads])


def _port_body(x, gamma, beta, w):
    """The port's op in a shard_map body over dp = 4, differentiated."""
    mesh = DeviceMesh({"dp": 4}, devices=CPU4)
    c = SHAPE[1]
    ts = [torch.tensor(a, requires_grad=True) for a in (x, gamma, beta)]

    def body(xs, gs, bs):
        return tnn_ops.sync_batch_norm(xs, gs, bs, torch.zeros(c),
                                       torch.ones(c), EPS, False, True,
                                       axis_name="dp")
    out, mean, var = C.shard_map(body, mesh, (P("dp"), P(), P()),
                                 (P("dp"), P(), P()))(*ts)
    (out * torch.tensor(w)).sum().backward()
    return [out.detach(), mean, var], [t.grad for t in ts]


def _close(got, ref):
    got = got.detach().numpy()
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(got - ref).max()) <= REL * scale


def test_sync_batch_norm_body_matches_jax(jax_ref):
    """Outputs, the averaged mean and variance, and the gradients of x,
    gamma and beta against the JAX op under shard_map."""
    outs, grads = _port_body(*_inputs())
    (jouts, jgrads) = jax_ref
    for got, ref in zip(outs + grads, jouts + jgrads):
        _close(got, ref)
    # the moments are those of the whole batch (sync, not per position)
    x = _inputs()[0]
    _close(outs[1], x.mean(axis=(0, 2, 3)))


def test_sync_batch_norm_under_a_mesh_is_the_body():
    """Under an entered mesh the op splits the batch over the axis itself
    (a meshed CompiledTrainStep's forward), bit for bit the body."""
    x, gamma, beta, w = _inputs()
    (out, mean, var), _ = _port_body(x, gamma, beta, w)
    c = SHAPE[1]
    with DeviceMesh({"dp": 4}, devices=CPU4):
        got = tnn_ops.sync_batch_norm(
            torch.tensor(x), torch.tensor(gamma), torch.tensor(beta),
            torch.zeros(c), torch.ones(c), EPS, False, True, axis_name="dp")
    for a, b in zip(got, (out, mean, var)):
        assert torch.equal(a, b)


def test_sync_batch_norm_layer_in_a_body():
    """The Gluon layer with ``axis_name`` takes the positions' list inside
    a body, returns the body's outputs, and moves its moving statistics by
    the averaged moments; called under the mesh it gives the same."""
    x, gamma, beta, w = _inputs()
    (out, mean, var), _ = _port_body(x, gamma, beta, w)
    mesh = DeviceMesh({"dp": 4}, devices=CPU4)
    layers = []
    for _ in range(2):
        layer = tnn.SyncBatchNorm(axis_name="dp", in_channels=SHAPE[1],
                                  epsilon=EPS, momentum=0.9)
        layer.initialize(ctx=tmx.cpu())
        with torch.no_grad():
            layer.gamma.copy_(torch.tensor(gamma))
            layer.beta.copy_(torch.tensor(beta))
        layers.append(layer)
    got = C.shard_map(lambda xs: layers[0](xs), mesh, (P("dp"),),
                      P("dp"))(torch.tensor(x))
    assert torch.equal(got.detach(), out)
    with mesh:
        got2 = layers[1](torch.tensor(x))
    assert torch.equal(got2.detach(), out)
    for layer in layers:
        assert torch.equal(layer.running_mean, 0.1 * mean)
        assert torch.equal(layer.running_var, 0.9 + 0.1 * var)
