"""The port's device mesh and collectives (``mxnet_tpu_torch/parallel/
mesh.py``, ``collectives.py``) against the JAX package's on its 8 virtual
CPU devices.

The port's mesh positions are ``[torch.device("cpu")] * 8``; its
``shard_map`` runs the body over every position in lockstep on lists of
shards.  Each collective is held to ``lax``'s under ``jax.shard_map`` on
the same numpy-seeded input, and each result to fp32 within 1e-6
(the sums run in another order only where the tolerance says so)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as JP

from mxnet_tpu.parallel import DeviceMesh as JMesh
from mxnet_tpu.parallel import collectives as jcoll
from mxnet_tpu.parallel import mesh as jmesh

from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.parallel import PartitionSpec as P, collectives as C
from mxnet_tpu_torch.parallel import mesh as tmesh

CPU8 = [torch.device("cpu")] * 8
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from torch's thread pool; one thread keeps
    this file from crowding the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_body(mesh, body, x, spec_in, spec_out):
    try:
        fn = jcoll.shard_map(body, mesh=mesh.mesh, in_specs=spec_in,
                             out_specs=spec_out, check_vma=False)
    except TypeError:  # older jax spelling
        fn = jcoll.shard_map(body, mesh=mesh.mesh, in_specs=spec_in,
                             out_specs=spec_out, check_rep=False)
    return np.asarray(jax.jit(fn)(jax.device_put(
        jnp.asarray(x), NamedSharding(mesh.mesh, spec_in))))


def test_axis_order_and_mesh_shape_match_jax():
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    for axes in ({"sp": 4}, {"tp": 2, "dp": 4}, {"ep": 2, "pp": 2, "dp": 2},
                 {"dp": 2, "fsdp": 2, "tp": 2}):
        jm, tm = JMesh(axes), tpar.DeviceMesh(axes, devices=CPU8)
        assert jm.axis_names == tm.axis_names
        assert jm.axes == tm.axes and jm.size == tm.size
        assert tm.devices == CPU8[:tm.size]
        assert jm.sharding("dp", ("tp", "zz"), "yy").spec == \
            JP(*tm.sharding("dp", ("tp", "zz"), "yy").spec)
    with pytest.raises(ValueError):
        tpar.DeviceMesh({"dp": 9}, devices=CPU8)
    with pytest.raises(ValueError):
        tpar.DeviceMesh({"dp": 2})  # one CPU by default


def test_current_and_default_mesh_stack():
    a = tpar.DeviceMesh({"dp": 2}, devices=CPU8)
    b = tpar.DeviceMesh({"sp": 4}, devices=CPU8)
    assert tpar.current_mesh() is None
    with a:
        with b:
            assert tpar.current_mesh() is b and tpar.default_mesh() is b
        assert tpar.current_mesh() is a
    assert tpar.current_mesh() is None
    assert tpar.default_mesh().axes == {"dp": 1}
    assert tpar.make_mesh(devices=CPU8[:4]).axes == {"dp": 4}


CASES = {
    "psum": (lambda x: lax.psum(x, "fsdp"), lambda xs: C.psum(xs, "fsdp")),
    "pmean": (lambda x: lax.pmean(x, "dp"), lambda xs: C.pmean(xs, "dp")),
    "pmax": (lambda x: lax.pmax(x, ("dp", "fsdp")),
             lambda xs: C.pmax(xs, ("dp", "fsdp"))),
    "all_gather": (lambda x: lax.all_gather(x, "fsdp", axis=1, tiled=True),
                   lambda xs: C.all_gather(xs, "fsdp", axis=1)),
    "reduce_scatter": (
        lambda x: lax.psum_scatter(x, "fsdp", scatter_dimension=1,
                                   tiled=True),
        lambda xs: C.reduce_scatter(xs, "fsdp", axis=1)),
    "ppermute": (
        lambda x: lax.ppermute(x, "fsdp", [(0, 1), (1, 2), (2, 3), (3, 0)]),
        lambda xs: C.ppermute(xs, "fsdp", [(0, 1), (1, 2), (2, 3), (3, 0)])),
    "ppermute_partial": (
        lambda x: lax.ppermute(x, "dp", [(0, 1)]),
        lambda xs: C.ppermute(xs, "dp", [(0, 1)])),
    "all_to_all": (
        lambda x: lax.all_to_all(x, "fsdp", 1, 2, tiled=True),
        lambda xs: C.all_to_all(xs, "fsdp", split_axis=1, concat_axis=2)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_collective_matches_lax_on_2d_mesh(name):
    """Each collective inside shard_map on a {dp: 2, fsdp: 4} mesh, the
    input [4, 8, 8] sharded over dp on dim 0 and fsdp on dim 2."""
    jfn, tfn = CASES[name]
    x = np.random.RandomState(3).randn(4, 8, 8).astype(np.float32)
    axes = {"dp": 2, "fsdp": 4}
    spec = ("dp", None, "fsdp")
    jm, tm = JMesh(axes), tpar.DeviceMesh(axes, devices=CPU8)
    # the output stays sharded as the input (each position's block)
    ref = _jax_body(jm, jfn, x, JP(*spec), JP(*spec))
    C.reset_collective_counts()
    got = C.shard_map(tfn, tm, P(*spec), P(*spec))(torch.tensor(x))
    counted = name.split("_partial")[0]
    assert C.collective_counts()[counted] == 1
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_collectives_differentiate_like_jax():
    """The gradient of a body with a ppermute, an all_to_all and a psum."""
    x = np.random.RandomState(4).randn(2, 8, 8).astype(np.float32)
    w = np.random.RandomState(5).randn(2, 2, 32).astype(np.float32)
    spec = ("dp", None, "fsdp")
    perm = [(0, 1), (1, 2), (2, 3), (3, 0)]

    def jbody(a):
        a = lax.ppermute(jnp.tanh(a), "fsdp", perm)
        a = lax.all_to_all(a, "fsdp", 1, 2, tiled=True)
        return lax.psum(a * a, "dp")

    def tbody(xs):
        xs = C.ppermute([torch.tanh(a) for a in xs], "fsdp", perm)
        xs = C.all_to_all(xs, "fsdp", split_axis=1, concat_axis=2)
        return C.psum([a * a for a in xs], "dp")

    jm = JMesh({"dp": 2, "fsdp": 4})
    try:
        sm = jcoll.shard_map(jbody, mesh=jm.mesh, in_specs=JP(*spec),
                             out_specs=JP(*spec), check_vma=False)
    except TypeError:
        sm = jcoll.shard_map(jbody, mesh=jm.mesh, in_specs=JP(*spec),
                             out_specs=JP(*spec), check_rep=False)
    jg = jax.jit(jax.grad(lambda a: (sm(a) * w).sum()))(jnp.asarray(x))
    tm = tpar.DeviceMesh({"dp": 2, "fsdp": 4}, devices=CPU8)
    tx = torch.tensor(x, requires_grad=True)
    out = C.shard_map(tbody, tm, P(*spec), P(*spec))(tx)
    (out * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)


def test_reduce_scatter_all_gather_flat_round_trip_2d_mesh():
    """reduce_scatter_flat then all_gather_flat over fsdp of a {dp: 2,
    fsdp: 4} mesh gives the sum of the four buffers, as the JAX pair does
    (the ZeRO inner loop)."""
    rng = np.random.RandomState(1)
    flats = [rng.randn(1024).astype(np.float32) for _ in range(4)]
    jm = JMesh({"dp": 2, "fsdp": 4})
    tm = tpar.DeviceMesh({"dp": 2, "fsdp": 4}, devices=CPU8)
    jout = jcoll.all_gather_flat(jcoll.reduce_scatter_flat(
        [jnp.asarray(f) for f in flats], mesh=jm, axis="fsdp"), mesh=jm,
        axis="fsdp")
    shards = C.reduce_scatter_flat([torch.tensor(f) for f in flats],
                                   mesh=tm, axis="fsdp")
    assert len(shards) == 4 and all(s.shape == (256,) for s in shards)
    tout = C.all_gather_flat(shards, mesh=tm, axis="fsdp")
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tout.numpy(), np.sum(flats, axis=0), **TOL)
    # one buffer (already reduced) is split where it is
    one = C.reduce_scatter_flat([torch.tensor(flats[0])], mesh=tm,
                                axis="fsdp")
    assert torch.equal(torch.cat(one), torch.tensor(flats[0]))


@pytest.mark.parametrize("average", [False, True])
def test_allreduce_arrays_and_allreduce_match_jax(average):
    rng = np.random.RandomState(2)
    vals = [rng.randn(16, 8).astype(np.float32) for _ in range(8)]
    jm, tm = JMesh({"dp": 8}), tpar.DeviceMesh({"dp": 8}, devices=CPU8)
    jout = jcoll.allreduce_arrays([jnp.asarray(v) for v in vals], mesh=jm,
                                  average=average)
    tout = C.allreduce_arrays([torch.tensor(v) for v in vals], mesh=tm,
                              average=average)
    for a, b in zip(jout, tout):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    # an axis size that does not match falls back to a pairwise sum
    short = C.allreduce_arrays([torch.tensor(v) for v in vals[:3]], mesh=tm)
    np.testing.assert_allclose(short[0].numpy(), np.sum(vals[:3], axis=0),
                               **TOL)
    import mxnet_tpu_torch as mx
    nds = [mx.nd.array(v, ctx=mx.cpu()) for v in vals]
    C.allreduce(nds, average=average, mesh=tm)
    np.testing.assert_allclose(nds[5].asnumpy(), np.asarray(jout[5]), **TOL)


def test_broadcast_value_and_barrier():
    assert C.broadcast_value(3, 4) == [3, 3, 3, 3]
    C.barrier(tpar.DeviceMesh({"dp": 8}, devices=CPU8))


def test_shard_map_joins_replicated_and_sharded_outputs():
    """A body over a {dp: 2, sp: 4} mesh: an input sharded on two dims, a
    replicated input, a sharded and a replicated output; shapes each
    position sees are the JAX package's."""
    x = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 3)
    r = torch.ones(3)
    tm = tpar.DeviceMesh({"dp": 2, "sp": 4}, devices=CPU8)
    seen = []

    def body(xs, rs):
        seen.extend(tuple(a.shape) for a in xs)
        tot = C.psum([a.sum() for a in xs], ("dp", "sp"))
        return [a + b for a, b in zip(xs, rs)], tot

    y, tot = C.shard_map(body, tm, (P("dp", "sp"), P()), (P("dp", "sp"),
                                                          P()))(x, r)
    assert seen == [(1, 2, 3)] * 8
    assert torch.equal(y, x + 1) and float(tot) == float(x.sum())
    with pytest.raises(ValueError):
        C.shard_map(body, tm, P("zz"), P())(x, r)
