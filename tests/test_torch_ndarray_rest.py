"""Port parity for the rest of ``mx.nd`` and ``mx.autograd``.

- ``moveaxis``, ``linspace``, ``eye``, ``onehot_encode``,
  ``load_frombuffer`` of a ``save``d buffer, ``from_numpy`` and
  ``mx.nd._internal`` lookups against the JAX package (exactly);
- DLPack: ``to_dlpack_for_read`` and ``from_dlpack`` round trips, and a
  ``to_dlpack_for_write`` capsule that aliases the array's buffer, so what
  its consumer writes the array holds (the reference's meaning, which the
  JAX package cannot give);
- ``autograd.get_symbol`` of a recorded MLP has the JAX package's
  arguments (``var0..var4`` in first-use order) and, bound to the same
  weights, gives the JAX package's symbol's output (within 1e-6); the
  record it reads dies with the graph, and nothing is recorded outside
  ``record()``;
- ``mx.nd.utils``' dense routes against the JAX package's, and every
  sparse storage type raises, naming ROADMAP A15.
"""
import gc
import os
import weakref

import numpy as np
import pytest
import torch
from torch.utils import dlpack

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.base import MXNetError


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)


X = np.arange(24, dtype=np.float32).reshape(2, 3, 4)

CASES = {
    "moveaxis": lambda mx: mx.nd.moveaxis(mx.nd.array(X), 0, -1),
    "moveaxis_many": lambda mx: mx.nd.moveaxis(mx.nd.array(X), (0, 2),
                                               (1, 0)),
    "linspace": lambda mx: mx.nd.linspace(-1.0, 2.0, 7),
    "linspace_open": lambda mx: mx.nd.linspace(0, 1, 5, endpoint=False),
    "eye": lambda mx: mx.nd.eye(3, 4, k=1),
    "eye_square": lambda mx: mx.nd.eye(3),
    "onehot_encode": lambda mx: mx.nd.onehot_encode(
        mx.nd.array([0.0, 2.0, 1.0]), mx.nd.zeros((3, 4))),
    "from_numpy": lambda mx: mx.nd.from_numpy(X),
    "internal_plus_scalar": lambda mx: mx.nd._internal._plus_scalar(
        mx.nd.array(X), scalar=2.0),
    "internal_without_underscore": lambda mx: mx.nd._internal.plus_scalar(
        mx.nd.array(X), scalar=2.0),
    "internal_variadic": lambda mx: mx.nd._internal._npi_concatenate(
        mx.nd.array(X), mx.nd.array(X), axis=1)
    if hasattr(mx.nd, "_npi_concatenate") else mx.nd._internal.concat(
        mx.nd.array(X), mx.nd.array(X), dim=1),
    "utils_zeros": lambda mx: mx.nd.utils.zeros((2, 3)),
    "utils_array": lambda mx: mx.nd.utils.array(X),
    "tostype_default": lambda mx: mx.nd.array(X).tostype("default"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    got = CASES[name](tmx).asnumpy()
    want = CASES[name](jmx).asnumpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_internal_unknown_raises():
    with pytest.raises(AttributeError):
        tmx.nd._internal.no_such_op


@pytest.mark.parametrize("named", [False, True])
def test_load_frombuffer_of_a_saved_buffer(tmp_path, named):
    arrays = [X, np.array([1, 2, 3], np.int32)]
    path = str(tmp_path / "a.params")
    payload = [tmx.nd.array(a) for a in arrays]
    if named:
        payload = dict(zip(("x", "y"), payload))
    tmx.nd.save(path, payload)
    with open(path, "rb") as f:
        buf = f.read()
    for mx in (tmx, jmx):
        got = mx.nd.load_frombuffer(buf)
        assert got.keys() == {"x", "y"} if named else len(got) == 2
        vals = [got[k] for k in ("x", "y")] if named else got
        for g, a in zip(vals, arrays):
            np.testing.assert_array_equal(g.asnumpy(), a)
    got = tmx.nd.utils.load_frombuffer(buf)
    assert len(got) == 2


def test_tostype_and_utils_sparse_routes_raise():
    x = tmx.nd.array(X)
    assert x.tostype("default") is x
    for call in (lambda: x.tostype("csr"),
                 lambda: x.tostype("row_sparse"),
                 lambda: tmx.nd.utils.zeros((2, 2), stype="row_sparse"),
                 lambda: tmx.nd.utils.empty((2, 2), stype="csr")):
        with pytest.raises(MXNetError, match="A15"):
            call()
    scipy_sparse = pytest.importorskip("scipy.sparse")
    with pytest.raises(MXNetError, match="A15"):
        tmx.nd.utils.array(scipy_sparse.csr_matrix(np.eye(3)))
    assert tmx.nd.utils.empty((2, 3)).shape == (2, 3)


def test_dlpack_read_round_trip():
    x = tmx.nd.array(X)
    for cap in (tmx.nd.to_dlpack_for_read(x), x.to_dlpack_for_read()):
        y = tmx.nd.from_dlpack(cap)
        np.testing.assert_array_equal(y.asnumpy(), X)
    # an object that speaks the protocol, without a capsule
    t = torch.arange(6.0)
    np.testing.assert_array_equal(tmx.nd.from_dlpack(t).asnumpy(),
                                  np.arange(6.0, dtype=np.float32))


def test_dlpack_write_aliases_the_array():
    x = tmx.nd.array(X)
    for cap in (tmx.nd.to_dlpack_for_write(x), x.to_dlpack_for_write()):
        writer = dlpack.from_dlpack(cap)
        writer[0, 0, 0] += 100.0
    want = X.copy()
    want[0, 0, 0] += 200.0
    np.testing.assert_array_equal(x.asnumpy(), want)
    # from_dlpack does not copy either
    t = torch.zeros(3)
    y = tmx.nd.from_dlpack(dlpack.to_dlpack(t))
    t += 1
    np.testing.assert_array_equal(y.asnumpy(), [1.0, 1.0, 1.0])


def _mlp_args(mx):
    rng = np.random.RandomState(0)
    shapes = {"x": (4, 5), "w1": (8, 5), "b1": (8,), "w2": (3, 8),
              "b2": (3,)}
    return {k: mx.nd.array(rng.randn(*s).astype(np.float32))
            for k, s in shapes.items()}


def _recorded_mlp(mx, a):
    for v in a.values():
        v.attach_grad()
    with mx.autograd.record():
        h = mx.nd.FullyConnected(a["x"], a["w1"], a["b1"], num_hidden=8)
        h = mx.nd.Activation(h, act_type="tanh")
        o = mx.nd.FullyConnected(h, a["w2"], a["b2"], num_hidden=3)
        out = mx.nd.softmax(o * 2.0 + 1.0, axis=-1)
    return out


def test_get_symbol_matches_jax():
    outs = []
    for mx in (jmx, tmx):
        a = _mlp_args(mx)
        out = _recorded_mlp(mx, a)
        sym = mx.autograd.get_symbol(out)
        names = sym.list_arguments()
        assert names == [f"var{i}" for i in range(5)]
        # first-use order: x, w1, b1 (the first FC), then w2, b2
        args = dict(zip(names, [a[k] for k in ("x", "w1", "b1", "w2",
                                               "b2")]))
        got = sym.bind(mx.cpu(), args).forward()[0].asnumpy()
        np.testing.assert_allclose(got, out.asnumpy(), rtol=1e-6)
        outs.append(got)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6, atol=1e-7)


def test_get_symbol_of_a_leaf_and_of_a_function():
    x = tmx.nd.array(X)
    assert tag.get_symbol(x).list_arguments() == ["var0"]

    class Double(tag.Function):
        def forward(self, v):
            return v * 2

        def backward(self, dy):
            return dy * 2

    x.attach_grad()
    with tag.record():
        y = Double()(x) + 1
    with pytest.raises(NotImplementedError, match="registered operator"):
        tag.get_symbol(y)


def test_the_record_dies_with_the_graph():
    a = _mlp_args(tmx)
    out = _recorded_mlp(tmx, a)
    note, _ = tag._note_of(tag._ref(out._data))
    alive = weakref.ref(note)
    assert note.name == "softmax"
    with tag.record():
        loss = out.sum()
    loss.backward()
    del note, out, loss
    gc.collect()
    assert alive() is None
    # outside record() nothing is noted
    y = tmx.nd.FullyConnected(a["x"], a["w1"], a["b1"], num_hidden=8)
    assert y._data.grad_fn is None and not hasattr(y._data, "_mx_op")


def test_imdecode_legacy_into_out(tmp_path):
    from PIL import Image
    arr = (np.random.RandomState(1).rand(6, 5, 3) * 255).astype(np.uint8)
    path = os.path.join(str(tmp_path), "i.png")
    Image.fromarray(arr).save(path)
    with open(path, "rb") as f:
        buf = f.read()
    out = tmx.nd.zeros((6, 5, 3), dtype="uint8")
    tmx.nd.imdecode(buf, out=out)
    np.testing.assert_array_equal(out.asnumpy(), arr)
    got = tmx.nd.imdecode(buf, mean=tmx.nd.array([1.0, 2.0, 3.0])).asnumpy()
    want = jmx.nd.imdecode(buf, mean=jmx.nd.array([1.0, 2.0, 3.0])).asnumpy()
    np.testing.assert_array_equal(got, want)
