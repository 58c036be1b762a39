"""Port parity: mxnet_tpu_torch.ndarray (NDArray, mx.nd, the matrix ops)
against mxnet_tpu.ndarray.

The cases of tests/test_ndarray.py that slice 3 covers, each through both
packages on the same seeded numpy inputs: creation and the 64-bit width
policy, broadcasting with scalars, in-place writes and versions, indexing,
the reshape codes, context copies, weak-scalar promotion, the shape and
product ops, and save/load across the two packages (bf16 included).
float32 results: within 1e-6 relative and absolute (the same arithmetic;
products sum in other orders); integers, shapes and dtypes: equal.  Then
what the port must hold that torch would not: a slice is a copy, and the
default context is the card.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

RTOL = ATOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)


def _np(a):
    return a.asnumpy() if hasattr(a, "asnumpy") else np.asarray(a)


def _same(want, got, rtol=RTOL, atol=ATOL):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for w, g in zip(want, got):
            _same(w, g, rtol, atol)
        return
    w, g = _np(want), _np(got)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert str(g.dtype) == str(w.dtype), (g.dtype, w.dtype)
    if np.issubdtype(w.dtype, np.floating) or str(w.dtype) == "bfloat16":
        np.testing.assert_allclose(g.astype(np.float32), w.astype(np.float32),
                                   rtol=rtol, atol=atol)
    else:
        np.testing.assert_array_equal(g, w)


def _both(fn):
    return fn(jmx), fn(tmx)


rng = np.random.RandomState(0)
A = rng.randn(2, 3, 4).astype(np.float32)
M = rng.randn(3, 4).astype(np.float32)

CREATION = {
    "int_list": lambda p: p.nd.array([[1, 2], [3, 4]]),
    "float_list": lambda p: p.nd.array([1.5, 2.5]),
    "float64_numpy": lambda p: p.nd.array(np.arange(4, dtype=np.float64) / 3),
    "int64_numpy_fits": lambda p: p.nd.array(np.array([-2 ** 31, 2 ** 31 - 1])),
    "dtype_float64": lambda p: p.nd.array([0.1, 0.2], dtype="float64"),
    "dtype_int64": lambda p: p.nd.array([1, 2, 3], dtype="int64"),
    "dtype_float16": lambda p: p.nd.array([0.1, 60000.0], dtype="float16"),
    "dtype_bfloat16": lambda p: p.nd.array([0.1, 3.0], dtype="bfloat16"),
    "dtype_int32_from_floats": lambda p: p.nd.array([1.7, -2.7], dtype="int32"),
    "uint8": lambda p: p.nd.array(np.array([0, 255], np.uint8)),
    "bool": lambda p: p.nd.array(np.array([True, False])),
    "zeros": lambda p: p.nd.zeros((2, 3)),
    "ones_int": lambda p: p.nd.ones(4, dtype="int32"),
    "full": lambda p: p.nd.full((2,), 7),
    "arange": lambda p: p.nd.arange(0, 5),
    "arange_step": lambda p: p.nd.arange(1, 3, 0.3),
    "arange_repeat_int": lambda p: p.nd.arange(0, 3, 1, repeat=2, dtype="int32"),
    "from_ndarray": lambda p: p.nd.array(p.nd.array(M)),
    "concatenate": lambda p: p.nd.concatenate([p.nd.ones((1, 2)),
                                               p.nd.zeros((2, 2))]),
}


@pytest.mark.parametrize("case", sorted(CREATION))
def test_creation_and_width_policy(case):
    want, got = _both(CREATION[case])
    _same(want, got, rtol=0, atol=0)


@pytest.mark.parametrize("source", [np.array([2 ** 31]),
                                    np.array([-(2 ** 31) - 1]),
                                    [1, 2 ** 40]])
def test_int64_out_of_int32_range_raises(source):
    for pkg in (jmx, tmx):
        with pytest.raises(ValueError, match="int32"):
            pkg.nd.array(source)


EXPRS = {
    "add_broadcast": lambda p, a, b: a + b,
    "sub_scalar": lambda p, a, b: a - 1,
    "rmul_scalar": lambda p, a, b: 2 * a,
    "rdiv_scalar": lambda p, a, b: 1 / a,
    "pow_scalar": lambda p, a, b: a ** 2,
    "rsub_scalar": lambda p, a, b: 2 - a,
    "rpow_scalar": lambda p, a, b: 2 ** a,
    "mod_scalar": lambda p, a, b: a % 0.7,
    "floordiv": lambda p, a, b: a // b,
    "gt_scalar": lambda p, a, b: a > 0.2,
    "eq_array": lambda p, a, b: a == a,
    "neg_abs": lambda p, a, b: abs(-a),
    "matmul": lambda p, a, b: a @ p.nd.array(M.T),
    "module_maximum": lambda p, a, b: p.nd.maximum(a, 0.1),
    "module_minimum_arrays": lambda p, a, b: p.nd.minimum(a, b),
    "module_power": lambda p, a, b: p.nd.power(2.0, a),
    "T": lambda p, a, b: a.T,
}


@pytest.mark.parametrize("case", sorted(EXPRS))
def test_arithmetic_matches_jax_package(case):
    b = rng.randn(4).astype(np.float32) + 3.0
    want, got = _both(lambda p: EXPRS[case](p, p.nd.array(M), p.nd.array(b)))
    _same(want, got)


@pytest.mark.parametrize("dtype,scalar", [("float16", 0.5), ("bfloat16", 1.0),
                                          ("int32", 0.5), ("int32", 2),
                                          ("float16", 2)])
def test_weak_scalar_promotion(dtype, scalar):
    want, got = _both(lambda p: p.nd.ones((2,), dtype=dtype) * scalar)
    _same(want, got)


def test_inplace_writes_bump_version_and_keep_old_slices():
    for pkg in (jmx, tmx):
        a = pkg.nd.ones((2, 2))
        first_row, flat = a[0], a.reshape((4,))
        v0 = a._version
        a += 1
        assert a._version > v0
        a[:] = 5.0
        a[1, 1] = -1.0
        np.testing.assert_array_equal(a.asnumpy(), [[5, 5], [5, -1]])
        np.testing.assert_array_equal(first_row.asnumpy(), [1, 1])
        np.testing.assert_array_equal(flat.asnumpy(), [1, 1, 1, 1])


def test_a_slice_is_not_a_view():
    a = tmx.nd.array(A)
    for b in (a[1], a[:, 1:3], a.reshape((6, 4)), a.T, a.expand_dims(0),
              a.copy(), tmx.nd.split(a, num_outputs=2, axis=0)[0]):
        assert b._data.untyped_storage().data_ptr() != \
            a._data.untyped_storage().data_ptr()


KEYS = {
    "int": 1, "neg_int": -1, "slice": slice(0, 2), "step": (slice(None),
                                                          slice(None, None, 2)),
    "neg_step": slice(None, None, -1), "neg_step_inner": (0, slice(3, 0, -2)),
    "ellipsis": (Ellipsis, 1), "newaxis": (None, 1), "tuple": (1, 2, 3),
    "list": [1, 0], "two_lists": ([0, 1], [1, 2]), "empty_list": [],
    "ndarray": "nd_index", "mixed": (slice(None), [2, 0]),
}


def _key(p, key):
    return p.nd.array([1, 0], dtype="int32") if key == "nd_index" else key


@pytest.mark.parametrize("case", sorted(KEYS))
def test_getitem_matches_jax_package(case):
    want, got = _both(lambda p: p.nd.array(A)[_key(p, KEYS[case])])
    _same(want, got, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["int", "slice", "step", "tuple", "list",
                                  "two_lists", "ndarray", "mixed"])
def test_setitem_matches_jax_package(case):
    def run(p):
        a = p.nd.array(A)
        a[_key(p, KEYS[case])] = -7.0
        b = p.nd.array(A)
        val = np.asarray(p.nd.array(A)[_key(p, KEYS[case])].asnumpy()) + 1
        b[_key(p, KEYS[case])] = p.nd.array(val)
        return [a, b]
    want, got = _both(run)
    _same(want, got, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(-1,), (0, -1), (-2,), (-3, 0),
                                   (-4, 1, 2, 0, 0), (0, -4, -1, 1, 0),
                                   (6, 4), (2, -1, 2)])
def test_reshape_codes(shape):
    want, got = _both(lambda p: p.nd.reshape(p.nd.array(A), shape=shape))
    _same(want, got, rtol=0, atol=0)
    want, got = _both(lambda p: p.nd.array(A).reshape(shape, reverse=True)
                      if -4 not in shape else p.nd.array(A).reshape(shape))
    _same(want, got, rtol=0, atol=0)


def test_context_copies_and_cast():
    a = tmx.nd.ones((3,), ctx=tmx.cpu())
    b = a.copyto(tmx.cpu())
    assert b is not a and np.array_equal(b.asnumpy(), a.asnumpy())
    assert a.as_in_context(tmx.cpu()) is a
    for pkg in (jmx, tmx):
        # copying into an array takes the source's values and dtype
        c = pkg.nd.zeros((3,), dtype="float16")
        assert pkg.nd.ones((3,)).copyto(c) is c and c.dtype == np.float32
    assert a.astype("float16").dtype == np.float16
    assert a.astype("float32", copy=False) is a
    assert a.context == tmx.cpu(0) and str(a.context) == "cpu(0)"
    with tmx.Context("cpu", 0):
        assert tmx.current_context() == tmx.cpu()


def test_default_context_is_the_card():
    tmx.set_default_context(None)
    assert tmx.current_context() == tmx.gpu(0) == tmx.tpu(0)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for make in (lambda: tmx.nd.zeros((2,)), lambda: tmx.nd.array([1.0]),
                 lambda: tmx.nd.ones((2,), ctx=tmx.gpu(0))):
        with pytest.raises(tmx.MXNetError, match="CUDA"):
            make()
    assert tmx.num_gpus() == 0


MATRIX = {
    "transpose": lambda p, a: p.nd.transpose(a, axes=(2, 0, 1)),
    "transpose_default": lambda p, a: p.nd.transpose(a),
    "swapaxes": lambda p, a: p.nd.swapaxes(a, dim1=0, dim2=2),
    "expand_dims": lambda p, a: p.nd.expand_dims(a, axis=-1),
    "squeeze": lambda p, a: p.nd.squeeze(p.nd.expand_dims(a, axis=1), axis=1),
    "flatten": lambda p, a: p.nd.flatten(a),
    "broadcast_to": lambda p, a: p.nd.broadcast_to(a[:, :1], shape=(0, 5, 0)),
    "broadcast_like": lambda p, a: p.nd.broadcast_like(a[:1], a),
    "broadcast_like_axes": lambda p, a: p.nd.broadcast_like(
        a[:, :1], a, lhs_axes=(1,), rhs_axes=(1,)),
    "slice": lambda p, a: p.nd.slice(a, begin=(0, 1, None), end=(2, None, 3)),
    "slice_step": lambda p, a: p.nd.slice(a, begin=(None, None, 3),
                                          end=(None, None, 0),
                                          step=(1, 2, -1)),
    "slice_axis": lambda p, a: p.nd.slice_axis(a, axis=2, begin=1, end=-1),
    "split": lambda p, a: p.nd.split(a, num_outputs=2, axis=2),
    "split_squeeze": lambda p, a: p.nd.split(a, num_outputs=3, axis=1,
                                             squeeze_axis=True),
    "concat": lambda p, a: p.nd.concat(a, a * 2, dim=1),
    "stack": lambda p, a: p.nd.stack(a, a + 1, axis=1),
    "take_clip": lambda p, a: p.nd.take(a, p.nd.array([[0, 5], [-1, 1]]),
                                        axis=1),
    "take_wrap": lambda p, a: p.nd.take(a, p.nd.array([3.7, -1.0]), axis=2,
                                        mode="wrap"),
    "pick": lambda p, a: p.nd.pick(a, p.nd.array([[0, 3, 1], [2, 2, 9]]),
                                   axis=2),
    "pick_keepdims_wrap": lambda p, a: p.nd.pick(
        a, p.nd.array([[0, 5, 1, -1], [2, 2, 1, 0]]), axis=1, keepdims=True,
        mode="wrap"),
    "one_hot": lambda p, a: p.nd.one_hot(p.nd.array([0, 2, -1, 7]), depth=4,
                                         on_value=3.0, off_value=-1.0),
    "where": lambda p, a: p.nd.where(a > 0, a, a * 0.5),
    "where_rows": lambda p, a: p.nd.where(p.nd.array([1.0, 0.0]), a, -a),
    "dot": lambda p, a: p.nd.dot(a[0], p.nd.array(M).T),
    "dot_transpose_a": lambda p, a: p.nd.dot(a[0], a[1], transpose_a=True),
    "dot_transpose_b": lambda p, a: p.nd.dot(a[0], a[1], transpose_b=True),
    "dot_nd": lambda p, a: p.nd.dot(a, p.nd.array(M.T)),
    "dot_vec": lambda p, a: p.nd.dot(a[0, 0], a[1, 1]),
    "batch_dot": lambda p, a: p.nd.batch_dot(a, a, transpose_b=True),
    "batch_dot_ta": lambda p, a: p.nd.batch_dot(a, a, transpose_a=True),
    "matmul": lambda p, a: p.nd.matmul(a, p.nd.array(M.T)),
    "slice_assign": lambda p, a: a.slice_assign(p.nd.ones((1, 2, 2)),
                                                (0, 1, 0), (1, 3, 2)),
    "slice_assign_scalar": lambda p, a: a.slice_assign_scalar(
        5.0, (None, 0, 1), (None, 2, 4), (None, 1, 2)),
    "_zeros": lambda p, a: p.nd._zeros(shape=(2, 3), dtype="int32"),
    "_ones": lambda p, a: p.nd._ones(shape=(2,)),
    "_full": lambda p, a: p.nd._full(shape=(2,), value=4.5),
    "_arange": lambda p, a: p.nd._arange(start=1, stop=4, step=0.5, repeat=2),
    "fluent": lambda p, a: [a.exp(), a.sum(axis=1), a.clip(-0.5, 0.5),
                            a.flatten(), a.abs(), a.expand_dims(axis=0), a.squeeze(),
                            a.transpose(), a.relu(), a.sigmoid()],
}


@pytest.mark.parametrize("case", sorted(MATRIX))
def test_matrix_ops_match_jax_package(case):
    want, got = _both(lambda p: MATRIX[case](p, p.nd.array(A)))
    _same(want, got)


@pytest.mark.parametrize("case", ["transpose", "slice_step", "split", "take_clip",
                                  "pick", "where", "dot_transpose_b",
                                  "batch_dot", "slice_assign", "concat",
                                  "broadcast_to", "stack"])
def test_matrix_op_grads_match_jax_package(case):
    def run(p):
        a = p.nd.array(A)
        a.attach_grad()
        with p.autograd.record():
            out = MATRIX[case](p, a)
            out = out if isinstance(out, (list, tuple)) else [out]
            y = sum(((o * o).sum() for o in out), p.nd.zeros((1,)))
        y.backward()
        return a.grad
    want, got = _both(run)
    _same(want, got, rtol=1e-5, atol=1e-5)


def test_save_load_round_trip(tmp_path):
    fname = str(tmp_path / "arrs")
    d = {"w": tmx.nd.array(M), "b": tmx.nd.zeros((3,), dtype="int32")}
    tmx.nd.save(fname, d)
    back = tmx.nd.load(fname)
    assert set(back) == {"w", "b"}
    _same(d["w"], back["w"], 0, 0)
    _same(d["b"], back["b"], 0, 0)
    tmx.nd.save(fname, [tmx.nd.ones((2,)), tmx.nd.zeros((1,))])
    assert len(tmx.nd.load(fname)) == 2


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_save_load_across_packages(tmp_path, direction):
    src, dst = (jmx, tmx) if direction == "jax_to_port" else (tmx, jmx)
    fname = str(tmp_path / "cross.params")
    values = {"w": M, "i": np.arange(5, dtype=np.int32),
              "h": np.array([0.1, 65000.0], np.float16),
              "bf": np.array([1.5, -2.25, 3.0e38, 1e-3], np.float32)}
    arrays = {k: src.nd.array(v) for k, v in values.items()}
    arrays["bf"] = arrays["bf"].astype("bfloat16")
    src.nd.save(fname, arrays)
    back = dst.nd.load(fname)
    assert set(back) == set(values)
    for k in values:
        _same(arrays[k], back[k], 0, 0)
    src.nd.save(fname, [arrays["bf"], arrays["i"]])
    lst = dst.nd.load(fname)
    _same([arrays["bf"], arrays["i"]], lst, 0, 0)


def test_wait_to_read_and_waitall():
    a = tmx.nd.ones((4, 4))
    b = a @ a
    b.wait_to_read()
    tmx.nd.waitall()
    tmx.waitall()
    np.testing.assert_array_equal(b.asnumpy(), 4.0)


def test_conversions():
    a = tmx.nd.array([[1.0, 2.0], [3.0, 4.0]])
    assert a.shape == (2, 2) and a.size == 4 and a.ndim == 2 and len(a) == 2
    assert a[1, 1].asscalar() == 4.0 and float(a[0, 0]) == 1.0
    assert int(a[1, 0]) == 3 and a[0, 1].item() == 2.0
    assert [r.shape for r in a] == [(2,), (2,)]
    with pytest.raises(ValueError):
        bool(a)
    assert np.array_equal(np.asarray(a), a.asnumpy())
    assert "NDArray 2x2 @cpu(0)" in repr(a)
    assert "bfloat16" not in repr(a) and "NDArray 2" in repr(a.astype("bfloat16"))
