"""Port parity: the matrix ops of ``mxnet_tpu/ops/matrix.py`` that the
port registers with ``mx.nd`` (ordering, layout, gather and scatter,
sequence and creation ops), on the CPU, from seeded numpy inputs through
both packages' ``mx.nd``; the ``NDArray`` methods that reach them; their
``mx.sym`` forms and output counts.

Tolerances: fp32 outputs and gradients within 1e-6 of the largest |value|
(the same arithmetic; ``_linspace`` within 1e-6 too, the JAX package
computes it in fp32 and numpy in fp64); index, integer and boolean
outputs, and every dtype, exactly.  The ordering cases hold ties: ``topk``
takes the lower index first, a descending ``sort``/``argsort`` gives
ties in reverse index order, ``argmax``/``argmin`` the first extremum, as
``lax.top_k`` and jnp's stable sort do.  ``gather_nd``'s gradient and
``_backward_gather_nd`` add duplicate indices.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from torch_op_parity import check, outs, same


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)

def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _ties(seed=1):
    # values from a small set, so every row has ties
    return np.random.RandomState(seed).randint(0, 4, (3, 9)).astype(
        np.float32)


ORDERING = [
    ("topk", [_ties()], dict(k=4)),
    ("topk", [_ties()], dict(k=4, is_ascend=True)),
    ("topk", [_ties()], dict(k=3, ret_typ="value")),
    ("topk", [_ties()], dict(k=3, ret_typ="both", dtype="int32")),
    ("topk", [_ties()], dict(k=2, ret_typ="mask", axis=0)),
    ("topk", [_rand(2, 5, 6)], dict(k=2, axis=1, ret_typ="both")),
    ("sort", [_ties()], {}),
    ("sort", [_ties()], dict(is_ascend=False, axis=0)),
    ("argsort", [_ties()], {}),
    ("argsort", [_ties()], dict(is_ascend=False)),
    ("argsort", [_ties()], dict(axis=0, dtype="int32")),
    ("argmax", [_ties()], dict(axis=1)),
    ("argmax", [_ties()], dict(axis=0, keepdims=True)),
    ("argmax", [_ties()], {}),
    ("argmin", [_ties()], dict(axis=1)),
    ("argmin", [_rand(4, 5)], {}),
    ("argmax_channel", [_ties()], {}),
]

LAYOUT = [
    ("flip", [_rand(2, 3, 4)], dict(axis=1)),
    ("reverse", [_rand(2, 3, 4)], dict(axis=(0, 2))),
    ("tile", [_rand(2, 3)], dict(reps=(2, 1, 3))),
    ("repeat", [_rand(2, 3)], dict(repeats=2, axis=1)),
    ("repeat", [_rand(2, 3)], dict(repeats=3)),
    ("broadcast_axis", [_rand(2, 1, 3, 1)], dict(axis=(1, 3), size=(4, 2))),
    ("broadcast_axes", [_rand(1, 3)], dict(axis=0, size=5)),
    ("slice_like", [_rand(4, 5, 6), _rand(2, 3, 4)], dict(axes=(0, 2))),
    ("slice_like", [_rand(4, 5), _rand(2, 3)], {}),
    ("split_v2", [_rand(6, 4)], dict(indices_or_sections=3)),
    ("split_v2", [_rand(6, 4)], dict(indices_or_sections=(1, 3), axis=0)),
    ("_split_v2", [_rand(2, 6)], dict(indices_or_sections=2, axis=1,
                                      squeeze_axis=False)),
    ("split_v2", [_rand(3, 2)], dict(indices_or_sections=3,
                                     squeeze_axis=True)),
    ("depth_to_space", [_rand(2, 8, 3, 3)], dict(block_size=2)),
    ("space_to_depth", [_rand(2, 2, 4, 6)], dict(block_size=2)),
    ("diag", [_rand(4)], dict(k=1)),
    ("diag", [_rand(4, 5)], dict(k=-1)),
    ("diag", [_rand(2, 3, 4)], dict(k=1, axis1=1, axis2=2)),
    ("khatri_rao", [_rand(2, 3), _rand(4, 3, seed=1)], {}),
    ("shape_array", [_rand(2, 3, 4)], {}),
    ("size_array", [_rand(2, 3, 4)], {}),
]

_IDX = np.array([[0, 2, 0, 1], [1, 0, 1, 2]], np.int32)   # (0,1) twice
GATHER = [
    ("batch_take", [_rand(4, 5), np.array([0, 4, 2, -1], np.int32)], {}),
    ("gather_nd", [_rand(3, 3, 2), _IDX], {}),
    ("gather_nd", [_rand(3, 4), _IDX[:1]], {}),
    ("scatter_nd", [_rand(4, 2), np.array([[0, 2, 1, 3], [1, 0, 2, 2]],
                                         np.int32)], dict(shape=(4, 3, 2))),
    ("scatter_nd", [_rand(4, 2), _IDX], dict(shape=(3, 3, 2))),
    ("_scatter_set_nd", [_rand(3, 3), _rand(4), _IDX], dict(shape=(3, 3))),
    ("_backward_gather_nd", [_rand(4, 2), _IDX], dict(shape=(3, 3, 2))),
    ("_backward_gather_nd", [_rand(4), _IDX], dict(shape=(3, 3))),
    ("boolean_mask", [_rand(5, 3), np.array([1, 0, 1, 1, 0], np.float32)],
     {}),
    ("_contrib_boolean_mask", [_rand(3, 4),
                               np.array([0, 1, 1, 0], np.int32)],
     dict(axis=1)),
]

_LENS = np.array([2, 5, 1], np.float32)
SEQUENCE = [
    ("SequenceMask", [_rand(5, 3, 2), _LENS],
     dict(use_sequence_length=True, value=-1.0)),
    ("sequence_mask", [_rand(3, 5, 2), _LENS],
     dict(use_sequence_length=True, axis=1)),
    ("SequenceMask", [_rand(5, 3, 2)], {}),
    ("SequenceLast", [_rand(5, 3, 2), _LENS], dict(use_sequence_length=True)),
    ("sequence_last", [_rand(3, 5, 2), _LENS],
     dict(use_sequence_length=True, axis=1)),
    ("SequenceLast", [_rand(5, 3, 2)], {}),
    ("SequenceReverse", [_rand(5, 3, 2), _LENS],
     dict(use_sequence_length=True)),
    ("sequence_reverse", [_rand(5, 3)], {}),
]


@pytest.mark.parametrize("case", ORDERING, ids=lambda c: c[0])
def test_ordering_matches_jax(case):
    name, arrays, params = case
    check(name, arrays, params)


@pytest.mark.parametrize("case", LAYOUT, ids=lambda c: c[0])
def test_layout_matches_jax(case):
    name, arrays, params = case
    check(name, arrays, params, grad=True)


@pytest.mark.parametrize("case", GATHER, ids=lambda c: c[0])
def test_gather_scatter_matches_jax(case):
    name, arrays, params = case
    check(name, arrays, params, grad=name != "_backward_gather_nd")


@pytest.mark.parametrize("case", SEQUENCE, ids=lambda c: c[0])
def test_sequence_matches_jax(case):
    name, arrays, params = case
    check(name, arrays, params, grad=True)


CREATION = [
    ("_eye", dict(N=3, M=5, k=1)), ("_eye", dict(N=4, dtype="int32")),
    ("_npi_eye", dict(N=3, k=-1)),
    ("_linspace", dict(start=-1.0, stop=2.0, num=7)),
    ("_linspace", dict(start=0, stop=1, num=5, endpoint=False)),
    ("_npi_linspace", dict(start=1, stop=3, num=4)),
    ("_zeros_without_dtype", dict(shape=(2, 3))),
    ("_npi_zeros", dict(shape=(2,), dtype="int32")),
    ("_npi_ones", dict(shape=(3, 1))),
    ("_npi_full", dict(shape=(2, 2), value=3.5)),
    ("_npi_arange", dict(start=1, stop=7, step=2)),
]


@pytest.mark.parametrize("case", CREATION, ids=lambda c: c[0])
def test_creation_matches_jax(case):
    name, params = case
    check(name, [], params)


def test_ndarray_methods_match_jax():
    """The 18 methods of ``NDArray`` that reach these ops (and
    ``softmin``), called on both packages' arrays."""
    x, t = _ties(), _rand(2, 8, 2, 2)
    calls = [("argmax", x, dict(axis=1)), ("argmin", x, dict(axis=0)),
             ("argmax_channel", x, {}), ("argsort", x, {}),
             ("sort", x, dict(is_ascend=False)), ("topk", x, dict(k=2)),
             ("flip", x, dict(axis=1)), ("tile", x, dict(reps=(1, 2))),
             ("repeat", x, dict(repeats=2, axis=0)), ("diag", x, {}),
             ("broadcast_axes", x[:1], dict(axis=0, size=3)),
             ("split_v2", x, dict(indices_or_sections=3, axis=0)),
             ("shape_array", x, {}), ("size_array", x, {}),
             ("depth_to_space", t, dict(block_size=2)),
             ("space_to_depth", t, dict(block_size=2)),
             ("softmin", x, dict(axis=1))]
    for name, a, params in calls:
        ref = outs(getattr(jmx.nd.array(a), name)(**params))
        got = outs(getattr(tmx.nd.array(a), name)(**params))
        for g, r in zip(got, ref):
            same(g.asnumpy(), r.asnumpy(), name)
    ref = jmx.nd.array(x).slice_like(jmx.nd.array(x[:2, :3]))
    got = tmx.nd.array(x).slice_like(tmx.nd.array(x[:2, :3]))
    same(got.asnumpy(), ref.asnumpy(), "slice_like")


SYMBOLS = [
    ("topk", dict(k=3, ret_typ="both"), (4, 9)),
    ("topk", dict(k=3), (4, 9)),
    ("split_v2", dict(indices_or_sections=(1, 3)), (6, 2)),
    ("split_v2", dict(indices_or_sections=2, axis=1), (6, 2)),
    ("argmax", dict(axis=1, keepdims=True), (4, 9)),
    ("tile", dict(reps=(2, 3)), (4, 9)),
    ("depth_to_space", dict(block_size=2), (1, 8, 2, 3)),
    ("SequenceLast", {}, (5, 3, 2)),
]


@pytest.mark.parametrize("case", SYMBOLS, ids=lambda c: c[0])
def test_symbol_forms_match_jax(case):
    """``mx.sym``: the output count, ``infer_shape`` against the JAX
    package's, and the evaluated graph against ``mx.nd``."""
    name, params, shape = case
    jsym = getattr(jmx.sym, name)(jmx.sym.var("x"), **params)
    tsym = getattr(tmx.sym, name)(tmx.sym.var("x"), **params)
    assert len(tsym.list_outputs()) == len(jsym.list_outputs())
    assert tsym.infer_shape(x=shape)[1] == jsym.infer_shape(x=shape)[1]
    a = _rand(*shape)
    got = outs(tsym.eval_with({"x": tmx.nd.array(a)}))
    want = outs(getattr(tmx.nd, name)(tmx.nd.array(a), **params))
    for g, w in zip(got, want):
        same(g.asnumpy(), w.asnumpy(), name)


def test_boolean_mask_refuses_shape_inference():
    """Its output shape depends on the mask's values: symbol shape
    inference (on ``meta`` tensors) raises rather than guess one."""
    sym = tmx.sym.boolean_mask(tmx.sym.var("x"), tmx.sym.var("m"))
    with pytest.raises(MXNetError, match="boolean_mask"):
        sym.infer_shape(x=(4, 3), m=(4,))


def test_backward_gather_nd_adds_duplicates_in_fixed_order():
    """Duplicates add (in both packages), and the plain version gives the
    same bits on every run; bf16 adds in fp32 on the card and row by row
    on the CPU, so here it is held to the fp32 sum within its rounding."""
    rng = np.random.RandomState(3)
    idx = rng.randint(0, 4, (2, 64)).astype(np.int32)
    data = rng.randn(64, 5).astype(np.float32)
    check("_backward_gather_nd", [data, idx], dict(shape=(4, 4, 5)))
    t = tmx.nd._backward_gather_nd(tmx.nd.array(data), tmx.nd.array(idx),
                                   shape=(4, 4, 5))
    again = tmx.nd._backward_gather_nd(tmx.nd.array(data),
                                       tmx.nd.array(idx), shape=(4, 4, 5))
    assert np.array_equal(t.asnumpy(), again.asnumpy())
    b = tmx.nd._backward_gather_nd(
        tmx.nd.array(data).astype("bfloat16"), tmx.nd.array(idx),
        shape=(4, 4, 5)).astype("float32").asnumpy()
    ref = t.asnumpy()
    assert np.abs(b - ref).max() <= 2 ** -6 * np.abs(ref).max()


def test_topk_ties_take_lower_index():
    x = np.array([[1, 3, 3, 0, 3]], np.float32)
    got = tmx.nd.topk(tmx.nd.array(x), k=3).asnumpy()
    assert got.tolist() == [[1.0, 2.0, 4.0]]
    asc = tmx.nd.argsort(tmx.nd.array(x), is_ascend=False).asnumpy()
    assert asc.tolist() == [[4.0, 2.0, 1.0, 0.0, 3.0]]
    assert torch.equal(torch.as_tensor(got), torch.as_tensor(
        jmx.nd.topk(jmx.nd.array(x), k=3).asnumpy()))
