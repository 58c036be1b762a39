"""Port parity: the ops of ``mxnet_tpu/ops/parity.py`` (``UpSampling``,
``col2im``, ``_histogram``, ``arange_like``, the AMP casts, ``cast_storage``,
``_square_sum``, ``_sparse_retain``, ``_contrib_getnnz``, the identities
with gradients of their own, ``_rnn_param_concat`` and the ``_npi_``/
``_npx_`` ops) and the 29 names the JAX package registers over ops the
port already had (``equal`` ... ``logical_xor`` with their underscore
forms, ``_hypot``, ``_grad_add``, ``_scatter_plus_scalar``,
``_scatter_minus_scalar``, ``_np_copy``, ``_npx_relu``, ``_npx_sigmoid``),
on the CPU, from seeded numpy inputs through both packages' ``mx.nd``.

Tolerances: outputs and gradients within 1e-6 of the largest |value|;
integer outputs (histogram counts, nonzero counts, indices) and every
dtype exactly.  An alias is held to the JAX package's alias, so its
output dtype is the canonical op's in both.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import registry as treg
from torch_op_parity import check


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _ints(*shape, seed=0, high=3):
    return np.random.RandomState(seed).randint(0, high, shape).astype(
        np.float32)


_A, _B = _ints(3, 4, seed=1), _ints(1, 4, seed=2) + 1
ALIASES = [
    ("equal", [_A, _B], {}), ("_equal", [_A, _B], {}),
    ("not_equal", [_A, _B], {}), ("_not_equal", [_A, _B], {}),
    ("greater", [_A, _B], {}), ("_greater", [_A, _B], {}),
    ("greater_equal", [_A, _B], {}), ("_greater_equal", [_A, _B], {}),
    ("less", [_A, _B], {}), ("lesser", [_A, _B], {}),
    ("_lesser", [_A, _B], {}), ("less_equal", [_A, _B], {}),
    ("lesser_equal", [_A, _B], {}), ("_lesser_equal", [_A, _B], {}),
    ("mod", [_rand(3, 4), _B], {}), ("_mod", [_rand(3, 4), _B], {}),
    ("logical_and", [_A, _B], {}), ("_logical_and", [_A, _B], {}),
    ("logical_or", [_A, _B], {}), ("_logical_or", [_A, _B], {}),
    ("logical_xor", [_A, _B], {}), ("_logical_xor", [_A, _B], {}),
    ("_hypot", [_rand(3, 4), _rand(3, 4, seed=1)], {}),
    ("_grad_add", [_rand(3, 4), _rand(1, 4, seed=1)], {}),
    ("_scatter_plus_scalar", [_rand(3, 4)], dict(scalar=2.5)),
    ("_scatter_minus_scalar", [_rand(3, 4)], dict(scalar=2.5)),
    ("_np_copy", [_rand(3, 4)], {}),
    ("_npx_relu", [_rand(3, 4)], {}),
    ("_npx_sigmoid", [_rand(3, 4)], {}),
]


@pytest.mark.parametrize("case", ALIASES, ids=lambda c: c[0])
def test_alias_matches_jax(case):
    name, arrays, params = case
    assert treg.get(name).aliases and name in treg.get(name).aliases
    check(name, arrays, params, grad=True)


def _bilinear(c, scale):
    k = 2 * scale - scale % 2
    f = np.ceil(k / 2.0)
    cen = (2 * f - 1 - f % 2) / (2.0 * f)
    og = np.arange(k)
    w1 = 1 - np.abs(og / f - cen)
    return np.tile(np.outer(w1, w1), (c, 1, 1, 1)).astype(np.float32)


_ROWS = np.array([0, 3, 3], np.float32)
PARITY = [
    ("UpSampling", [_rand(2, 3, 4, 4)], dict(scale=2)),
    ("upsampling", [_rand(1, 2, 4, 4), _rand(1, 3, 2, 2, seed=1)],
     dict(scale=2, num_args=2)),
    ("UpSampling", [_rand(1, 2, 4, 4), _rand(1, 2, 2, 2, seed=1)],
     dict(scale=2, num_args=2, multi_input_mode="sum")),
    ("UpSampling", [_rand(1, 3, 4, 5), _bilinear(3, 2)],
     dict(scale=2, sample_type="bilinear", num_filter=3)),
    ("UpSampling", [_rand(1, 2, 3, 3), _bilinear(2, 3)],
     dict(scale=3, sample_type="bilinear", num_filter=2)),
    ("col2im", [_rand(2, 27, 9)], dict(output_size=(5, 6), kernel=(3, 3),
                                        stride=(2, 2), pad=(1, 1))),
    ("col2im", [_rand(1, 8, 9)], dict(output_size=(6, 6), kernel=(2, 2),
                                      stride=(2, 2))),
    ("_histogram", [_rand(50)], dict(bin_cnt=7)),
    ("histogram", [_rand(4, 9)], dict(bin_cnt=5, range=(-1.0, 1.5))),
    ("arange_like", [_rand(2, 3)], dict(start=1.5, step=0.5)),
    ("_contrib_arange_like", [_rand(4, 3)], dict(axis=0, repeat=2)),
    ("_npx_arange_like", [_rand(2, 5)], dict(start=-2.0, axis=1)),
    ("amp_cast", [_rand(2, 3)], dict(dtype="float16")),
    ("amp_cast", [_ints(2, 3).astype(np.int32)], dict(dtype="float16")),
    ("amp_multicast", [_rand(2, 3).astype(np.float16), _rand(2, 3, seed=1),
                       _ints(2).astype(np.int32)], dict(num_outputs=3)),
    ("amp_multicast", [_rand(2, 3).astype(np.float16), _rand(3, seed=1)],
     dict(num_outputs=2, cast_narrow=True)),
    ("cast_storage", [_rand(2, 3)], dict(stype="default")),
    ("_square_sum", [_rand(3, 4)], dict(axis=1)),
    ("square_sum", [_rand(3, 4)], dict(axis=0, keepdims=True)),
    ("_square_sum", [_rand(3, 4)], {}),
    ("_sparse_retain", [_rand(5, 2), _ROWS], {}),
    ("_contrib_getnnz", [_ints(4, 5)], {}),
    ("_contrib_getnnz", [_ints(4, 5)], dict(axis=1)),
    ("_identity_with_attr_like_rhs", [_rand(2, 3), _rand(2, 3, seed=1)], {}),
    ("IdentityAttachKLSparseReg",
     [np.random.RandomState(5).rand(6, 4).astype(np.float32)],
     dict(sparseness_target=0.2, penalty=0.01)),
    ("_rnn_param_concat", [_rand(6), _rand(4, seed=1)], dict(num_args=2)),
    ("_npi_identity", [], dict(shape=(4, 4))),
    ("_npi_indices", [], dict(dimensions=(2, 3))),
    ("_npx_reshape", [_rand(2, 3, 4)], dict(newshape=(-2, -1))),
    ("_npx_reshape", [_rand(2, 1, 12)], dict(newshape=(-2, -3, -6, 3, -1))),
    ("_npx_reshape", [_rand(2, 3, 4)], dict(newshape=(-5, -2))),
    ("_npx_reshape", [_rand(2, 3, 4)], dict(newshape=(-4,))),
    ("_npx_reshape", [_rand(2, 3, 4)], dict(newshape=(-1, -6, 2, 2),
                                            reverse=True)),
    ("_npx_constraint_check", [_ints(3, high=2) + 1], {}),
    ("_npx_constraint_check", [_ints(5, high=2)], {}),
]


@pytest.mark.parametrize("case", PARITY, ids=lambda c: c[0])
def test_parity_op_matches_jax(case):
    name, arrays, params = case
    check(name, arrays, params, grad=treg.get(name).differentiable)


def test_share_memory():
    """One array shares its memory with itself and with no other."""
    for mx in (jmx, tmx):
        x, y = mx.nd.ones((2, 2)), mx.nd.ones((2, 2))
        assert bool(mx.nd._npi_share_memory(x, x).asnumpy())
        assert not bool(mx.nd._npi_share_memory(x, y).asnumpy())


def test_registry_has_every_a3_name():
    """Every name the JAX package registers from ``ops/matrix.py``,
    ``ops/nn.py``, ``ops/attention.py``, ``ops/parity.py``,
    ``ops/random_ops.py`` and ``ops/elemwise.py`` is in the port's
    registry and on its ``mx.nd`` (and on ``mx.sym`` where the JAX
    package's ``mx.sym`` has it), but ``_contrib_SparseEmbedding``, which
    waits for row-sparse data."""
    from mxnet_tpu.ops import registry as jreg
    modules = {f"mxnet_tpu.ops.{m}" for m in (
        "matrix", "nn", "attention", "parity", "random_ops", "elemwise")}
    names = {n for n, op in jreg.REGISTRY.items()
             if op.fn.__module__ in modules}
    missing = sorted(n for n in names if n not in treg.REGISTRY)
    assert missing == ["_contrib_SparseEmbedding"]
    for n in names - {"_contrib_SparseEmbedding"}:
        assert callable(getattr(tmx.nd, n)), n
        if hasattr(jmx.sym, n):
            assert callable(getattr(tmx.sym, n)), n
