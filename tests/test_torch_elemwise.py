"""Port parity: every op the port registers from ops/elemwise.py and
ops/reduce.py that the JAX package has, through ``mx.nd`` in both
packages on the same seeded numpy inputs.

One parametrised test per name (aliases included) compares the result,
its dtype and, for differentiable ops on float inputs, the gradient of
``sum(out * w)`` for a fixed random ``w``.  Tolerances: float32 within
2e-6 relative and 1e-6 absolute (the same math in XLA's and torch's
kernels: transcendental functions differ in the last bits, sums in their
order; ``cbrt``, which torch lacks and the port computes as
``sign(x)|x|^(1/3)``, and the gamma family within 2e-5 relative); bfloat16
within 2^-7 relative (one bf16 ulp: both compute in fp32 and round once,
but the fp32 values may straddle a rounding boundary).
"""
import ast
from pathlib import Path

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import parity as tparity
from mxnet_tpu_torch.ops import registry as treg



@pytest.fixture(autouse=True)
def _cpu_default():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)


# the other names of these ops (ops/parity.py) have their own test file,
# test_torch_ops_parity.py
PARITY_NAMES = {a for names in tparity.ALIASES.values() for a in names}
NAMES = sorted(n for n, op in treg.REGISTRY.items()
               if op.fn.__module__.rsplit(".", 1)[-1] in ("elemwise", "reduce")
               and n in jreg.REGISTRY and n not in PARITY_NAMES)
LOOSE = {"cbrt", "rcbrt", "gamma", "gammaln", "digamma", "erfinv", "_power",
         "broadcast_power", "_rpower_scalar", "_power_scalar", "logsumexp"}
POSITIVE = {"log", "log10", "log2", "sqrt", "rsqrt", "gamma", "gammaln",
            "digamma", "reciprocal", "rcbrt", "cbrt", "_rpower_scalar",
            "_power_scalar", "broadcast_power", "_power", "_rdiv_scalar",
            "_rmod_scalar", "broadcast_mod", "broadcast_floordiv",
            "broadcast_div", "elemwise_div", "_scatter_elemwise_div",
            "broadcast_hypot", "_hypot_scalar", "L2Normalization", "prod",
            "nanprod"}
COMPARE = {"broadcast_equal", "broadcast_not_equal", "broadcast_greater",
           "broadcast_greater_equal", "broadcast_lesser",
           "broadcast_lesser_equal", "broadcast_logical_and",
           "broadcast_logical_or", "broadcast_logical_xor", "_equal_scalar",
           "_not_equal_scalar", "_greater_scalar", "_greater_equal_scalar",
           "_lesser_scalar", "_lesser_equal_scalar", "_logical_and_scalar",
           "_logical_or_scalar", "_logical_xor_scalar", "logical_not",
           "sign", "round", "rint", "ceil", "floor", "trunc", "fix"}
REDUCE_PARAMS = [{}, {"axis": 1}, {"axis": (0, 2), "keepdims": True},
                 {"axis": 1, "exclude": True}, {"axis": -1}]
PARAMS = {
    "hard_sigmoid": [{}, {"alpha": 0.5, "beta": 0.1}],
    "cast": [{"dtype": "float16"}, {"dtype": "int32"}, {"dtype": "bfloat16"}],
    "Cast": [{"dtype": "float16"}],
    "clip": [{"a_min": -0.3, "a_max": 0.4}, {"a_max": 0.0}],
    "smooth_l1": [{}, {"scalar": 2.0}],
    "_getitem": [{"key": (1, slice(0, 2))}, {"key": (Ellipsis, 0)}],
    "norm": [{}, {"ord": 1, "axis": 1}, {"axis": (1, 2), "keepdims": True},
             {"ord": 2, "axis": 0, "out_dtype": "float16"}],
    "L2Normalization": [{}, {"mode": "channel"}, {"mode": "spatial"}],
    "moments": [{"axes": (0, 2)}, {"axes": 1, "keepdims": True}],
    "logsumexp": [{}, {"axis": 1}, {"axis": 2, "keepdims": True}],
    "cumsum": [{}, {"axis": 1}, {"axis": 0, "dtype": "float32"}],
    "_np_cumsum": [{"axis": 2}],
}
for _n in ("sum", "sum_axis", "mean", "prod", "nansum", "nanprod", "max",
           "max_axis", "min", "min_axis"):
    PARAMS[_n] = REDUCE_PARAMS


def _inputs(name, dtype, rng):
    shape = (2, 3, 4)
    if name in COMPARE:
        x = rng.randint(-2, 3, shape).astype(np.float32)
        x[0, 0, :2] = (0.5, -1.5)
    elif name in POSITIVE:
        x = rng.uniform(0.2, 2.0, shape).astype(np.float32)
    elif name == "arccosh":
        x = rng.uniform(1.1, 3.0, shape).astype(np.float32)
    elif name in ("isnan", "isinf", "isfinite", "nansum", "nanprod"):
        x = rng.randn(*shape).astype(np.float32)
        x[0, 0, :3] = (np.nan, np.inf, -np.inf)
    else:
        x = rng.uniform(-0.9, 0.9, shape).astype(np.float32)
    rhs = (rng.randint(-2, 3, (4,)).astype(np.float32) if name in COMPARE
           else rng.randint(-3, 4, (4,)).astype(np.float32) if name == "ldexp"
           else rng.uniform(0.5, 1.5, (4,)).astype(np.float32))
    return x, rhs


def _call(pkg, name, x, rhs, params, dtype, attach):
    op = jreg.get(name)
    a = pkg.nd.array(x, dtype=dtype)
    if attach:
        a.attach_grad()
    args = [a]
    if name == "add_n" or name in ("ElementWiseSum", "_sum_of"):
        args = [a, a * 2.0, pkg.nd.array(x[::-1].copy(), dtype=dtype)]
    elif op.nin == 2:
        args.append(pkg.nd.array(rhs, dtype="int32" if name == "ldexp"
                                 else dtype))
    if name.endswith("_scalar"):
        params = dict(params, scalar=(1.0 if name in COMPARE else 1.5))
    fn = getattr(pkg.nd, name)
    with pkg.autograd.record():
        out = fn(*args, **params)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        if attach:
            w = np.asarray(np.random.RandomState(1).randn(*outs[0].shape))
            head = (outs[0].astype("float32") *
                    pkg.nd.array(w.astype(np.float32))).sum()
    if attach:
        head.backward()
        return outs, a.grad
    return outs, None


def _check(want, got, name, dtype):
    w, g = want.asnumpy(), got.asnumpy()
    assert g.shape == w.shape and str(g.dtype) == str(w.dtype), (
        g.shape, w.shape, g.dtype, w.dtype)
    if dtype == "bfloat16" and str(w.dtype) == "bfloat16":
        rtol, atol = 2.0 ** -7, 1e-6
    else:
        rtol, atol = (2e-5 if name in LOOSE else 2e-6), 1e-6
    if g.dtype == np.bool_ or np.issubdtype(g.dtype, np.integer):
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g.astype(np.float32), w.astype(np.float32),
                                   rtol=rtol, atol=atol, equal_nan=True)


@pytest.mark.parametrize("name", NAMES)
def test_op_matches_jax_package(name):
    op = treg.get(name)
    dtypes = ["float32"] + (["bfloat16"] if name in (
        "broadcast_add", "broadcast_mul", "_plus_scalar", "_mul_scalar",
        "_rdiv_scalar", "exp", "sigmoid", "tanh", "sum", "mean", "max",
        "relu", "square", "negative") else [])
    for dtype in dtypes:
        for params in PARAMS.get(name, [{}]):
            rng = np.random.RandomState(0)
            x, rhs = _inputs(name, dtype, rng)
            attach = (op.differentiable and dtype == "float32"
                      and name not in COMPARE and "dtype" not in params
                      and name not in ("isnan", "isinf", "isfinite",
                                       "nansum", "nanprod", "BlockGrad",
                                       "stop_gradient", "zeros_like",
                                       "ones_like"))
            jo, jg = _call(jmx, name, x, rhs, params, dtype, attach)
            to, tg = _call(tmx, name, x, rhs, params, dtype, attach)
            assert len(jo) == len(to)
            for w, g in zip(jo, to):
                _check(w, g, name, dtype)
            if attach:
                _check(jg, tg, name, dtype)


def _registered_by(path):
    """Every op name a JAX package module registers: the keys of its
    ``_UNARY``/``_BINARY``/``_SCALAR`` tables, and the names and aliases of
    its ``register`` and ``alias`` calls."""
    tree = ast.parse(Path(path).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and node.targets[0].id in ("_UNARY", "_BINARY", "_SCALAR"):
            names |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") in (
                "register", "alias"):
            consts = [a.value for a in node.args
                      if isinstance(a, ast.Constant) and isinstance(a.value, str)]
            names |= set(consts)
            for kw in node.keywords:
                if kw.arg == "aliases":
                    names |= {e.value for e in kw.value.elts}
    return names


def test_every_elemwise_and_reduce_name_is_covered():
    """The port registers the JAX package's whole elemwise and reduce
    modules: 120 elemwise names with their aliases, 16 reduce names."""
    import mxnet_tpu
    root = Path(mxnet_tpu.__file__).parent / "ops"
    elemwise = _registered_by(root / "elemwise.py")
    reduce_ = _registered_by(root / "reduce.py")
    assert (len(elemwise), len(reduce_)) == (120, 16)
    port = {n for n, op in treg.REGISTRY.items()
            if op.fn.__module__.rsplit(".", 1)[-1] in ("elemwise", "reduce")
            and n not in PARITY_NAMES}
    assert port == elemwise | reduce_
    assert port <= set(NAMES)


def test_round_is_half_away_from_zero_and_rint_half_even():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], np.float32)
    for pkg in (jmx, tmx):
        a = pkg.nd.array(x)
        np.testing.assert_array_equal(pkg.nd.round(a).asnumpy(),
                                      [-3, -2, -1, 1, 2, 3])
        np.testing.assert_array_equal(pkg.nd.rint(a).asnumpy(),
                                      [-2, -2, -0, 0, 2, 2])
        np.testing.assert_array_equal(
            pkg.nd.round(pkg.nd.array([3, -4], dtype="int32")).asnumpy(),
            [3, -4])


def test_integer_reductions_keep_their_dtype():
    x = np.arange(12, dtype=np.int32).reshape(3, 4)
    for name in ("sum", "prod", "max", "min", "mean", "cumsum"):
        want = getattr(jmx.nd, name)(jmx.nd.array(x))
        got = getattr(tmx.nd, name)(tmx.nd.array(x))
        _check(want, got, name, "int32")


_NAN, _INF = np.nan, np.inf
_POLES = np.array([0.0, -0.0, -1.0, -2.5, 1e-30, -3.0, 0.5], np.float32)
_EDGE_CASES = {
    "max_nan": (lambda mx, a: mx.nd.max(a), [1.0, _NAN, 3.0]),
    "max_tie": (lambda mx, a: mx.nd.max(a), [3.0, 1.0, 3.0]),
    "max_axis": (lambda mx, a: mx.nd.max(a, axis=1),
                 [[1.0, _NAN, 3.0], [_INF, _INF, 1.0]]),
    "max_keepdims": (lambda mx, a: mx.nd.max(a, axis=0, keepdims=True),
                     [[1.0, 2.0], [1.0, _NAN]]),
    "min_exclude": (lambda mx, a: mx.nd.min(a, axis=1, exclude=True),
                    [[[1.0, 2.0], [1.0, _NAN]], [[0.0, 2.0], [3.0, 1.0]]]),
    "broadcast_maximum": (
        lambda mx, a: mx.nd.broadcast_maximum(a, mx.nd.array(
            np.array([[2.0], [_NAN]], np.float32))), [1.0, 2.0, 3.0]),
    "broadcast_minimum": (
        lambda mx, a: mx.nd.broadcast_minimum(a, mx.nd.array(
            np.array([2.0, 2.0, _NAN], np.float32))), [1.0, _NAN, 3.0]),
    "_maximum_scalar": (lambda mx, a: mx.nd.maximum(a, 2.0),
                        [2.0, _INF, -_INF, _NAN]),
    "_minimum_scalar": (lambda mx, a: mx.nd.minimum(a, 2.0),
                        [2.0, _INF, -_INF, _NAN]),
    "digamma": (lambda mx, a: mx.nd.digamma(a), _POLES),
    "gamma": (lambda mx, a: mx.nd.gamma(a), _POLES),
    "gammaln": (lambda mx, a: mx.nd.gammaln(a), _POLES),
}


@pytest.mark.parametrize("case", sorted(_EDGE_CASES))
def test_nan_and_pole_edge_cases_match_jax(case):
    """NaN inputs, ties and the gamma family's poles: values and
    gradients as the JAX package's (a NaN max sends its gradient nowhere,
    a tie splits it; digamma is NaN at 0 and its derivative +inf at the
    non-positive integers).  NaN and inf must match in place; finite
    values within the gamma family's 2e-5 relative."""
    fn, x = _EDGE_CASES[case]
    got = []
    for mx in (jmx, tmx):
        a = mx.nd.array(np.asarray(x, np.float32))
        a.attach_grad()
        with mx.autograd.record():
            y = fn(mx, a)
        y.backward(mx.nd.ones(y.shape))
        got.append((y.asnumpy(), a.grad.asnumpy()))
    for j, t in zip(*got):
        assert j.shape == t.shape
        np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
        np.testing.assert_array_equal(np.isinf(t), np.isinf(j))
        np.testing.assert_allclose(t, j, rtol=2e-5, atol=1e-6,
                                   equal_nan=True)
