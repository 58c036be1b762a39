"""Port parity: mxnet_tpu_torch.rtc against mxnet_tpu.rtc.

Every kernel source of the JAX package's rtc tests
(tests/test_misc_components.py:232-265, 372; tests/test_surface_probe_r6.py:
117-157) goes through both packages' ``PallasModule`` on the CPU: the JAX
package in Pallas's interpreter, the port over torch views.  The sources
use only ``[...]`` reads and writes and arithmetic, so the same text runs
in both.  float32 results are within 1 ulp (XLA may contract ``a * x + y``
into a fused multiply-add, which rounds once where torch rounds twice);
int32 results are equal bit for bit.  ``CudaModule`` needs a card: without
one it raises, and its launch checks run before anything reaches the card.
"""
import ctypes

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import rtc as jrtc
from mxnet_tpu_torch import rtc as trtc


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)


AXPY = """
def axpy(x_ref, y_ref, o_ref, a):
    o_ref[...] = a * x_ref[...] + y_ref[...]
"""
DOUBLE = """
def double(x_ref, o_ref):
    o_ref[...] = x_ref[...] * 2.0
"""
SPLIT = """
def split(x_ref, a_ref, b_ref):
    a_ref[...] = x_ref[...] * 2.0
    b_ref[...] = x_ref[...] + 1.0
"""
SCALED = """
def scaled(x_ref, a, o_ref):
    o_ref[...] = a * x_ref[...]
"""
INC = "def inc(x_ref, o_ref):\n    o_ref[...] = x_ref[...] + 1\n"
COPY = "def k(x_ref, o_ref):\n    o_ref[...] = x_ref[...]\n"

rng = np.random.RandomState(0)
X8 = rng.randn(8).astype(np.float32)
Y8 = rng.randn(8).astype(np.float32)
X44 = rng.randn(4, 4).astype(np.float32)
X63 = rng.randn(6, 3).astype(np.float32)
I5 = rng.randint(-1000, 1000, 5).astype(np.int32)

# (source, kernel, signature, inputs, scalars at their positions, outputs
# as (shape, dtype), grid, block)
CASES = {
    "axpy_whole_array": (AXPY, "axpy",
                         "const float *x, const float *y, float *o, "
                         "const float a", [X8, Y8, ((8,), "float32"), 2.0],
                         (1, 1, 1), (0, 0, 0)),
    "axpy_rounded_scalar": (AXPY, "axpy",
                            "const float *x, const float *y, float *o, "
                            "const float a", [X8, Y8, ((8,), "float32"), 0.1],
                            (1, 1, 1), (0, 0, 0)),
    "double_tiled_grid": (DOUBLE, "double", "const float *x, float *o",
                          [X44, ((4, 4), "float32")], (2, 1, 1), (2, 0, 0)),
    "double_2d_grid": (DOUBLE, "double", "const float *x, float *o",
                       [X63, ((6, 3), "float32")], (3, 1, 1), (2, 3, 0)),
    "split_two_outputs": (SPLIT, "split", "const float *x, float *a, float *b",
                          [X8, ((8,), "float32"), ((8,), "float32")],
                          (1, 1, 1), (0, 0, 0)),
    "scaled_scalar_before_output": (SCALED, "scaled",
                                    "const float *x, const float a, float *o",
                                    [X8, 3.0, ((8,), "float32")], (1, 1, 1),
                                    (0, 0, 0)),
    "int32_increment": (INC, "inc", "const int32_t *x, int32_t *o",
                        [I5, ((5,), "int32")], (1, 1, 1), (0, 0, 0)),
}


def _run(pkg, source, name, sig, spec, grid, block):
    m = pkg.rtc.PallasModule(source)
    k = m.get_kernel(name, sig)
    args, outs = [], []
    for a in spec:
        if isinstance(a, np.ndarray):
            args.append(pkg.nd.array(a, dtype=a.dtype))
        elif isinstance(a, tuple):
            outs.append(pkg.nd.zeros(a[0], dtype=a[1]))
            args.append(outs[-1])
        else:
            args.append(a)
    ret = k.launch(args, pkg.current_context() if pkg is jmx else tmx.cpu(),
                   grid, block)
    ret = ret if isinstance(ret, list) else [ret]
    assert len(ret) == len(outs) and all(r is o for r, o in zip(ret, outs))
    return [o.asnumpy() for o in outs]


@pytest.mark.parametrize("case", sorted(CASES))
def test_pallas_module_matches_jax_package(case):
    source, name, sig, spec, grid, block = CASES[case]
    want = _run(jmx, source, name, sig, spec, grid, block)
    got = _run(tmx, source, name, sig, spec, grid, block)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        if g.dtype == np.int32:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_array_max_ulp(g, w, maxulp=1)


def test_tiled_grid_gives_each_program_its_block():
    src = """
def rows(x_ref, o_ref):
    o_ref[...] = x_ref[...] * 0.0 + x_ref[0:1, 0:1]
"""
    x = np.arange(16, dtype=np.float32).reshape(4, 4)
    for pkg in (jmx, tmx):
        k = pkg.rtc.PallasModule(src).get_kernel("rows",
                                                 "const float *x, float *o")
        o = pkg.nd.zeros((4, 4))
        k.launch([pkg.nd.array(x), o], None, (2, 1, 1), (2, 0, 0))
        np.testing.assert_array_equal(o.asnumpy(),
                                      np.repeat([[0.0], [8.0]], 2, 0) + 0 * x)


SIGNATURE_FRAGMENTS = [
    "const float *x", "float *y", "const int n", "int n", "double *d",
    "const double s", "const __half *h", "half *h2", "const bfloat16 *b",
    "uint8_t *u", "const int8_t *i8", "int32_t *i32", "const int64_t n64",
    "long *l", "const float* x", "float*y", "  const   float   *   z  ",
    "const float a, float *o, const int n",
]


@pytest.mark.parametrize("fragment", SIGNATURE_FRAGMENTS)
def test_parse_signature_matches_jax_package(fragment):
    want = [(n, np.dtype(d).name, k) for n, d, k in
            jrtc._parse_signature(fragment)]
    got = [(n, str(d).replace("torch.", ""), k) for n, d, k in
           trtc._parse_signature(fragment)]
    assert got == want


@pytest.mark.parametrize("fragment", ["float &bad&", "const float **x",
                                      "complex *c", "float"])
def test_parse_signature_refuses_what_the_jax_package_refuses(fragment):
    with pytest.raises(ValueError):
        jrtc._parse_signature(fragment)
    with pytest.raises(ValueError):
        trtc._parse_signature(fragment)


def _errors(pkg):
    """The JAX package's rtc error cases, as (name, thunk, exception,
    match)."""
    nd, ctx = pkg.nd, (pkg.current_context() if pkg is jmx else tmx.cpu())
    m = pkg.rtc.PallasModule(COPY)
    k = m.get_kernel("k", "const float *x, float *o")
    no_out = pkg.rtc.PallasModule(
        "def k(o_ref):\n    o_ref[...] = 0.0\n").get_kernel("k",
                                                          "const float *x")
    return [
        ("missing_export", lambda: pkg.rtc.PallasModule(
            "x = 1", exports=["missing"]), ValueError, "missing"),
        ("bad_signature", lambda: m.get_kernel("k", "float &bad&"),
         ValueError, "parse"),
        ("not_in_exports", lambda: pkg.rtc.PallasModule(
            COPY, exports=["k"]).get_kernel("j", "float *o"), ValueError,
         "not found"),
        ("no_output", lambda: no_out.launch([nd.zeros((2,))], ctx),
         ValueError, "no output"),
        ("dtype", lambda: k.launch([nd.array(np.zeros(3, dtype="int32")),
                                    nd.zeros((3,))], ctx), TypeError,
         "dtype"),
        ("arity", lambda: k.launch([nd.zeros((3,))], ctx), ValueError,
         "expects 2"),
        ("not_an_ndarray", lambda: k.launch(
            [np.zeros(3, dtype="float32"), nd.zeros((3,))], ctx), TypeError,
         "must be an NDArray"),
        ("shared_mem", lambda: k.launch([nd.zeros((3,)), nd.zeros((3,))],
                                        ctx, shared_mem=16), ValueError,
         "shared_mem"),
    ]


@pytest.mark.parametrize("case", [c[0] for c in _errors(tmx)])
def test_pallas_module_raises_as_jax_package(case):
    for pkg in (jmx, tmx):
        _, thunk, exc, match = next(c for c in _errors(pkg) if c[0] == case)
        with pytest.raises(exc, match=match):
            thunk()


def test_pallas_module_names_torch_for_jax_source():
    src = "def k(x_ref, o_ref):\n    o_ref[...] = jnp.exp(x_ref[...])\n"
    k = trtc.PallasModule(src).get_kernel("k", "const float *x, float *o")
    with pytest.raises(NameError, match="torch"):
        k.launch([tmx.nd.zeros((2,)), tmx.nd.zeros((2,))], tmx.cpu())
    with pytest.raises(NameError, match="torch"):
        trtc.PallasModule("import math\nblock = pl.BlockSpec\n")


def test_pallas_kernel_refuses_a_gpu_context():
    k = trtc.PallasModule(COPY).get_kernel("k", "const float *x, float *o")
    with pytest.raises(tmx.MXNetError, match="CudaModule"):
        k.launch([tmx.nd.zeros((2,)), tmx.nd.zeros((2,))], tmx.gpu(0))


def test_pallas_kernel_leaves_inputs_and_old_views_alone():
    src = "def k(x_ref, o_ref):\n    x_ref[...] = 7.0\n    o_ref[...] = 1.0\n"
    k = trtc.PallasModule(src).get_kernel("k", "const float *x, float *o")
    x, o = tmx.nd.zeros((3,)), tmx.nd.zeros((3,))
    before, v0 = o[0:2], o._version
    k.launch([x, o], tmx.cpu())
    np.testing.assert_array_equal(x.asnumpy(), 0.0)
    np.testing.assert_array_equal(before.asnumpy(), 0.0)
    np.testing.assert_array_equal(o.asnumpy(), 1.0)
    assert o._version == v0 + 1


def test_cuda_module_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py holds CudaModule there")
    with pytest.raises(tmx.MXNetError, match="CUDA"):
        trtc.CudaModule('extern "C" __global__ void k(float *o) {}')
    # no NVRTC or driver library was loaded to find that out
    from mxnet_tpu_torch import _cuda_driver
    assert not _cuda_driver._libs


@pytest.mark.parametrize("bad", ["threads", "grid_y", "block_z", "smem",
                                 "arity", "cpu_context"])
def test_cuda_kernel_checks_launch_before_the_card(bad):
    k = trtc.CudaKernel(None, "k", trtc._parse_signature(
        "const float *x, float *o, const int n"))
    x, o = tmx.nd.zeros((4,)), tmx.nd.zeros((4,))
    args, ctx, grid, block, smem = [x, o, 4], tmx.gpu(0), (1, 1, 1), (32, 1, 1), 0
    if bad == "threads":
        block = (64, 32, 1)
    elif bad == "grid_y":
        grid = (1, 65536, 1)
    elif bad == "block_z":
        block = (1, 1, 65)
    elif bad == "smem":
        smem = 232449
    elif bad == "arity":
        args = args[:2]
    else:
        ctx = tmx.cpu()
    exc = tmx.MXNetError if bad == "cpu_context" else ValueError
    with pytest.raises(exc):
        k.launch(args, ctx, grid, block, smem)
    assert k.launches == 0


@pytest.mark.parametrize("ctype,value", [
    ("float", 0.1), ("double", 0.1), ("int", -7), ("int32_t", 2 ** 31 - 1),
    ("int64_t", 2 ** 40 + 3), ("long", -(2 ** 40)), ("uint8_t", 200),
    ("int8_t", -100), ("__half", 1.0 / 3.0), ("bfloat16", 1.0 / 3.0),
    ("__nv_bfloat16", -2.5)])
def test_scalars_marshal_as_their_declared_c_type(ctype, value):
    dtype = trtc._CTYPE_TO_TORCH[ctype]
    c = trtc._c_scalar(value, dtype)
    want = torch.tensor(value, dtype=dtype)
    assert ctypes.sizeof(c) == want.element_size()
    raw = bytes(c)
    assert raw == want.numpy().tobytes() if dtype != torch.bfloat16 else \
        raw == want.view(torch.int16).numpy().tobytes()
