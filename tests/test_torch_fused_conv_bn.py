"""Port parity: the fused 1x1-conv + BatchNorm-statistics op and block
against mxnet_tpu's, on CPU tensors.

On the CPU the kernel's wrapper runs its plain PyTorch version; the CUDA
kernel itself is held against that plain version on the card by
``chip_smoke.py``.  Inputs are seeded numpy arrays fed to both packages,
all fp32.  Tolerance: every compared tensor within 1e-5 of its largest
|value| (XLA, the Pallas kernel in interpret mode and PyTorch sum the
products, columns and batch statistics in other orders; nothing else
differs).
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu import autograd, nd
from mxnet_tpu.gluon.contrib import nn as jcnn
from mxnet_tpu.ops import fused_conv_bn as jf
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.gluon.contrib.nn import FusedConv1x1BN
from mxnet_tpu_torch.ops import fused_conv_bn as tf

REL = 1e-5
MODES = {"plain": (False, False), "affine": (True, False),
         "affine_relu": (True, True)}


def _close(got, ref, rel=REL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = float(np.abs(ref).max()) or 1.0
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, f"{what}: max err {err} > {rel} * {scale}"


def _inputs(seed, m=300, k=130, n=70):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, k).astype(np.float32),
            (rng.randn(k, n) * 0.1).astype(np.float32),
            (rng.rand(k) + 0.5).astype(np.float32),
            rng.randn(k).astype(np.float32))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_plain_version_matches_jax_oracle_and_pallas_interpret(mode):
    """(300, 130, 70): no dimension is a tile multiple, so the Pallas
    kernel pads and, with the affine on, masks its padded rows."""
    affine, relu = MODES[mode]
    x, w, sc, sh = _inputs(0)
    jargs = (jnp.asarray(x), jnp.asarray(w),
             jnp.asarray(sc) if affine else None,
             jnp.asarray(sh) if affine else None, relu)
    oracle = jf._reference_conv1x1(*jargs)
    pallas = jf.fused_matmul_bn_stats(*jargs, interpret=True)
    targs = (torch.from_numpy(x), torch.from_numpy(w),
             torch.from_numpy(sc) if affine else None,
             torch.from_numpy(sh) if affine else None, relu)
    plain = tf._reference_conv1x1(*targs)
    before = tf.fused_conv_bn_launches
    wrapped = tf.fused_matmul_bn_stats(*targs)
    assert tf.fused_conv_bn_launches == before  # CPU: no kernel launch
    for name, p, o, pl, wr in zip(("y", "sum", "sumsq"), plain, oracle,
                                  pallas, wrapped):
        _close(p, o, what=f"{mode} {name} vs jnp oracle")
        _close(p, pl, what=f"{mode} {name} vs Pallas interpret")
        assert torch.equal(wr, p), name
        assert p.dtype == torch.float32


def test_wrapper_refuses_a_device_without_kernel():
    """A device that is neither the CPU nor CUDA gets an error; a ``meta``
    tensor (shapes only, for symbol shape inference) gets the plain
    version's shapes."""
    x = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(MXNetError, match="no kernel"):
        tf.fused_matmul_bn_stats(x, x)
    y, s1, s2 = tf.fused_matmul_bn_stats(torch.empty(4, 3, device="meta"),
                                         torch.empty(3, 2, device="meta"))
    assert (y.device.type, y.shape, s1.shape, s2.shape) == (
        "meta", (4, 2), (2,), (2,))


@pytest.mark.parametrize("stride,with_stats,relu_in",
                         [(1, True, False), (2, True, True), (2, False, False),
                          (1, False, True)])
def test_op_matches_jax(stride, with_stats, relu_in):
    """NHWC op with the conv-layout weight: the strided subsample, the
    statistics, and the plain product with zero statistics."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 9, 7, 16).astype(np.float32)
    w = (rng.randn(24, 16, 1, 1) * 0.2).astype(np.float32)
    ref = jf._conv1x1_bn_stats_op(jnp.asarray(x), jnp.asarray(w),
                                  stride=stride, relu_in=relu_in,
                                  with_stats=with_stats)
    got = tf.conv1x1_bn_stats_op(torch.from_numpy(x), torch.from_numpy(w),
                                 stride=stride, relu_in=relu_in,
                                 with_stats=with_stats)
    assert tuple(got[0].shape) == ref[0].shape
    for name, g, r in zip(("y", "sum", "sumsq"), got, ref):
        if with_stats or name == "y":
            _close(g, r, what=name)
        else:
            assert not g.any() and not np.asarray(r).any(), name


@pytest.mark.parametrize("mode", sorted(MODES))
def test_core_gradients_match_jax_vjp(mode):
    """Backward of _Conv1x1BNCore against jax.vjp of _conv1x1_bn_core,
    with cotangents on y and on both statistics."""
    affine, relu = MODES[mode]
    x, w, sc, sh = _inputs(2, m=96, k=40, n=24)
    rng = np.random.RandomState(3)
    dy = rng.randn(96, 24).astype(np.float32)
    dsum = rng.randn(24).astype(np.float32)
    dsumsq = (rng.randn(24) * 0.1).astype(np.float32)

    if affine:
        def jfn(a, b, c, d):
            return jf._conv1x1_bn_core(a, b, c, d, relu)
        primals = tuple(jnp.asarray(v) for v in (x, w, sc, sh))
    else:
        def jfn(a, b):
            return jf._conv1x1_bn_core(a, b, None, None, relu)
        primals = (jnp.asarray(x), jnp.asarray(w))
    jout, vjp = jax.vjp(jfn, *primals)
    jgrads = vjp(tuple(jnp.asarray(v) for v in (dy, dsum, dsumsq)))

    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tsc = torch.from_numpy(sc).requires_grad_() if affine else None
    tsh = torch.from_numpy(sh).requires_grad_() if affine else None
    tout = tf._Conv1x1BNCore.apply(tx, tw, tsc, tsh, relu)
    leaves = [t for t in (tx, tw, tsc, tsh) if t is not None]
    tgrads = torch.autograd.grad(
        tout, leaves, [torch.from_numpy(v) for v in (dy, dsum, dsumsq)])
    for name, g, r in zip(("y", "sum", "sumsq"), tout, jout):
        _close(g, r, what=f"forward {name}")
    assert len(tgrads) == len(jgrads) == (4 if affine else 2)
    for name, g, r in zip(("dx", "dw", "dscale", "dshift"), tgrads, jgrads):
        _close(g, r, what=name)


def _block_pair(stride=2, relu=True):
    mx.random.seed(4)
    jblk = jcnn.FusedConv1x1BN(32, in_channels=16, strides=stride, relu=relu)
    jblk.collect_params().initialize()
    tblk = FusedConv1x1BN(32, in_channels=16, strides=stride, relu=relu,
                          device="cpu")
    with torch.no_grad():
        for p, (key, t) in zip(jblk.collect_params().values(),
                               tblk.state_dict().items()):
            assert p.name.endswith(key), (p.name, key)
            t.copy_(torch.tensor(p.data().asnumpy()))
    return jblk, tblk


@pytest.mark.parametrize("fast_variance", [1, 0])
def test_fused_block_matches_jax(fast_variance, monkeypatch):
    """Training forward, its gradients and the running statistics, then
    the evaluation forward with BN folded into the weight, under both
    variance settings."""
    monkeypatch.setenv("MXNET_TPU_FAST_VARIANCE", str(fast_variance))
    jblk, tblk = _block_pair()
    rng = np.random.RandomState(5)
    x = (rng.randn(2, 16, 8, 8) + 0.5).astype(np.float32)
    cot = rng.randn(2, 32, 4, 4).astype(np.float32)

    jx = nd.array(x)
    jx.attach_grad()
    with autograd.record():
        jout = jblk(jx)
        jloss = (jout * nd.array(cot)).sum()
    jloss.backward()
    tx = torch.from_numpy(x).requires_grad_()
    tblk.train()
    tout = tblk(tx)
    (tout * torch.from_numpy(cot)).sum().backward()

    _close(tout, jout.asnumpy(), what="train out")
    _close(tx.grad, jx.grad.asnumpy(), what="dx")
    for name in ("weight", "gamma", "beta"):
        _close(getattr(tblk, name).grad,
               getattr(jblk, name).grad().asnumpy(), what=f"d{name}")
    for name in ("running_mean", "running_var"):
        _close(getattr(tblk, name), getattr(jblk, name).data().asnumpy(),
               what=name)
    tblk.eval()
    with torch.no_grad():
        tinf = tblk(torch.from_numpy(x))
    _close(tinf, jblk(nd.array(x)).asnumpy(), what="eval out")


def test_fused_block_cast_keeps_norm_fp32():
    blk = FusedConv1x1BN(8, in_channels=4, device="cpu").cast("bfloat16")
    assert blk.weight.dtype == torch.bfloat16
    for name in ("gamma", "beta", "running_mean", "running_var"):
        assert getattr(blk, name).dtype == torch.float32, name


def test_fused_block_returns_fp32_from_bf16_like_jax():
    """The JAX block promotes a bf16 conv output to fp32 when it subtracts
    the fp32 mean; the port keeps that promotion (the reason the fused
    ResNet cannot train in bf16 in either package)."""
    jblk, tblk = _block_pair(stride=1, relu=False)
    jblk.cast("bfloat16")
    tblk.cast("bfloat16")
    x = np.random.RandomState(6).randn(2, 16, 4, 4).astype(np.float32)
    with autograd.record():
        jout = jblk(nd.array(x).astype("bfloat16"))
    tout = tblk.train()(torch.from_numpy(x).to(torch.bfloat16))
    assert str(jout.dtype) == "float32"
    assert tout.dtype == torch.float32


# The tensor-core kernel: variant choice, refusals, and its split arithmetic.

# (K, N) of every bottleneck 1x1 conv of resnet50_v1 (chip_smoke.py's
# FUSED_STAGES), with its M at batch 32.
RESNET_SHAPES = [(32 * 56 * 56, 64, 64), (32 * 56 * 56, 256, 64),
                 (32 * 56 * 56, 64, 256), (32 * 28 * 28, 256, 128),
                 (32 * 28 * 28, 512, 128), (32 * 28 * 28, 128, 512),
                 (32 * 28 * 28, 256, 512), (32 * 14 * 14, 512, 256),
                 (32 * 14 * 14, 1024, 256), (32 * 14 * 14, 256, 1024),
                 (32 * 14 * 14, 512, 1024), (32 * 7 * 7, 1024, 512),
                 (32 * 7 * 7, 2048, 512), (32 * 7 * 7, 512, 2048),
                 (32 * 7 * 7, 1024, 2048)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", RESNET_SHAPES + [(300, 130, 70)])
def test_fused_variant_resnet_shapes_and_ragged(shape, dtype):
    """Every resnet50_v1 shape takes the tensor-core kernel in fp32 and
    bf16; the ragged (300, 130, 70), whose rows TMA cannot describe,
    takes the CUDA-core kernel."""
    want = "simt" if shape == (300, 130, 70) else "wgmma"
    assert tf._fused_variant(dtype, *shape) == want


@pytest.mark.parametrize("dtype,k,want", [
    (torch.float32, 4, "wgmma"), (torch.float32, 36, "wgmma"),
    (torch.float32, 132, "wgmma"), (torch.float32, 1, "simt"),
    (torch.float32, 2, "simt"), (torch.float32, 6, "simt"),
    (torch.float32, 130, "simt"), (torch.bfloat16, 8, "wgmma"),
    (torch.bfloat16, 40, "wgmma"), (torch.bfloat16, 136, "wgmma"),
    (torch.bfloat16, 4, "simt"), (torch.bfloat16, 12, "simt"),
    (torch.bfloat16, 132, "simt"), (torch.float16, 64, "wgmma"),
    (torch.float16, 12, "simt")])
def test_fused_variant_k_edges(dtype, k, want):
    """TMA needs 16-byte row strides: K % 4 == 0 in fp32, K % 8 == 0 in
    bf16 and fp16 (fp16 took the CUDA cores before its tensor-core route
    came).  M and N do not matter."""
    for m, n in ((1, 1), (300, 70), (802816, 64)):
        assert tf._fused_variant(dtype, m, k, n) == want


def _no_library(monkeypatch):
    def load(name):
        raise AssertionError(f"the {name} library was touched")
    monkeypatch.setattr(tf._build, "load", load)


@pytest.mark.parametrize("bad", ["wgmma_fp32_k130", "wgmma_bf16_k12",
                                 "misaligned", "unknown"])
def test_wrapper_refuses_a_variant_the_inputs_do_not_fit(bad, monkeypatch):
    """Validated before anything is built or launched: a forced tensor-core
    launch on rows TMA cannot describe, a misaligned x on the tensor-core
    kernel the shapes pick, and a variant that does not exist."""
    _no_library(monkeypatch)
    m, k, n, dtype, variant = 16, 64, 8, torch.float32, "wgmma"
    x = torch.zeros(m, k)
    if bad == "wgmma_fp32_k130":
        k = 130
        x = torch.zeros(m, k)
    elif bad == "wgmma_bf16_k12":
        k, dtype = 12, torch.bfloat16
        x = torch.zeros(m, k, dtype=dtype)
    elif bad == "misaligned":
        x = torch.zeros(m * k + 1)[1:].view(m, k)
        variant = None
    else:
        variant = "tf32"
    w = torch.zeros(k, n, dtype=dtype)
    with pytest.raises(MXNetError):
        tf._fused_cuda(x, w, None, None, False, variant=variant)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_never_touch_the_library(dtype, monkeypatch):
    """A CPU call with shapes the tensor-core kernel takes runs the plain
    version: no library is built or loaded and no count moves."""
    _no_library(monkeypatch)
    monkeypatch.setattr(tf, "fused_conv_bn_launches", 0)
    monkeypatch.setattr(tf, "fused_conv_bn_wgmma_launches", 0)
    x, w, sc, sh = (torch.from_numpy(a) for a in _inputs(7, m=64, k=32,
                                                          n=16))
    x, w = x.to(dtype), w.to(dtype)
    got = tf.fused_matmul_bn_stats(x, w, sc, sh, True)
    ref = tf._reference_conv1x1(x, w, sc, sh, True)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert tf.fused_conv_bn_launches == tf.fused_conv_bn_wgmma_launches == 0


# chip_smoke.py's FUSED_TOL gates for fp32, against the plain version: y
# within 1e-4 of max |ref|; each column's sum within 1e-5 of its sum of
# |y|, its sum of squares within 1e-5 of itself.
Y_FP32_REL = 1e-4
STATS_REL = 1e-5
TILE_M = 128


def _tf32(a, rounding):
    """a as the tensor core reads a TF32 operand: the low 13 of fp32's 23
    mantissa bits dropped ("mask"), or rounded to nearest with ties away
    from zero first, as cvt.rna.tf32.f32 does ("rna")."""
    bits = a.contiguous().view(torch.int32)
    if rounding == "rna":
        bits = bits + 0x1000  # sign-magnitude: rounds |a| half away
    return (bits & -0x2000).view(torch.float32)


def _emulate_split_kernel(x, w, sc, sh, relu, products, rounding):
    """The tensor-core kernel's arithmetic on fp32 CPU tensors: the input
    affine as two roundings and the ReLU, then a = a_hi + a_lo and
    b = b_hi + b_lo with hi = tf32(v) and lo = tf32(v - hi); y sums
    a_lo b_hi + a_hi b_lo + a_hi b_hi (products=3) or a_hi b_hi alone
    (products=1), each exact in fp32 and accumulated in fp32; the
    statistics from fp32 per-128-row-tile partials."""
    a = x
    if sc is not None:
        a = a * sc + sh
    if relu:
        a = torch.relu(a)
    parts = []
    for v in (a, w):
        hi = _tf32(v, rounding)
        parts.append((hi, _tf32(v - hi, rounding)))
    (a_hi, a_lo), (b_hi, b_lo) = parts
    y = a_hi @ b_hi
    if products == 3:
        y = (a_lo @ b_hi + a_hi @ b_lo) + y
    tiles = y.view(-1, TILE_M, y.shape[1])
    return (y, tiles.sum(dim=1).sum(dim=0),
            (tiles * tiles).sum(dim=1).sum(dim=0))


def _gate_ratios(got, ref):
    """Each gate's error over its limit (1 at the limit)."""
    (y, s1, s2), (ry, r1, r2) = got, ref
    return {"y": ((y - ry).abs().max() / (Y_FP32_REL * ry.abs().max())
                  ).item(),
            "sum": ((s1 - r1).abs() / ry.abs().sum(0)).max().item()
            / STATS_REL,
            "sumsq": ((s2 - r2).abs() / r2).max().item() / STATS_REL}


@pytest.mark.parametrize("rounding", ["mask", "rna"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("k,n", [(64, 64), (256, 64), (1024, 256),
                                 (2048, 512)])
def test_three_tf32_products_keep_the_fp32_gates(k, n, mode, rounding):
    """x ~ N(0, 1), w ~ N(0, 1/K) and the affine as chip_smoke.py makes
    them, at a few resnet50_v1 (K, N) and M = 512: a_lo b_hi + a_hi b_lo +
    a_hi b_hi passes every fp32 gate against the plain version with room
    to spare; a_hi b_hi alone, a plain TF32 product, misses the y and the
    sum-of-squares gates."""
    affine, relu = MODES[mode]
    rng = np.random.RandomState(k + n + 7 * affine + relu)
    x = torch.from_numpy(rng.randn(512, k).astype(np.float32))
    w = torch.from_numpy((rng.randn(n, k) / np.sqrt(k)).astype(np.float32)
                         ).t().contiguous()
    sc = sh = None
    if affine:
        sc = torch.from_numpy((rng.rand(k) + 0.5).astype(np.float32))
        sh = torch.from_numpy((0.5 * rng.randn(k)).astype(np.float32))
    ref = tf._reference_conv1x1(x, w, sc, sh, relu)
    three = _gate_ratios(
        _emulate_split_kernel(x, w, sc, sh, relu, 3, rounding), ref)
    assert max(three.values()) <= 0.25, three
    one = _gate_ratios(
        _emulate_split_kernel(x, w, sc, sh, relu, 1, rounding), ref)
    assert one["y"] > 1.0 and one["sumsq"] > 1.0, one


def test_tf32_rounding_emulation():
    """mask drops the low 13 bits; rna rounds them half away from zero."""
    ulp = 2.0 ** -10  # TF32's spacing in [1, 2)
    a = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + ulp / 2 - 2 ** -20,
                      -(1.0 + ulp / 2), 1.0 + ulp * 0.75])
    assert _tf32(a, "mask").tolist() == [1.0, 1.0, 1.0, -1.0, 1.0]
    assert _tf32(a, "rna").tolist() == [1.0, 1.0 + ulp, 1.0,
                                        -(1.0 + ulp), 1.0 + ulp]
