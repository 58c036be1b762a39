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
    x = torch.empty(4, 3, device="meta")
    w = torch.empty(3, 2, device="meta")
    with pytest.raises(MXNetError, match="no kernel"):
        tf.fused_matmul_bn_stats(x, w)


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
