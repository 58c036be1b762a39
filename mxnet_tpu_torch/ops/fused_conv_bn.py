"""Fused 1x1 convolution + BatchNorm statistics, with hand-written CUDA
kernels.

Counterpart of ``mxnet_tpu/ops/fused_conv_bn.py``.  The Pallas TPU kernel
``_mm_stats_kernel`` becomes two CUDA kernels, chosen by
:func:`_fused_variant` from the dtype and shapes alone:
``csrc/fused_conv_bn_wgmma.cu`` on the tensor cores (TMA, TF32 ``wgmma``
with a three-product hi/lo split that keeps fp32) wherever TMA can describe
x, and ``csrc/fused_conv_bn.cu`` on the CUDA cores for the rest.
:func:`fused_matmul_bn_stats` is their wrapper and
:func:`_reference_conv1x1` the plain PyTorch version of both.  The wrapper
chooses by the tensor's device alone: a CPU tensor gets the plain version,
a CUDA tensor gets a kernel or an error.

:class:`_Conv1x1BNCore` makes the product differentiable, with the JAX
package's backward (plain tensor ops there too), and
:func:`conv1x1_bn_stats_op` is the NHWC op the ``FusedConv1x1BN`` block
calls.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..base import MXNetError, attr_truthy
from . import _build
from .registry import register

__all__ = ["fused_matmul_bn_stats", "conv1x1_bn_stats_op"]

# Kernel launches made by fused_matmul_bn_stats, of either kernel, and of
# the tensor-core kernel alone (the counts show that a run went through the
# kernels; nothing else touches them).  The tensor-core kernel's w-split
# pre-kernel is part of its one launch.
fused_conv_bn_launches = 0
fused_conv_bn_wgmma_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _reference_conv1x1(x, w, in_scale, in_shift, relu_in: bool):
    """Plain PyTorch version: ``y = act(in_scale·x + in_shift) @ w`` in fp32,
    stored in x's dtype, with the per-column sum and sum of squares of the
    fp32 product.  ``w`` is ``[K, N]``."""
    xf = x.float()
    if in_scale is not None:
        xf = xf * in_scale.float() + in_shift.float()
    if relu_in:
        xf = torch.relu(xf)
    y32 = xf @ w.float()
    return y32.to(x.dtype), y32.sum(dim=0), (y32 * y32).sum(dim=0)


_libs = {}


def _fused_variant(dtype, m: int, k: int, n: int) -> str:
    """The kernel a CUDA call takes: ``"wgmma"`` (tensor cores, TMA) where
    TMA can describe x, whose rows need 16-byte strides (fp32 with
    K % 4 == 0, bf16 with K % 8 == 0) and whose M rows fit TMA's 32-bit
    coordinates; ``"simt"`` (CUDA cores) for everything else.  The choice
    depends on the dtype and shapes only; the wrapper also needs a 16-byte
    aligned x for ``"wgmma"`` and raises without one."""
    per_row = {torch.float32: 4, torch.bfloat16: 8}.get(dtype)
    return "wgmma" if per_row and k % per_row == 0 and m < 2 ** 31 else "simt"


def _kernel_lib(variant: str):
    """The built library of a kernel variant, its C signatures declared on
    first use: ``csrc/fused_conv_bn.cu`` (``"simt"``) or
    ``csrc/fused_conv_bn_wgmma.cu`` (``"wgmma"``).  Returns (launch
    function, error-string function, tile height of the partials)."""
    entry = _libs.get(variant)
    if entry is None:
        if variant == "wgmma":
            lib = _build.load("fused_conv_bn_wgmma")
            fn = lib.fused_conv_bn_wgmma
            err = lib.fused_conv_bn_wgmma_error_string
            tile_m = lib.fused_conv_bn_wgmma_tile_m
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] + [
                ctypes.c_int] * 4 + [ctypes.c_void_p]
        else:
            lib = _build.load("fused_conv_bn")
            fn, err = lib.fused_conv_bn_stats, lib.fused_conv_bn_error_string
            tile_m = lib.fused_conv_bn_tile_m
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [
                ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        tile_m.restype = ctypes.c_int
        entry = _libs[variant] = (fn, err, tile_m())
    return entry


def _fused_cuda(x, w, in_scale, in_shift, relu_in: bool,
                variant: Optional[str] = None):
    """Validate, then launch the kernel :func:`_fused_variant` picks
    (``variant`` names one explicitly, for timing the two side by side)."""
    global fused_conv_bn_launches, fused_conv_bn_wgmma_launches
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise MXNetError(f"fused_matmul_bn_stats takes x [M, K] and w [K, N], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise MXNetError(f"fused_matmul_bn_stats takes x and w both float32 "
                         f"or both bfloat16, got {x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise MXNetError(f"fused_matmul_bn_stats: w is on {w.device}, x on "
                         f"{x.device}")
    if not x.is_contiguous():
        raise MXNetError("fused_matmul_bn_stats: x must be contiguous")
    if (in_scale is None) != (in_shift is None):
        raise MXNetError("fused_matmul_bn_stats: in_scale and in_shift go "
                         "together")
    for name, t in (("in_scale", in_scale), ("in_shift", in_shift)):
        if t is not None and (t.shape != (k,) or t.dtype != torch.float32
                              or t.device != x.device
                              or not t.is_contiguous()):
            raise MXNetError(f"fused_matmul_bn_stats: {name} must be a "
                             f"contiguous float32 [{k}] on {x.device}")
    if min(m, k, n) < 1:
        raise MXNetError(f"fused_matmul_bn_stats: empty product M={m}, K={k},"
                         f" N={n}")
    if variant is None:
        variant = _fused_variant(x.dtype, m, k, n)
    if variant == "wgmma":
        if _fused_variant(x.dtype, m, k, n) != "wgmma":
            raise MXNetError(f"fused_matmul_bn_stats: the tensor-core kernel "
                             f"takes float32 with K % 4 == 0 or bfloat16 with "
                             f"K % 8 == 0, not {x.dtype} K={k}")
        if x.data_ptr() % 16:
            raise MXNetError("fused_matmul_bn_stats: x must be 16-byte "
                             "aligned for the tensor-core kernel")
    elif variant != "simt":
        raise MXNetError(f"fused_matmul_bn_stats: no kernel variant "
                         f"{variant!r}")
    fn, err_string, tile_m = _kernel_lib(variant)
    # the kernels read w as a row-major [N, K]: the conv weight's own
    # layout passes as it is, any other w is copied once (at most 8 MB on
    # ResNet-50)
    w_nk = w.t().contiguous()
    tiles = -(-m // tile_m)
    with torch.cuda.device(x.device):
        y = torch.empty((m, n), dtype=x.dtype, device=x.device)
        psum = torch.empty((tiles, n), dtype=torch.float32, device=x.device)
        psumsq = torch.empty_like(psum)
        args = [x.data_ptr(), w_nk.data_ptr()]
        if variant == "wgmma":
            # fp32 w_hi and w_lo [N, K], split from w by the kernel's
            # pre-pass; bf16 w has no lo part
            w_hi = torch.empty((n, k), dtype=torch.float32, device=x.device)
            w_lo = (torch.empty_like(w_hi) if x.dtype == torch.float32
                    else None)
            args += [w_hi.data_ptr(),
                     None if w_lo is None else w_lo.data_ptr()]
        args += [None if in_scale is None else in_scale.data_ptr(),
                 None if in_shift is None else in_shift.data_ptr(),
                 y.data_ptr(), psum.data_ptr(), psumsq.data_ptr(), m, k, n,
                 int(bool(relu_in)), _DTYPE_CODES[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream]
        err = fn(*args)
    if err:
        raise MXNetError(f"fused_conv_bn_stats ({variant}) launch failed: "
                         + err_string(err).decode())
    if variant == "wgmma":
        fused_conv_bn_wgmma_launches += 1
    fused_conv_bn_launches += 1
    return y, psum.sum(dim=0), psumsq.sum(dim=0)


def fused_matmul_bn_stats(x, w, in_scale=None, in_shift=None,
                          relu_in: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``y = act(in_scale·x + in_shift) @ w`` plus per-column sum / sum-sq.

    x: ``[M, K]``; w: ``[K, N]``; in_scale/in_shift: fp32 ``[K]`` or None.
    Returns (y ``[M, N]`` in x's dtype, sum ``[N]`` fp32, sumsq ``[N]``
    fp32), the statistics of the fp32 product.  CUDA tensors launch the
    kernel :func:`_fused_variant` picks (x contiguous, fp32 or bf16, or an
    error; a ``w`` that is not the transpose of a contiguous ``[N, K]`` is
    copied to that layout); CPU tensors run :func:`_reference_conv1x1`, and
    so do ``meta`` tensors, which carry shapes only
    (``Symbol.infer_shape``)."""
    if x.device.type in ("cpu", "meta"):
        return _reference_conv1x1(x, w, in_scale, in_shift, relu_in)
    if x.device.type != "cuda":
        raise MXNetError(f"fused_matmul_bn_stats: no kernel for device "
                         f"{x.device}")
    return _fused_cuda(x, w, in_scale, in_shift, relu_in)


class _Conv1x1BNCore(torch.autograd.Function):
    """Differentiable :func:`fused_matmul_bn_stats`.  The backward is the
    JAX package's ``_core_bwd``: the statistics' cotangents fold into
    ``dy`` through the stored (rounded) ``y``, the input gradient is gated
    by the input ReLU, and in affine mode ``dscale``/``dshift`` come back
    too."""

    @staticmethod
    def forward(ctx, x2d, w2d, in_scale: Optional[torch.Tensor],
                in_shift: Optional[torch.Tensor], relu_in: bool):
        y, s1, s2 = fused_matmul_bn_stats(x2d, w2d, in_scale, in_shift,
                                          relu_in)
        ctx.relu_in = relu_in
        ctx.save_for_backward(x2d, w2d, in_scale, in_shift, y)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, dsum, dsumsq):
        x2d, w2d, in_scale, in_shift, y = ctx.saved_tensors
        y32 = y.float()
        # d(sum)/dy = 1, d(sumsq)/dy = 2y (autograd hands zeros for an
        # unused output)
        dy32 = (dy.float() + dsum.reshape(1, -1)
                + 2.0 * y32 * dsumsq.reshape(1, -1))
        xf = x2d.float()
        if in_scale is not None:
            xa = xf * in_scale.float() + in_shift.float()
        else:
            xa = xf
        if ctx.relu_in:
            act = torch.relu(xa)
            gate = (xa > 0).float()
        else:
            act, gate = xa, None
        dw = act.t() @ dy32
        dact = dy32 @ w2d.float().t()
        if gate is not None:
            dact = dact * gate
        if in_scale is not None:
            dx = (dact * in_scale.float()).to(x2d.dtype)
            dscale = (dact * xf).sum(dim=0).to(in_scale.dtype)
            dshift = dact.sum(dim=0).to(in_shift.dtype)
        else:
            dx = dact.to(x2d.dtype)
            dscale = dshift = None
        return dx, dw.to(w2d.dtype), dscale, dshift, None


@register("_contrib_conv1x1_bn_stats", nin=2, nout=3)
def conv1x1_bn_stats_op(x, w, stride: int = 1, relu_in: bool = False,
                        with_stats: bool = True):
    """NHWC 1x1 convolution with the output's per-channel statistics.

    x: ``[N, H, W, C]``; w: ``[Cout, Cin, 1, 1]`` (the conv layout) or
    ``[Cin, Cout]``.  Returns (y ``[N, H', W', Cout]``, sum ``[Cout]``,
    sumsq ``[Cout]``), H' and W' after the stride's subsampling.
    ``with_stats=False`` (inference, BN folded into ``w``) is a plain
    matrix product with zero statistics.  Registered as the JAX package's
    ``_contrib_conv1x1_bn_stats`` op; flags may arrive as the strings of a
    loaded symbol JSON."""
    relu_in, with_stats = attr_truthy(relu_in), attr_truthy(with_stats)
    w2d = w.reshape(w.shape[0], w.shape[1]).t() if w.dim() == 4 else w
    s = int(stride)
    if s > 1:
        x = x[:, ::s, ::s, :]
    n, h, ww, c = x.shape
    if not with_stats:
        xf = x.reshape(-1, c).float()
        if relu_in:
            xf = torch.relu(xf)
        y = (xf @ w2d.float()).to(x.dtype).reshape(n, h, ww, w2d.shape[1])
        z = torch.zeros(w2d.shape[1], dtype=torch.float32, device=x.device)
        return y, z, z
    # the kernel takes a contiguous [M, K]: the NCHW -> NHWC transpose and
    # the strided subsample are copied here, once
    y, s1, s2 = _Conv1x1BNCore.apply(x.reshape(-1, c).contiguous(), w2d,
                                     None, None, bool(relu_in))
    return y.reshape(n, h, ww, w2d.shape[1]), s1, s2
