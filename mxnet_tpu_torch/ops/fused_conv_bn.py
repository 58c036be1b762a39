"""Fused 1x1 convolution + BatchNorm statistics, with hand-written CUDA
kernels.

Counterpart of ``mxnet_tpu/ops/fused_conv_bn.py``.  The Pallas TPU kernel
``_mm_stats_kernel`` becomes two CUDA kernels, chosen by
:func:`_fused_variant` from the dtype and shapes alone:
``csrc/fused_conv_bn_wgmma.cu`` on the tensor cores (TMA, TF32 ``wgmma``
with a three-product hi/lo split that keeps fp32) wherever TMA can describe
x, and ``csrc/fused_conv_bn.cu`` on the CUDA cores for the rest.
:func:`_fused_cuda` is their wrapper and :func:`_reference_conv1x1` the
plain PyTorch version of both.  :func:`fused_matmul_bn_stats`, the op's
one entry, reaches the kernels through the kernel registry
(``ops/kernels.py``), where the CUDA route is registered for
``conv1x1_bn_stats`` at priority 10, as the JAX package registers its
Pallas kernel.  Where no kernel claims the call, a CPU tensor gets the
plain version and a CUDA tensor an error.

:class:`_Conv1x1BNCore` makes the product differentiable, with the JAX
package's backward (plain tensor ops there too), and
:func:`conv1x1_bn_stats_op` is the NHWC op the ``FusedConv1x1BN`` block
calls.
"""
from __future__ import annotations

import ctypes
import sys
from typing import Optional, Tuple

import torch

from .. import _graphs
from ..base import MXNetError, attr_truthy
from . import _build, kernels
from .registry import register

__all__ = ["fused_matmul_bn_stats", "conv1x1_bn_stats_op"]

# Kernel launches made by _fused_cuda, of either kernel, and of
# the tensor-core kernel alone (the counts show that a run went through the
# kernels; nothing else touches them), and of either kernel on fp16 input.
# The tensor-core kernel's w-split pre-kernel is part of its one launch.
fused_conv_bn_launches = 0
fused_conv_bn_wgmma_launches = 0
fused_conv_bn_fp16_launches = 0
# a CUDA graph's replay advances them by what its capture counted
_graphs.count_launches(sys.modules[__name__], "fused_conv_bn_launches",
                        "fused_conv_bn_wgmma_launches",
                        "fused_conv_bn_fp16_launches")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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
    K % 4 == 0, bf16 or fp16 with K % 8 == 0) and whose M rows fit TMA's
    32-bit coordinates; ``"simt"`` (CUDA cores) for everything else.  The
    choice depends on the dtype and shapes only; the wrapper also needs a
    16-byte aligned x for ``"wgmma"`` and raises without one."""
    per_row = {torch.float32: 4, torch.bfloat16: 8,
               torch.float16: 8}.get(dtype)
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


@kernels.register_kernel("conv1x1_bn_stats", platform="cuda", priority=10,
                         name="cuda_mm_bn_stats")
def _fused_cuda(x, w, in_scale, in_shift, relu_in: bool,
                variant: Optional[str] = None):
    """The CUDA route: validate, then launch the kernel
    :func:`_fused_variant` picks (``variant`` names one explicitly, for
    timing the two side by side)."""
    global fused_conv_bn_launches, fused_conv_bn_wgmma_launches, \
        fused_conv_bn_fp16_launches
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise MXNetError(f"fused_matmul_bn_stats takes x [M, K] and w [K, N], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise MXNetError(f"fused_matmul_bn_stats takes x and w both float32, "
                         f"both bfloat16 or both float16, got {x.dtype} and "
                         f"{w.dtype}")
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
                             f"takes float32 with K % 4 == 0 or bfloat16/"
                             f"float16 with K % 8 == 0, not {x.dtype} K={k}")
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
            # pre-pass; bf16 and fp16 w have no lo part
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
    if x.dtype == torch.float16:
        fused_conv_bn_fp16_launches += 1
    fused_conv_bn_launches += 1
    return y, psum.sum(dim=0), psumsq.sum(dim=0)


def fused_matmul_bn_stats(x, w, in_scale=None, in_shift=None,
                          relu_in: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``y = act(in_scale·x + in_shift) @ w`` plus per-column sum / sum-sq.

    x: ``[M, K]``; w: ``[K, N]``; in_scale/in_shift: fp32 ``[K]`` or None.
    Returns (y ``[M, N]`` in x's dtype, sum ``[N]`` fp32, sumsq ``[N]``
    fp32), the statistics of the fp32 product.  The kernel the registry
    picks for the ``conv1x1_bn_stats`` call runs it (on CUDA tensors,
    :func:`_fused_cuda` unless a user kernel claims the call: x contiguous,
    fp32, bf16 or fp16, or an error; a ``w`` that is not the transpose of a
    contiguous ``[N, K]`` is copied to that layout); with no kernel, CPU
    tensors run :func:`_reference_conv1x1`, and so do ``meta`` tensors,
    which carry shapes only (``Symbol.infer_shape``)."""
    plat = kernels.current_platform(x)
    if plat not in ("cpu", "meta", "cuda"):
        raise MXNetError(f"fused_matmul_bn_stats: no kernel for device "
                         f"{x.device}")
    impl = kernels.lookup_kernel(
        "conv1x1_bn_stats", platform=plat, m=x.shape[0], k=x.shape[1],
        n=w.shape[1], dtype=str(x.dtype).replace("torch.", ""))
    if impl is not None:
        return impl(x, w, in_scale, in_shift, relu_in)
    if plat == "cuda":
        raise MXNetError(f"fused_matmul_bn_stats: no kernel for device "
                         f"{x.device}: no registered kernel takes the call")
    return _reference_conv1x1(x, w, in_scale, in_shift, relu_in)


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
    matrix product with zero statistics.  Under an entered mesh with a
    ``dp`` axis that divides the batch, each ``dp`` position runs the
    kernel on its share of the rows and the statistics are summed over
    ``dp`` with :func:`~mxnet_tpu_torch.parallel.psum` (the reduction the
    JAX package's partitioner inserts).  Registered as the JAX package's
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
    def stats(x4, w):
        # the kernel takes a contiguous [M, K]: the NCHW -> NHWC transpose
        # and the strided subsample are copied here, once
        y, s1, s2 = _Conv1x1BNCore.apply(
            x4.reshape(-1, c).contiguous(), w, None, None, bool(relu_in))
        return y.reshape(x4.shape[:3] + (w.shape[1],)), s1, s2

    from ..parallel.mesh import current_mesh
    mesh = current_mesh()
    dp = mesh.axis_size("dp") if mesh is not None else 1
    if dp < 2 or n % dp:
        return stats(x, w2d)
    from ..parallel import collectives as C
    from ..parallel.mesh import PartitionSpec as P

    def body(xs, ws):
        ys, s1s, s2s = zip(*(stats(a, b) for a, b in zip(xs, ws)))
        return list(ys), C.psum(s1s, "dp"), C.psum(s2s, "dp")
    return C.shard_map(body, mesh, (P("dp"), P()), (P("dp"), P(), P()))(
        x, w2d)
