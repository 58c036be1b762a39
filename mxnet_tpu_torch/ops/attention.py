"""Attention operators: flash-attention forward with hand-written CUDA
kernels, and rotary position embedding.

Counterpart of ``mxnet_tpu/ops/attention.py``.  The Pallas TPU kernel
``_flash_fwd_kernel`` becomes three CUDA kernels, chosen by
:func:`_flash_variant` from the dtype and head dim alone:
``csrc/flash_fwd_tf32.cu`` on the tensor cores for fp32 with D a multiple
of 4 (three TF32 products per product keep fp32 accuracy),
``csrc/flash_fwd_wgmma.cu`` on the tensor cores for bf16 with D a multiple
of 8, and ``csrc/flash_fwd.cu`` on the CUDA cores for any other D.
:func:`flash_fwd` is their wrapper, and :func:`_flash_forward_plain` is the
plain PyTorch version of all three.  The wrapper chooses by the tensor's
device alone: a CPU tensor gets the plain version, a CUDA tensor gets a
kernel or an error.  Unlike the JAX dispatch gate, which falls back to a
dense lowering unless S divides into 128-row blocks, every kernel takes any
S, so every CUDA call launches one.

Layouts follow the JAX package: ``[B, H, S, D]``, or packed ``[B, S, H*D]``
with ``num_heads``.  :class:`_FlashFunction` puts the forward under torch
autograd on either device, with the JAX package's blockwise backward
(``_flash_bwd``, a jnp ``lax.scan`` there, torch ops here); with a
``key_valid_len`` the attention takes the dense masked path, which autograd
follows directly.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..base import MXNetError, attr_truthy
from . import _build
from .registry import register

__all__ = ["attention_reference", "flash_attention", "flash_fwd", "rope"]

# Kernel launches made by flash_fwd, of any kernel, and of each
# tensor-core kernel alone (the counts show that a run went through the
# kernels; nothing else touches them).
flash_fwd_launches = 0
flash_fwd_wgmma_launches = 0
flash_fwd_tf32_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MASK = -1e30


def attention_reference(q, k, v, causal=False, sm_scale=None):
    """Dense softmax(q k^T) v with fp32 scores; ``[B, H, S, D]`` layout."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q, k.transpose(-1, -2)).float() * sm_scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(q.dtype), v)


def _flash_forward_plain(q, k, v, causal: bool, sm_scale: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the flash forward: ``(O, lse)`` for
    ``[..., S, D]`` inputs, lse fp32 ``[..., S_q]``.  Scores are the
    product in the input dtype cast to fp32, masked with -1e30, as in the
    JAX package's XLA lowering."""
    s = torch.matmul(q, k.transpose(-1, -2)).float() * sm_scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, _MASK)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul((p / l).to(q.dtype), v)
    return out, (m + torch.log(l)).squeeze(-1)


_libs = {}


def _flash_variant(dtype, d: int) -> str:
    """The kernel a CUDA call takes.  On the tensor cores, where TMA's
    16-byte row strides describe the rows: ``"tf32"`` for fp32 with D a
    multiple of 4 (each product split into three TF32 products, which keep
    the reference's fp32 accuracy where one TF32 product would not) and
    ``"wgmma"`` for bf16 with D a multiple of 8.  ``"simt"`` (CUDA cores)
    for any other D, in either dtype."""
    if dtype == torch.float32 and d % 4 == 0:
        return "tf32"
    if dtype == torch.bfloat16 and d % 8 == 0:
        return "wgmma"
    return "simt"


# The library and C function of each kernel variant.
_VARIANT_SOURCES = {"simt": "flash_fwd", "wgmma": "flash_fwd_wgmma",
                    "tf32": "flash_fwd_tf32"}


def _kernel_lib(variant: str):
    """The built library of a kernel variant, its C signatures declared on
    first use: ``csrc/flash_fwd.cu`` (``"simt"``, which also takes a dtype
    code), ``csrc/flash_fwd_wgmma.cu`` (``"wgmma"``) or
    ``csrc/flash_fwd_tf32.cu`` (``"tf32"``)."""
    entry = _libs.get(variant)
    if entry is None:
        name = _VARIANT_SOURCES[variant]
        lib = _build.load(name)
        fn, err = getattr(lib, name), getattr(lib, f"{name}_error_string")
        dtype_code = [ctypes.c_int] if variant == "simt" else []
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_float] + dtype_code + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        entry = _libs[variant] = (fn, err)
    return entry


def _flash_fwd_cuda(q, k, v, causal: bool, sm_scale: float,
                    variant: Optional[str] = None):
    """Validate, then launch the kernel :func:`_flash_variant` picks
    (``variant`` names one explicitly, for timing them side by side; a
    tensor-core variant the inputs do not fit is refused, never
    replaced)."""
    global flash_fwd_launches, flash_fwd_wgmma_launches
    global flash_fwd_tf32_launches
    if q.dim() != 3:
        raise MXNetError(f"flash_fwd takes [BH, S, D] tensors, q is "
                         f"{tuple(q.shape)}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if k.shape != (bh, sk, d) or v.shape != k.shape:
        raise MXNetError(f"flash_fwd: q {tuple(q.shape)}, k {tuple(k.shape)}"
                         f", v {tuple(v.shape)} do not form [BH, S, D]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise MXNetError(f"flash_fwd: {name} is {t.dtype} on {t.device}, "
                             f"q is {q.dtype} on {q.device}")
        if not t.is_contiguous():
            raise MXNetError(f"flash_fwd: {name} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise MXNetError(f"flash_fwd takes float32 or bfloat16, not {q.dtype}")
    if not 0 < d <= 128:
        raise MXNetError(f"flash_fwd takes head dims 1..128, not {d}")
    if not (0 < bh <= 65535 and sq > 0 and sk > 0):
        raise MXNetError(f"flash_fwd: unsupported sizes BH={bh}, S_q={sq}, "
                         f"S_k={sk}")
    if variant is None:
        variant = _flash_variant(q.dtype, d)
    if variant in ("wgmma", "tf32"):
        if _flash_variant(q.dtype, d) != variant:
            raise MXNetError(f"flash_fwd: the {variant} tensor-core kernel "
                             f"does not take {q.dtype} with D={d}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise MXNetError(f"flash_fwd: {name} must be 16-byte aligned"
                                 f" for the {variant} tensor-core kernel")
    elif variant != "simt":
        raise MXNetError(f"flash_fwd: no kernel variant {variant!r}")
    fn, err_string = _kernel_lib(variant)
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), bh, sq, sk, d, int(causal), float(sm_scale)]
        if variant == "simt":
            args.append(_DTYPE_CODES[q.dtype])
        err = fn(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise MXNetError(f"flash_fwd ({variant}) launch failed: "
                         + err_string(err).decode())
    if variant == "wgmma":
        flash_fwd_wgmma_launches += 1
    elif variant == "tf32":
        flash_fwd_tf32_launches += 1
    flash_fwd_launches += 1
    return out, lse


def flash_fwd(q, k, v, causal: bool, sm_scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward on ``[BH, S, D]`` tensors: ``(O, lse)``, O
    in the input dtype, lse fp32 ``[BH, S_q]``.  CUDA tensors launch the
    kernel :func:`_flash_variant` picks (contiguous fp32/bf16, D <= 128, or
    an error); CPU tensors run :func:`_flash_forward_plain`, and so do
    ``meta`` tensors, which carry shapes only (``Symbol.infer_shape``)."""
    if q.device.type in ("cpu", "meta"):
        return _flash_forward_plain(q, k, v, causal, sm_scale)
    if q.device.type != "cuda":
        raise MXNetError(f"flash_fwd: no kernel for device {q.device}")
    return _flash_fwd_cuda(q, k, v, causal, sm_scale)


_BWD_BLOCK_K = 128


class _FlashFunction(torch.autograd.Function):
    """``(out, lse)`` of :func:`flash_fwd` on ``[B, H, S, D]`` inputs, with
    the gradient of ``out`` computed blockwise from the saved lse (lse
    itself takes none)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        b, h, sq, d = q.shape
        sk = k.shape[2]
        out, lse = flash_fwd(q.reshape(b * h, sq, d).contiguous(),
                             k.reshape(b * h, sk, d).contiguous(),
                             v.reshape(b * h, sk, d).contiguous(),
                             causal, sm_scale)
        out, lse = out.view(b, h, sq, d), lse.view(b, h, sq)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, out, lse, dout, ctx.causal,
                                     ctx.sm_scale)
        return dq, dk, dv, None, None


def _flash_backward(q, k, v, out, lse, dout, causal: bool, sm_scale: float):
    """The JAX package's ``_flash_bwd`` in fp32: ``delta = Σ dO·O``, then
    per block of 128 keys P is recomputed from the lse (masked scores at
    -1e30 give exactly 0), dq accumulates and the block's dk, dv are
    written; the full score matrix never exists.  A ragged last block is
    sliced short where the JAX package pads and masks it."""
    qf, do = q.float(), dout.float()
    delta = (do * out.float()).sum(-1, keepdim=True)
    lse = lse.unsqueeze(-1)
    sk = k.shape[2]
    bk = min(_BWD_BLOCK_K, sk)
    dq = torch.zeros_like(qf)
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    rows = torch.arange(q.shape[2], device=q.device)[:, None]
    for k0 in range(0, sk, bk):
        kj = k[:, :, k0:k0 + bk].float()
        vj = v[:, :, k0:k0 + bk].float()
        s = torch.matmul(qf, kj.transpose(-1, -2)) * sm_scale
        if causal:
            cols = torch.arange(k0, k0 + kj.shape[2], device=q.device)
            s = s.masked_fill(rows < cols, _MASK)
        p = torch.exp(s - lse)
        dv[:, :, k0:k0 + bk] = torch.matmul(p.transpose(-1, -2), do)
        dp = torch.matmul(do, vj.transpose(-1, -2))
        ds = p * (dp - delta) * sm_scale
        dq += torch.matmul(ds, kj)
        dk[:, :, k0:k0 + bk] = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _forward_with_lse(q, k, v, causal: bool, sm_scale: float):
    """``[B, H, S, D]`` -> (out ``[B, H, S_q, D]``, lse ``[B, H, S_q]``),
    differentiable in q, k and v."""
    return _FlashFunction.apply(q, k, v, causal, sm_scale)


def _masked_dense_attention(q, k, v, key_valid_len, causal: bool,
                            sm_scale: float):
    """Dense attention with per-example key padding (BERT's
    ``valid_length``): key ``j`` of example ``b`` counts when
    ``j < key_valid_len[b]``; masked scores are -1e30 in fp32.  Torch
    autograd differentiates it; the ``[S_q, S_k]`` scores materialise."""
    s = torch.matmul(q, k.transpose(-1, -2)).float() * sm_scale
    cols = torch.arange(s.shape[-1], device=s.device)
    valid = cols < key_valid_len.to(torch.int32).reshape(-1, 1, 1, 1)
    if causal:
        rows = torch.arange(s.shape[-2], device=s.device)[:, None]
        valid = valid & (rows >= cols)
    s = torch.where(valid, s, s.new_full((), _MASK))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(q.dtype), v)


def rope(x, cos, sin, num_heads: Optional[int] = None):
    """Rotary position embedding: ``x`` is ``[B, S, H*D]`` (with
    ``num_heads``) or ``[B, H, S, D]``; cos/sin are ``[S, D/2]`` tables.
    Rotates each head's feature halves (x1, x2) by the position angle."""
    if x.dim() == 3:
        if not num_heads:
            raise MXNetError("num_heads required for packed [B, S, H*D] input")
        b, s, hd = x.shape
        xr = x.reshape(b, s, num_heads, hd // num_heads)
        c, sn = cos[None, :, None, :], sin[None, :, None, :]
    else:
        xr = x
        c, sn = cos[None, None], sin[None, None]
    d = xr.shape[-1]
    x1, x2 = xr[..., : d // 2], xr[..., d // 2:]
    out = torch.cat([x1 * c - x2 * sn, x2 * c + x1 * sn], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


@register("flash_attention", nin=3)
def flash_attention(q, k, v, key_valid_len=None,
                    num_heads: Optional[int] = None, causal: bool = False,
                    sm_scale: Optional[float] = None):
    """Fused multi-head scaled-dot-product attention over ``[B, H, S, D]``
    inputs, or ``[B, S, H*D]`` with ``num_heads`` (returning that layout).
    ``key_valid_len`` (``[B]``, a fourth array input of the registry op)
    masks each example's padding keys on the dense path; without it the
    flash forward runs."""
    packed = q.dim() == 3
    causal = attr_truthy(causal)
    if packed:
        if not num_heads:
            raise MXNetError("num_heads required for [B, S, H*D] inputs")
        num_heads = int(num_heads)
        b, _, hd = q.shape
        d = hd // num_heads
        q, k, v = (t.reshape(b, t.shape[1], num_heads, d).transpose(1, 2)
                   for t in (q, k, v))
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if key_valid_len is not None:
        out = _masked_dense_attention(q, k, v, key_valid_len, bool(causal),
                                      float(sm_scale))
    else:
        out, _ = _forward_with_lse(q, k, v, bool(causal), float(sm_scale))
    if packed:
        b, h, s, d = out.shape
        out = out.transpose(1, 2).reshape(b, s, h * d)
    return out
