"""Deformable convolutions (counterparts of
``_contrib_DeformableConvolution`` and
``_contrib_ModulatedDeformableConvolution`` in
``mxnet_tpu/ops/contrib_ops.py``, reference
``src/operator/contrib/deformable_convolution.cc`` and
``modulated_deformable_convolution.cc``).

As in the JAX op: each output location's sampling grid is bent by its
learned ``(dy, dx)`` offsets, every sample is a bilinear gather of the
input (zero outside it), v2 multiplies each sample by its modulation
mask, and one product with the weight per group makes the output
(``deformable_im2col`` followed by a GEMM).  The gather runs in fp32 and
the output is cast back to the input's dtype.  The gradients, the
offsets' and the mask's included, are torch autograd's through the
gather, as the JAX package takes them from jax's AD.  Plain torch ops:
the JAX op is jnp, no Pallas kernel.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["deformable_convolution"]


def _bilinear_at(img, y, x):
    """``img`` [N, C, H, W]; ``y``, ``x`` [N, *S] coordinates -> [N, C, *S].
    A corner outside the image contributes zero."""
    n, c, h, w = img.shape
    flat = img.reshape(n, c, h * w)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy = (y - y0)[:, None]
    wx = (x - x0)[:, None]
    out = 0.0
    for dy, fy in ((0, 1 - wy), (1, wy)):
        for dx, fx in ((0, 1 - wx), (1, wx)):
            yy = y0 + dy
            xx = x0 + dx
            inside = ((yy >= 0) & (yy <= h - 1) & (xx >= 0)
                      & (xx <= w - 1))[:, None]
            idx = (yy.clamp(0, h - 1).long() * w
                   + xx.clamp(0, w - 1).long()).reshape(n, 1, -1)
            val = torch.gather(flat, 2, idx.expand(n, c, idx.shape[2]))
            val = val.reshape((n, c) + tuple(y.shape[1:]))
            out = out + torch.where(inside, val, 0.0) * fy * fx
    return out


def deformable_convolution(data, offset, weight, bias=None, mask=None,
                           kernel=(3, 3), stride=(1, 1), dilate=(1, 1),
                           pad=(0, 0), num_filter=0, num_group=1,
                           num_deformable_group=1):
    """``data`` [N, C, H, W], ``offset`` [N, 2·dg·kh·kw, oh, ow] (``(dy,
    dx)`` pairs per kernel point), ``weight`` [F, C/g, kh, kw], ``mask``
    [N, dg·kh·kw, oh, ow] or None -> [N, F, oh, ow]."""
    kh, kw = kernel
    sh, sw = stride
    dh, dw = dilate
    ph, pw = pad
    n, c, h, w = data.shape
    oh = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    dg = int(num_deformable_group)
    cg = c // dg
    dev = data.device
    gy = torch.arange(oh, dtype=torch.float32, device=dev) * sh - ph
    gx = torch.arange(ow, dtype=torch.float32, device=dev) * sw - pw
    ky = torch.arange(kh, dtype=torch.float32, device=dev) * dh
    kx = torch.arange(kw, dtype=torch.float32, device=dev) * dw
    img = data.float()
    off = offset.float().reshape(n, dg, kh * kw, 2, oh, ow)
    msk = None if mask is None else mask.float().reshape(n, dg, kh, kw,
                                                         oh, ow)
    cols = []
    for g in range(dg):
        oy = off[:, g, :, 0].reshape(n, kh, kw, oh, ow)
        ox = off[:, g, :, 1].reshape(n, kh, kw, oh, ow)
        ys = ky[:, None, None, None] + gy[None, None, :, None] + oy
        xs = kx[None, :, None, None] + gx[None, None, None, :] + ox
        sampled = _bilinear_at(img[:, g * cg:(g + 1) * cg], ys, xs)
        if msk is not None:
            sampled = sampled * msk[:, g][:, None]
        cols.append(sampled)                     # [N, cg, kh, kw, oh, ow]
    col = torch.cat(cols, dim=1).reshape(n, c * kh * kw, oh * ow)
    wmat = weight.reshape(int(num_filter), -1).float()
    groups = int(num_group)
    if groups > 1:
        fo = int(num_filter) // groups
        ck = (c // groups) * kh * kw
        out = torch.cat([torch.matmul(wmat[i * fo:(i + 1) * fo, :ck],
                                      col[:, i * ck:(i + 1) * ck])
                         for i in range(groups)], dim=1)
    else:
        out = torch.matmul(wmat, col)
    out = out.reshape(n, int(num_filter), oh, ow).to(data.dtype)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1).to(data.dtype)
    return out


def _params(kernel, stride, dilate, pad, num_filter, num_group,
            num_deformable_group):
    return dict(kernel=tuple(kernel), stride=tuple(stride),
                dilate=tuple(dilate), pad=tuple(pad), num_filter=num_filter,
                num_group=num_group,
                num_deformable_group=num_deformable_group)


@register("_contrib_DeformableConvolution", nin=None,
          aliases=["deformable_convolution"])
def _deformable_convolution(args, kernel=(3, 3), stride=(1, 1),
                            dilate=(1, 1), pad=(0, 0), num_filter=0,
                            num_group=1, num_deformable_group=1,
                            no_bias=False, workspace=1024, layout=None):
    """Deformable convolution v1: ``[data, offset, weight(, bias)]``."""
    data, offset, weight, bias = (*args, None)[:4] if no_bias else args
    return deformable_convolution(
        data, offset, weight, bias, None,
        **_params(kernel, stride, dilate, pad, num_filter, num_group,
                  num_deformable_group))


@register("_contrib_ModulatedDeformableConvolution", nin=None,
          aliases=["modulated_deformable_convolution"])
def _modulated_deformable_convolution(args, kernel=(3, 3), stride=(1, 1),
                                      dilate=(1, 1), pad=(0, 0),
                                      num_filter=0, num_group=1,
                                      num_deformable_group=1, no_bias=False,
                                      workspace=1024, layout=None):
    """Deformable convolution v2: ``[data, offset, mask, weight(, bias)]``,
    each sample scaled by its mask."""
    data, offset, mask, weight, bias = ((*args, None)[:5] if no_bias
                                        else args)
    return deformable_convolution(
        data, offset, weight, bias, mask,
        **_params(kernel, stride, dilate, pad, num_filter, num_group,
                  num_deformable_group))
