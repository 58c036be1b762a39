"""Image ops (counterpart of ``mxnet_tpu/ops/image.py``, reference
``src/operator/image/image_random-inl.h`` and ``resize-inl.h``): resize,
crop, normalize, flips and the colour jitters on HWC images or NHWC
batches, uint8 or float, wherever the image is.

The random ops draw from ``generator``, ``mx.random``'s stream for the
image's device unless the caller passes one (the JAX package draws from
its threefry key, so the two packages' draws differ).  Every draw stays
on the device: the random crop gathers its window with device indices
and the random flips select with ``torch.where``, so no op reads a value
back to the host.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import register

__all__ = []

_GRAY = (0.299, 0.587, 0.114)
_EIGVAL = (55.46, 4.794, 1.148)
_EIGVEC = ((-0.5675, 0.7192, 0.4009),
           (-0.5808, -0.0045, -0.8140),
           (-0.5836, -0.6948, 0.4203))
_YIQ = ((0.299, 0.587, 0.114), (0.596, -0.274, -0.321),
        (0.211, -0.523, 0.311))
_RGB = ((1.0, 0.956, 0.621), (1.0, -0.272, -0.647), (1.0, -1.107, 1.705))


def _hw(x):
    """The axes of height and width."""
    return (1, 2) if x.dim() == 4 else (0, 1)


@register("_image_resize")
def _image_resize(x, size=None, keep_ratio: bool = False, interp: int = 1):
    """Resize to ``size`` = int or (w, h) in fp32, back in ``x``'s dtype:
    bilinear with antialiasing when it shrinks (as ``jax.image.resize``)
    for ``interp`` 1, else nearest with half-pixel centres.
    ``keep_ratio`` is accepted and ignored, as in the JAX package."""
    w, h = (size, size) if isinstance(size, int) else tuple(size)
    batch = x.dim() == 4
    nchw = (x if batch else x[None]).permute(0, 3, 1, 2).float()
    if int(interp) == 1:
        out = F.interpolate(nchw, size=(h, w), mode="bilinear",
                            align_corners=False, antialias=True)
    else:
        out = F.interpolate(nchw, size=(h, w), mode="nearest-exact")
    out = out.permute(0, 2, 3, 1)
    return (out if batch else out[0]).to(x.dtype)


@register("_image_crop")
def _image_crop(x, x0: int = 0, y0: int = 0, width: int = 0, height: int = 0):
    x0, y0, width, height = int(x0), int(y0), int(width), int(height)
    if x.dim() == 4:
        return x[:, y0:y0 + height, x0:x0 + width, :]
    return x[y0:y0 + height, x0:x0 + width, :]


@register("_image_random_crop")
def _image_random_crop(x, width: int = 0, height: int = 0, generator=None):
    """A ``width`` x ``height`` window at a uniform place."""
    hd, wd = _hw(x)
    dev = x.device
    y0 = torch.randint(0, x.shape[hd] - int(height) + 1, (), device=dev,
                       generator=generator)
    x0 = torch.randint(0, x.shape[wd] - int(width) + 1, (), device=dev,
                       generator=generator)
    rows = y0 + torch.arange(int(height), device=dev)
    cols = x0 + torch.arange(int(width), device=dev)
    return x.index_select(hd, rows).index_select(wd, cols)


@register("_image_to_tensor")
def _image_to_tensor(x):
    """HWC in [0, 255] -> CHW float32 in [0, 1] (NHWC -> NCHW)."""
    out = x.float() / 255.0
    return out.permute(2, 0, 1) if out.dim() == 3 else out.permute(0, 3, 1, 2)


@register("_image_normalize")
def _image_normalize(x, mean=0.0, std=1.0):
    """``(x - mean) / std`` per channel of a CHW image or NCHW batch."""
    shape = (1, -1, 1, 1) if x.dim() == 4 else (-1, 1, 1)
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean.reshape(shape)) / std.reshape(shape)


@register("_image_flip_left_right")
def _image_flip_left_right(x):
    return torch.flip(x, dims=(_hw(x)[1],))


@register("_image_flip_top_bottom")
def _image_flip_top_bottom(x):
    return torch.flip(x, dims=(_hw(x)[0],))


def _coin(x, generator):
    return torch.rand((), device=x.device, generator=generator) < 0.5


@register("_image_random_flip_left_right")
def _image_random_flip_left_right(x, generator=None):
    return torch.where(_coin(x, generator), _image_flip_left_right(x), x)


@register("_image_random_flip_top_bottom")
def _image_random_flip_top_bottom(x, generator=None):
    return torch.where(_coin(x, generator), _image_flip_top_bottom(x), x)


def _factor(x, lo, hi, generator):
    return torch.empty((), device=x.device).uniform_(
        float(lo), float(hi), generator=generator)


def _gray(x):
    """The luma of each pixel, with the weights in ``x``'s dtype (for an
    integer image they round to 0, as in the JAX package)."""
    coef = torch.tensor(_GRAY, device=x.device).to(x.dtype)
    return (x * coef).sum(dim=-1, keepdim=True)


@register("_image_random_brightness")
def _image_random_brightness(x, min_factor: float = 0.0,
                             max_factor: float = 0.0, generator=None):
    """``x · alpha``, alpha uniform in [min_factor, max_factor]."""
    return x * _factor(x, min_factor, max_factor, generator)


@register("_image_random_contrast")
def _image_random_contrast(x, min_factor: float = 0.0,
                           max_factor: float = 0.0, generator=None):
    """``x · alpha + mean(gray(x)) · (1 - alpha)``."""
    alpha = _factor(x, min_factor, max_factor, generator)
    mean = _gray(x).float().mean(dim=(-3, -2, -1), keepdim=True)
    return x * alpha + mean * (1.0 - alpha)


@register("_image_random_saturation")
def _image_random_saturation(x, min_factor: float = 0.0,
                             max_factor: float = 0.0, generator=None):
    """``x · alpha + gray(x) · (1 - alpha)``."""
    alpha = _factor(x, min_factor, max_factor, generator)
    return x * alpha + _gray(x) * (1.0 - alpha)


@register("_image_random_hue")
def _image_random_hue(x, min_factor: float = 0.0, max_factor: float = 0.0,
                      generator=None):
    """A rotation by alpha·pi of the chroma in YIQ space, clipped at 0
    (the JAX package's linear form).  An integer image is rotated in
    fp32 and cast back."""
    alpha = _factor(x, min_factor, max_factor, generator)
    dev = x.device
    u, w = torch.cos(alpha * math.pi), torch.sin(alpha * math.pi)
    e1 = torch.tensor([0.0, 1.0, 0.0], device=dev)
    e2 = torch.tensor([0.0, 0.0, 1.0], device=dev)
    rot = torch.stack([torch.tensor([1.0, 0.0, 0.0], device=dev),
                       e1 * u + e2 * w, e2 * u - e1 * w])
    m = torch.tensor(_RGB, device=dev) @ rot @ torch.tensor(_YIQ, device=dev)
    if not x.is_floating_point():
        return torch.clamp(x.float() @ m.t(), min=0).to(x.dtype)
    return torch.clamp(x @ m.t().to(x.dtype), min=0)


@register("_image_random_lighting")
def _image_random_lighting(x, alpha_std: float = 0.05, generator=None):
    """AlexNet's PCA lighting noise: ``x + eigvec @ (alpha · eigval)``
    per pixel, alpha ~ N(0, alpha_std²) per channel."""
    dev = x.device
    alpha = torch.randn(3, device=dev, generator=generator) * float(alpha_std)
    eigval = torch.tensor(_EIGVAL, device=dev)
    eigvec = torch.tensor(_EIGVEC, device=dev)
    delta = (eigvec * alpha * eigval).sum(dim=1)
    return x + delta.to(x.dtype)


@register("_image_swap_axis")
def _image_swap_axis(x, dim1: int = 0, dim2: int = 2):
    return torch.transpose(x, int(dim1), int(dim2))
