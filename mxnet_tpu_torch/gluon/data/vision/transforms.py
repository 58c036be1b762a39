"""Vision transforms (counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``, reference
``python/mxnet/gluon/data/vision/transforms.py``).

Each transform is a ``Block``: called with an NDArray it returns one, on
the same context; its ``forward`` computes on the tensor.  Images are HWC
(or NHWC), as the JAX package's image ops take them, until ``ToTensor``
makes them CHW float32 in [0, 1].  The image ops the JAX package keeps in
``ops/image.py`` (resize, crop, the colour jitters, PCA lighting) are
written here on torch tensors; ``mx.nd.image`` itself is not ported yet
(ROADMAP A4).

Random draws: the crops, flips, ``RandomApply`` and the jitter order use
numpy's global generator, as the JAX package's do; the colour factors
and the lighting noise come from ``mx.random``'s generator for the image's
device (the JAX package draws them from its own key).
"""
from __future__ import annotations

import math

import numpy as _np
import torch
import torch.nn.functional as F

from .... import random as _random
from ....base import dtype_torch
from ...block import Block
from ...nn import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomResizedCrop", "RandomFlipLeftRight", "RandomFlipTopBottom",
           "RandomCrop", "CropResize", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomHue", "RandomColorJitter",
           "RandomLighting", "RandomApply"]

_GRAY = (0.299, 0.587, 0.114)


def _resize(x, w: int, h: int, interpolation: int = 1):
    """HWC or NHWC ``x`` resized to ``h`` x ``w`` in fp32, bilinear (with
    antialiasing when it shrinks, as ``jax.image.resize``) for
    ``interpolation`` 1, else nearest; back in ``x``'s dtype."""
    batch = x.dim() == 4
    nchw = (x if batch else x[None]).permute(0, 3, 1, 2).float()
    if interpolation == 1:
        out = F.interpolate(nchw, size=(h, w), mode="bilinear",
                            align_corners=False, antialias=True)
    else:
        out = F.interpolate(nchw, size=(h, w), mode="nearest")
    out = out.permute(0, 2, 3, 1)
    return (out if batch else out[0]).to(x.dtype)


def _crop(x, x0: int, y0: int, w: int, h: int):
    if x.dim() == 4:
        return x[:, y0:y0 + h, x0:x0 + w, :]
    return x[y0:y0 + h, x0:x0 + w, :]


def _uniform(x, lo: float, hi: float):
    gen = _random.device_generator(x.device)
    return torch.empty((), device=x.device).uniform_(lo, hi, generator=gen)


def _gray(x):
    coef = torch.tensor(_GRAY, dtype=x.dtype, device=x.device)
    return (x * coef).sum(dim=-1, keepdim=True)


class Compose(Sequential):
    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(Block):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype_torch(dtype)

    def forward(self, x):
        return x.to(self._dtype)


class ToTensor(Block):
    """HWC uint8 in [0, 255] -> CHW float32 in [0, 1] (NHWC -> NCHW)."""

    def forward(self, x):
        out = x.float() / 255.0
        return out.permute(2, 0, 1) if out.dim() == 3 else out.permute(
            0, 3, 1, 2)


class Normalize(Block):
    """``(x - mean) / std`` per channel of a CHW (or NCHW) image."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = _np.asarray(mean, "float32").reshape(-1, 1, 1)
        self._std = _np.asarray(std, "float32").reshape(-1, 1, 1)

    def forward(self, x):
        mean = torch.from_numpy(self._mean).to(x.device)
        std = torch.from_numpy(self._std).to(x.device)
        return (x - mean) / std


class Resize(Block):
    """Resize an HWC image to ``size`` (an int: square; else (w, h)), or
    with ``keep_ratio`` its short side to ``size``."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._keep = keep_ratio and isinstance(size, int)
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._interp = interpolation

    def forward(self, x):
        if self._keep:
            ih, iw = x.shape[-3], x.shape[-2]
            short = self._size[0]
            if ih < iw:
                h, w = short, max(1, round(iw * short / ih))
            else:
                h, w = max(1, round(ih * short / iw)), short
        else:
            w, h = self._size
        return _resize(x, w, h, self._interp)


class CenterCrop(Block):
    """The centred ``size`` (w, h) window (no resize)."""

    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        w, h = self._size
        H, W = x.shape[0], x.shape[1]
        return _crop(x, max((W - w) // 2, 0), max((H - h) // 2, 0), w, h)


class RandomCrop(Block):
    """A ``size`` (w, h) window at a random place, after zero-padding by
    ``pad`` pixels on each side."""

    def __init__(self, size, pad=None):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._pad = pad

    def forward(self, x):
        w, h = self._size
        if self._pad:
            p = self._pad
            x = F.pad(x, (0, 0, p, p, p, p))
        H, W = x.shape[0], x.shape[1]
        y0 = _np.random.randint(0, H - h + 1)
        x0 = _np.random.randint(0, W - w + 1)
        return _crop(x, x0, y0, w, h)


class RandomResizedCrop(Block):
    """A random window of ``scale`` of the area and ``ratio`` aspect,
    resized to ``size``; after 10 misses, the centred square."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio
        self._interp = interpolation

    def forward(self, x):
        H, W = x.shape[0], x.shape[1]
        area = H * W
        for _ in range(10):
            target_area = _np.random.uniform(*self._scale) * area
            aspect = _np.random.uniform(*self._ratio)
            w = int(round(math.sqrt(target_area * aspect)))
            h = int(round(math.sqrt(target_area / aspect)))
            if w <= W and h <= H:
                x0 = _np.random.randint(0, W - w + 1)
                y0 = _np.random.randint(0, H - h + 1)
                return _resize(_crop(x, x0, y0, w, h), *self._size,
                               self._interp)
        side = min(H, W)
        return _resize(_crop(x, (W - side) // 2, (H - side) // 2, side,
                             side), *self._size, self._interp)


class RandomFlipLeftRight(Block):
    def forward(self, x):
        if _np.random.rand() < 0.5:
            return torch.flip(x, dims=(1,))
        return x


class RandomFlipTopBottom(Block):
    def forward(self, x):
        if _np.random.rand() < 0.5:
            return torch.flip(x, dims=(0,))
        return x


class CropResize(Block):
    """The fixed window at (x, y) of ``width`` x ``height``, resized to
    ``size`` when given."""

    def __init__(self, x, y, width, height, size=None, interpolation=1):
        super().__init__()
        self._x, self._y, self._w, self._h = x, y, width, height
        self._size = ((size, size) if isinstance(size, int)
                      else tuple(size) if size else None)
        self._interp = interpolation

    def forward(self, data):
        out = _crop(data, self._x, self._y, self._w, self._h)
        if self._size is not None:
            out = _resize(out, *self._size, self._interp)
        return out


class _RandomColor(Block):
    """A factor alpha drawn uniform in [max(0, 1 - jitter), 1 + jitter]."""

    def __init__(self, max_jitter):
        super().__init__()
        self._jitter = max_jitter

    def forward(self, x):
        return self._apply(x, _uniform(x, max(0.0, 1.0 - self._jitter),
                                       1.0 + self._jitter))


class RandomBrightness(_RandomColor):
    """``x * alpha``."""

    @staticmethod
    def _apply(x, alpha):
        return x * alpha


class RandomContrast(_RandomColor):
    """``x * alpha + mean(gray(x)) * (1 - alpha)``."""

    @staticmethod
    def _apply(x, alpha):
        mean = _gray(x).mean(dim=(-3, -2, -1), keepdim=True)
        return x * alpha + mean * (1.0 - alpha)


class RandomSaturation(_RandomColor):
    """``x * alpha + gray(x) * (1 - alpha)``."""

    @staticmethod
    def _apply(x, alpha):
        return x * alpha + _gray(x) * (1.0 - alpha)


class RandomHue(_RandomColor):
    """A hue rotation by alpha·pi in YIQ space, clipped at 0 (the JAX
    package's linear form)."""

    @staticmethod
    def _apply(x, alpha):
        dev = x.device
        u, w = torch.cos(alpha * math.pi), torch.sin(alpha * math.pi)
        t_yiq = torch.tensor([[0.299, 0.587, 0.114],
                              [0.596, -0.274, -0.321],
                              [0.211, -0.523, 0.311]], device=dev)
        t_rgb = torch.tensor([[1.0, 0.956, 0.621],
                              [1.0, -0.272, -0.647],
                              [1.0, -1.107, 1.705]], device=dev)
        e1 = torch.tensor([0.0, 1.0, 0.0], device=dev)
        e2 = torch.tensor([0.0, 0.0, 1.0], device=dev)
        rot = torch.stack([torch.tensor([1.0, 0.0, 0.0], device=dev),
                           e1 * u + e2 * w, e2 * u - e1 * w])
        m = t_rgb @ rot @ t_yiq
        return torch.clamp(x @ m.t().to(x.dtype), min=0)


class RandomColorJitter(Block):
    """Brightness, contrast, saturation and hue jitter (each given as its
    ``max_jitter``; 0 leaves it out) in a random order."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._parts = []
        for cls, jitter in ((RandomBrightness, brightness),
                            (RandomContrast, contrast),
                            (RandomSaturation, saturation),
                            (RandomHue, hue)):
            if jitter:
                self._parts.append(cls(jitter))

    def forward(self, x):
        for i in _np.random.permutation(len(self._parts)):
            x = self._parts[i](x)
        return x


class RandomLighting(Block):
    """AlexNet's PCA lighting noise: ``x + eigvec @ (alpha * eigval)`` per
    pixel, alpha ~ N(0, alpha_std^2) per channel."""

    _EIGVAL = (55.46, 4.794, 1.148)
    _EIGVEC = ((-0.5675, 0.7192, 0.4009),
               (-0.5808, -0.0045, -0.8140),
               (-0.5836, -0.6948, 0.4203))

    def __init__(self, alpha=0.05):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        gen = _random.device_generator(x.device)
        alpha = torch.randn(3, generator=gen, device=x.device) * self._alpha
        return self._apply(x, alpha)

    @classmethod
    def _apply(cls, x, alpha):
        eigval = torch.tensor(cls._EIGVAL, device=x.device)
        eigvec = torch.tensor(cls._EIGVEC, device=x.device)
        delta = (eigvec * alpha * eigval).sum(dim=1)
        return x + delta.to(x.dtype)


class RandomApply(Sequential):
    """``transforms`` with probability ``p``, else the identity."""

    def __init__(self, transforms, p=0.5):
        super().__init__()
        self.transforms = transforms
        self.p = p

    def forward(self, x):
        if _np.random.rand() < self.p:
            return self.transforms(x)
        return x
