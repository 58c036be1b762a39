"""Vision transforms (counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``, reference
``python/mxnet/gluon/data/vision/transforms.py``).

Each transform is a ``Block`` over NDArrays (called with tensors, it
takes and gives tensors), computing with the ``mx.nd.image`` ops where
the image is.  Images are HWC (or NHWC), as the image ops take them,
until ``ToTensor`` makes them CHW float32 in [0, 1].

Random draws: the crops, flips, ``RandomApply`` and the jitter order use
numpy's global generator, as the JAX package's do; the colour factors
and the lighting noise come from ``mx.random``'s generator for the image's
device (the JAX package draws them from its own key).
"""
from __future__ import annotations

import math

import numpy as _np

from ....ndarray import image as _img
from ....ndarray.ndarray import invoke as _invoke
from ...block import Block
from ...nn import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomResizedCrop", "RandomFlipLeftRight", "RandomFlipTopBottom",
           "RandomCrop", "CropResize", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomHue", "RandomColorJitter",
           "RandomLighting", "RandomApply"]


class Compose(Sequential):
    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(Block):
    _nd_forward = True

    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return x.astype(self._dtype)


class ToTensor(Block):
    """HWC uint8 in [0, 255] -> CHW float32 in [0, 1] (NHWC -> NCHW)."""

    _nd_forward = True

    def forward(self, x):
        return _img.to_tensor(x)


class Normalize(Block):
    """``(x - mean) / std`` per channel of a CHW (or NCHW) image."""

    _nd_forward = True

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = tuple(_np.asarray(mean, "float32").ravel().tolist())
        self._std = tuple(_np.asarray(std, "float32").ravel().tolist())

    def forward(self, x):
        return _img.normalize(x, self._mean, self._std)


class Resize(Block):
    """Resize an HWC image to ``size`` (an int: square; else (w, h)), or
    with ``keep_ratio`` its short side to ``size``."""

    _nd_forward = True

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
        return _img.resize(x, (w, h), interp=self._interp)


class CenterCrop(Block):
    """The centred ``size`` (w, h) window (no resize)."""

    _nd_forward = True

    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        w, h = self._size
        H, W = x.shape[0], x.shape[1]
        return _img.crop(x, max((W - w) // 2, 0), max((H - h) // 2, 0), w, h)


class RandomCrop(Block):
    """A ``size`` (w, h) window at a random place, after zero-padding by
    ``pad`` pixels on each side."""

    _nd_forward = True

    def __init__(self, size, pad=None):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._pad = pad

    def forward(self, x):
        w, h = self._size
        if self._pad:
            p = self._pad
            x = _invoke("pad", [x], {"mode": "constant",
                                     "pad_width": (p, p, p, p, 0, 0)})
        H, W = x.shape[0], x.shape[1]
        y0 = _np.random.randint(0, H - h + 1)
        x0 = _np.random.randint(0, W - w + 1)
        return _img.crop(x, x0, y0, w, h)


class RandomResizedCrop(Block):
    """A random window of ``scale`` of the area and ``ratio`` aspect,
    resized to ``size``; after 10 misses, the centred square."""

    _nd_forward = True

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
                return _img.resize(_img.crop(x, x0, y0, w, h), self._size,
                                   interp=self._interp)
        side = min(H, W)
        return _img.resize(_img.crop(x, (W - side) // 2, (H - side) // 2,
                                     side, side), self._size,
                           interp=self._interp)


class RandomFlipLeftRight(Block):
    _nd_forward = True

    def forward(self, x):
        if _np.random.rand() < 0.5:
            return _img.flip_left_right(x)
        return x


class RandomFlipTopBottom(Block):
    _nd_forward = True

    def forward(self, x):
        if _np.random.rand() < 0.5:
            return _img.flip_top_bottom(x)
        return x


class CropResize(Block):
    """The fixed window at (x, y) of ``width`` x ``height``, resized to
    ``size`` when given."""

    _nd_forward = True

    def __init__(self, x, y, width, height, size=None, interpolation=1):
        super().__init__()
        self._x, self._y, self._w, self._h = x, y, width, height
        self._size = ((size, size) if isinstance(size, int)
                      else tuple(size) if size else None)
        self._interp = interpolation

    def forward(self, data):
        out = _img.crop(data, self._x, self._y, self._w, self._h)
        if self._size is not None:
            out = _img.resize(out, self._size, interp=self._interp)
        return out


class _RandomColor(Block):
    """``mx.nd.image.<_fn>`` with its factor drawn uniform in
    [max(0, 1 - jitter), 1 + jitter]."""

    _nd_forward = True
    _fn = None

    def __init__(self, max_jitter):
        super().__init__()
        self._jitter = max_jitter

    def forward(self, x):
        return getattr(_img, self._fn)(x, max(0.0, 1.0 - self._jitter),
                                       1.0 + self._jitter)


class RandomBrightness(_RandomColor):
    """``x * alpha``."""
    _fn = "random_brightness"


class RandomContrast(_RandomColor):
    """``x * alpha + mean(gray(x)) * (1 - alpha)``."""
    _fn = "random_contrast"


class RandomSaturation(_RandomColor):
    """``x * alpha + gray(x) * (1 - alpha)``."""
    _fn = "random_saturation"


class RandomHue(_RandomColor):
    """A hue rotation by alpha·pi in YIQ space, clipped at 0."""
    _fn = "random_hue"


class RandomColorJitter(Block):
    """Brightness, contrast, saturation and hue jitter (each given as its
    ``max_jitter``; 0 leaves it out) in a random order."""

    _nd_forward = True

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

    _nd_forward = True

    def __init__(self, alpha=0.05):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return _img.random_lighting(x, self._alpha)


class RandomApply(Sequential):
    """``transforms`` with probability ``p``, else the identity."""

    _nd_forward = True

    def __init__(self, transforms, p=0.5):
        super().__init__()
        self.transforms = transforms
        self.p = p

    def forward(self, x):
        if _np.random.rand() < self.p:
            return self.transforms(x)
        return x
