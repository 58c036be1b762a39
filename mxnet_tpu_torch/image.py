"""``mx.image``: image decoding, the functional crops and resizes, the
augmenters and ``ImageIter`` (counterpart of ``mxnet_tpu/image.py``,
reference ``python/mxnet/image/image.py``).

Images decode on the host with PIL (the reference uses OpenCV) into HWC
uint8 NDArrays on the current context; the augmenters are ``mx.nd.image``
ops and NDArray arithmetic, so they run where the image is (on the card
when the context is ``mx.gpu()``).  The random crops, flips and the
jitters' order draw from Python's ``random`` module, as in the JAX
package; the jitters' factors and the lighting noise from ``mx.random``'s
stream for the image's device.
"""
from __future__ import annotations

import io as _io
import json
import math
import os
import random as _pyrandom

import numpy as _np
import torch

from .ndarray import image as ndimg
from .ndarray.ndarray import NDArray, array as _nd_array, concatenate, invoke

__all__ = ["imread", "imdecode", "imresize", "resize_short", "fixed_crop",
           "center_crop", "random_crop", "color_normalize", "scale_down",
           "copyMakeBorder", "random_size_crop", "CreateAugmenter",
           "ImageIter", "Augmenter", "SequentialAug", "ResizeAug",
           "ForceResizeAug", "RandomCropAug", "RandomSizedCropAug",
           "CenterCropAug", "RandomOrderAug", "BrightnessJitterAug",
           "ContrastJitterAug", "SaturationJitterAug", "HueJitterAug",
           "ColorJitterAug", "LightingAug", "ColorNormalizeAug",
           "RandomGrayAug", "HorizontalFlipAug", "CastAug"]


def imdecode(buf, flag=1, to_rgb=True):
    """Decode an encoded (JPEG, PNG, ...) byte buffer to an HWC uint8
    NDArray: 3 channels for ``flag`` 1 (BGR when ``to_rgb`` is false),
    else 1."""
    from PIL import Image

    pil = Image.open(_io.BytesIO(bytes(buf))).convert("RGB" if flag else "L")
    arr = _np.asarray(pil)
    if not to_rgb and flag:
        arr = arr[..., ::-1]
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return _nd_array(arr)


def imread(filename, flag=1, to_rgb=True):
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


def imresize(src, w, h, interp=1):
    return ndimg.resize(src, (w, h), interp=interp)


def resize_short(src, size, interp=1):
    """Resize so that the shorter side is ``size``."""
    h, w = src.shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return ndimg.resize(src, (new_w, new_h), interp=interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=1):
    """The window at (x0, y0) of w x h, resized to ``size`` (w, h) when
    given and different."""
    out = ndimg.crop(src, x0, y0, w, h)
    if size is not None and (w, h) != tuple(size):
        out = ndimg.resize(out, size, interp=interp)
    return out


def center_crop(src, size, interp=1):
    """The centred ``size`` (w, h) window; returns (crop, (x0, y0, w, h))."""
    h, w = src.shape[:2]
    new_w, new_h = size
    x0, y0 = (w - new_w) // 2, (h - new_h) // 2
    return fixed_crop(src, x0, y0, new_w, new_h), (x0, y0, new_w, new_h)


def random_crop(src, size, interp=1):
    """A ``size`` (w, h) window at a uniform place; returns (crop,
    (x0, y0, w, h))."""
    h, w = src.shape[:2]
    new_w, new_h = size
    x0 = _pyrandom.randint(0, max(w - new_w, 0))
    y0 = _pyrandom.randint(0, max(h - new_h, 0))
    return fixed_crop(src, x0, y0, new_w, new_h), (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    src = src - mean
    if std is not None:
        src = src / std
    return src


def scale_down(src_size, size):
    """Shrink a crop ``size`` (w, h) that exceeds the image's
    ``src_size`` (w, h), keeping its aspect."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def copyMakeBorder(src, top, bot, left, right, border_type=0, values=0.0):
    """Pad an HWC image's borders with a constant, one value or one per
    channel."""
    flat = (top, bot, left, right) + (0, 0) * (src.ndim - 2)
    if _np.isscalar(values):
        return invoke("pad", [src], {"mode": "constant", "pad_width": flat,
                                     "constant_value": float(values)})
    vals = _np.asarray(values, _np.float32).ravel()
    chans = [invoke("pad", [src[:, :, c:c + 1]],
                    {"mode": "constant", "pad_width": flat,
                     "constant_value": float(vals[c % len(vals)])})
             for c in range(src.shape[2])]
    return concatenate(chans, axis=2)


def random_size_crop(src, size, area, ratio, interp=1, **kwargs):
    """A random window of ``area`` (a fraction, or a (min, max) range) of
    the image and aspect in ``ratio``, resized to ``size``; after 10
    misses, the centre crop.  Returns (crop, (x0, y0, w, h))."""
    h, w = src.shape[:2]
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = _pyrandom.uniform(*area) * h * w
        aspect = math.exp(_pyrandom.uniform(math.log(ratio[0]),
                                            math.log(ratio[1])))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if cw <= w and ch <= h:
            x0 = _pyrandom.randint(0, w - cw)
            y0 = _pyrandom.randint(0, h - ch)
            return (fixed_crop(src, x0, y0, cw, ch, size, interp),
                    (x0, y0, cw, ch))
    return center_crop(src, size, interp)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0, **kwargs):
    """The reference's augmenter pipeline for ``data_shape`` (C, H, W), a
    list of callables over HWC NDArrays.  ``mean`` and ``std`` are taken
    as given (the JAX package reads ``mean=True`` as 1.0, not as the
    ImageNet means: pass the values)."""
    augs = []
    if resize > 0:
        augs.append(ResizeAug(resize))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        augs.append(RandomSizedCropAug(crop_size, 0.08, (3 / 4.0, 4 / 3.0)))
    elif rand_crop:
        augs.append(RandomCropAug(crop_size))
    else:
        augs.append(CenterCropAug(crop_size))
    if rand_mirror:
        augs.append(HorizontalFlipAug(0.5))
    jitter = ColorJitterAug(brightness, contrast, saturation)
    if jitter.ts:
        augs.append(jitter)
    if hue:
        augs.append(HueJitterAug(hue))
    if pca_noise:
        augs.append(LightingAug(pca_noise))
    if mean is not None or std is not None:
        augs.append(ColorNormalizeAug(mean if mean is not None else 0.0,
                                      std if std is not None else 1.0))
    return augs


class ImageIter:
    """Batches of images read from files through an augmenter list
    (reference ``python/mxnet/image/image.py:1139``), the fine-tune
    loader for data that is not packed into a .rec file.

    ``imglist`` is a list of [label, path] entries (or a dict path ->
    label); else ``path_imglist`` names a tab-separated .lst file
    (index, labels..., path).  Paths are relative to ``path_root``.  A
    short last batch is padded with its last sample (``pad`` counts them,
    the reference's ``last_batch_handle='pad'``).  Each batch is NCHW
    float32 with float32 labels, on the images' context; the images are
    stacked there, with no copy through the host."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imglist=None, path_root="", imglist=None,
                 shuffle=False, aug_list=None, data_name="data",
                 label_name="softmax_label", seed=0, **kwargs):
        from .io import DataDesc
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._root = path_root
        self._shuffle = shuffle
        self._rng = _np.random.RandomState(seed)
        self._augs = aug_list if aug_list is not None else CreateAugmenter(
            data_shape, **kwargs)
        entries = []
        if imglist is not None:
            items = imglist.items() if isinstance(imglist, dict) else imglist
            for item in items:
                if isinstance(imglist, dict):
                    path, label = item
                else:
                    label, path = item[0], item[-1]
                entries.append((_np.atleast_1d(_np.asarray(label,
                                                           _np.float32)),
                                path))
        elif path_imglist:
            with open(path_imglist) as f:
                for lineno, line in enumerate(f, 1):
                    if not line.strip():
                        continue
                    parts = line.strip().split("\t")
                    if len(parts) < 3:
                        raise ValueError(
                            f"{path_imglist}:{lineno}: expected "
                            "index<TAB>label...<TAB>path, got "
                            f"{line.strip()!r}")
                    entries.append((_np.asarray([float(x) for x in
                                                 parts[1:-1]], _np.float32),
                                    parts[-1]))
        else:
            raise ValueError("need imglist or path_imglist")
        self._entries = entries
        self.provide_data = [DataDesc(data_name,
                                      (batch_size,) + self.data_shape,
                                      _np.float32)]
        lshape = (batch_size,) if label_width == 1 else (batch_size,
                                                         label_width)
        self.provide_label = [DataDesc(label_name, lshape, _np.float32)]
        self.reset()

    def reset(self):
        self._order = list(range(len(self._entries)))
        if self._shuffle:
            self._rng.shuffle(self._order)
        self._cursor = 0

    def _load(self, path):
        full = os.path.join(self._root, path) if self._root else path
        img = imread(full)
        for aug in self._augs:
            img = aug(img)
        return img

    def next(self):
        from .io import DataBatch
        if self._cursor >= len(self._order):
            raise StopIteration
        idxs = self._order[self._cursor:self._cursor + self.batch_size]
        self._cursor += self.batch_size
        pad = self.batch_size - len(idxs)
        if pad:
            idxs = idxs + [idxs[-1]] * pad
        imgs, labels = [], []
        for i in idxs:
            label, path = self._entries[i]
            imgs.append(self._load(path)._data.permute(2, 0, 1).float())
            labels.append(label if self.label_width > 1 else label[0])
        data = NDArray(torch.stack(imgs))
        lab = _nd_array(_np.asarray(labels, _np.float32), ctx=data.context)
        return DataBatch([data], [lab], pad=pad)

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()


class Augmenter:
    """Image augmenter base (reference image.py:602): a callable over an
    HWC NDArray whose ``dumps()`` gives its configuration as JSON."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([type(self).__name__, self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def dumps(self):
        return [type(self).__name__, [t.dumps() for t in self.ts]]

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


class ResizeAug(Augmenter):
    """Resize the shorter side to ``size``."""

    def __init__(self, size, interp=1):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    """Resize to ``size`` (w, h)."""

    def __init__(self, size, interp=1):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=1):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size, self.area, self.ratio, self.interp = (size, area, ratio,
                                                         interp)

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class RandomOrderAug(Augmenter):
    """The augmenters ``ts`` in a random order."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def dumps(self):
        return [type(self).__name__, [t.dumps() for t in self.ts]]

    def __call__(self, src):
        ts = list(self.ts)
        _pyrandom.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        return ndimg.random_brightness(src, 1 - self.brightness,
                                       1 + self.brightness)


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        return ndimg.random_contrast(src, 1 - self.contrast,
                                     1 + self.contrast)


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        return ndimg.random_saturation(src, 1 - self.saturation,
                                       1 + self.saturation)


class HueJitterAug(Augmenter):
    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue

    def __call__(self, src):
        return ndimg.random_hue(src, 1 - self.hue, 1 + self.hue)


class ColorJitterAug(RandomOrderAug):
    """Brightness, contrast and saturation jitter (each left out at 0) in
    a random order."""

    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


def _numbers(v):
    if v is None or isinstance(v, (int, float)):
        return v
    return [float(x) for x in _np.asarray(v).ravel()]


class LightingAug(Augmenter):
    """PCA noise: the op's ImageNet basis on the image's device, or, given
    ``eigval`` and ``eigvec``, theirs with the noise drawn by numpy."""

    def __init__(self, alphastd, eigval=None, eigvec=None):
        super().__init__(
            alphastd=alphastd,
            eigval=None if eigval is None else _numbers(eigval),
            eigvec=None if eigvec is None else [_numbers(r) for r in
                                                _np.asarray(eigvec)])
        self.alphastd = alphastd
        self.eigval = None if eigval is None else _np.asarray(eigval,
                                                              _np.float32)
        self.eigvec = None if eigvec is None else _np.asarray(eigvec,
                                                              _np.float32)

    def __call__(self, src):
        if self.eigval is None or self.eigvec is None:
            return ndimg.random_lighting(src, self.alphastd)
        alpha = _np.random.normal(0, self.alphastd, size=(3,)).astype(
            _np.float32)
        return src + _nd_array(_np.dot(self.eigvec * alpha, self.eigval),
                               ctx=src.context)


class ColorNormalizeAug(Augmenter):
    """``(src - mean) / std`` per channel."""

    def __init__(self, mean, std):
        super().__init__(mean=_numbers(mean), std=_numbers(std))
        self.mean = None if mean is None else _np.asarray(mean, _np.float32)
        self.std = None if std is None else _np.asarray(std, _np.float32)
        self._on = {}  # context -> (mean, std) arrays there

    def __call__(self, src):
        ctx = src.context
        if ctx not in self._on:
            self._on[ctx] = tuple(None if v is None else _nd_array(v, ctx=ctx)
                                  for v in (self.mean, self.std))
        return color_normalize(src, *self._on[ctx])


class RandomGrayAug(Augmenter):
    """Gray (the luma in every channel) with probability ``p``."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            coef = _nd_array(_np.array([0.299, 0.587, 0.114], _np.float32),
                             ctx=src.context)
            gray = (src.astype("float32") * coef).sum(axis=2, keepdims=True)
            return invoke("broadcast_like", [gray, src], {}).astype(src.dtype)
        return src


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            return ndimg.flip_left_right(src)
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)
