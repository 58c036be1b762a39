"""``mx.nd.image`` (counterpart of ``mxnet_tpu/ndarray/image.py``,
reference ``python/mxnet/ndarray/image.py``): the ``_image_*`` ops of
``ops/image.py`` on HWC images and NHWC batches."""
from __future__ import annotations

from .ndarray import invoke as _invoke

__all__ = ["resize", "crop", "random_crop", "to_tensor", "normalize",
           "flip_left_right", "flip_top_bottom", "random_flip_left_right",
           "random_flip_top_bottom", "random_brightness", "random_contrast",
           "random_saturation", "random_hue", "random_lighting", "swap_axis"]


def resize(data, size, keep_ratio=False, interp=1):
    return _invoke("_image_resize", [data],
                   {"size": size, "keep_ratio": keep_ratio, "interp": interp})


def crop(data, x, y, width, height):
    return _invoke("_image_crop", [data],
                   {"x0": x, "y0": y, "width": width, "height": height})


def random_crop(data, width, height):
    return _invoke("_image_random_crop", [data],
                   {"width": width, "height": height})


def to_tensor(data):
    return _invoke("_image_to_tensor", [data], {})


def normalize(data, mean=0.0, std=1.0):
    return _invoke("_image_normalize", [data], {"mean": mean, "std": std})


def flip_left_right(data):
    return _invoke("_image_flip_left_right", [data], {})


def flip_top_bottom(data):
    return _invoke("_image_flip_top_bottom", [data], {})


def random_flip_left_right(data):
    return _invoke("_image_random_flip_left_right", [data], {})


def random_flip_top_bottom(data):
    return _invoke("_image_random_flip_top_bottom", [data], {})


def _jitter(op):
    def fn(data, min_factor, max_factor):
        return _invoke(op, [data], {"min_factor": min_factor,
                                    "max_factor": max_factor})
    fn.__name__ = op[len("_image_"):]
    return fn


random_brightness = _jitter("_image_random_brightness")
random_contrast = _jitter("_image_random_contrast")
random_saturation = _jitter("_image_random_saturation")
random_hue = _jitter("_image_random_hue")


def random_lighting(data, alpha_std=0.05):
    return _invoke("_image_random_lighting", [data], {"alpha_std": alpha_std})


def swap_axis(data, dim1=0, dim2=2):
    return _invoke("_image_swap_axis", [data], {"dim1": dim1, "dim2": dim2})
