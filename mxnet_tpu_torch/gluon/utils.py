"""Gluon utilities (counterpart of ``mxnet_tpu/gluon/utils.py``, reference
``python/mxnet/gluon/utils.py``): ``split_data``, ``split_and_load``,
``clip_global_norm`` over NDArrays (the Trainer clips on its own),
``check_sha1``, ``download``, ``shape_is_known``, ``HookHandle`` and
``replace_file``.

``download`` fetches nothing: a path that exists (with the given sha1)
is returned as it is, a ``file://`` URL is copied, anything else raises
``IOError``, as in the JAX package.  The port has no numpy-shape mode, so
``shape_is_known`` takes the classic convention (0 is an unknown
dimension; an empty shape is unknown).
"""
from __future__ import annotations

import hashlib
import os
import shutil
import warnings
from typing import List

import numpy as np

from ..context import Context
from ..ndarray import ndarray as _nd
from ..ndarray.ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download", "shape_is_known", "HookHandle", "replace_file"]


def split_data(data: NDArray, num_slice: int, batch_axis=0,
               even_split=True) -> List[NDArray]:
    """``num_slice`` slices of ``data`` along ``batch_axis``; the last one
    takes the remainder unless ``even_split`` asks for equal slices."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(f"batch size {size} not divisible by {num_slice}")
    if num_slice == 1:
        return [data]
    step = size // num_slice
    return [_nd.invoke("slice_axis", [data],
                       {"axis": batch_axis, "begin": i * step,
                        "end": (i + 1) * step if i < num_slice - 1
                        else size})
            for i in range(num_slice)]


def split_and_load(data, ctx_list: List[Context], batch_axis=0,
                   even_split=True) -> List[NDArray]:
    """:func:`split_data`, each slice on its context."""
    if not isinstance(data, NDArray):
        data = _nd.array(data)
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays: List[NDArray], max_norm: float,
                     check_isfinite=True) -> float:
    """Scale ``arrays`` in place so their joint L2 norm is at most
    ``max_norm``; returns the norm before scaling (a host float: each
    array's sum of squares is read back)."""
    assert len(arrays) > 0
    total = 0.0
    for a in arrays:
        total += float(_nd.invoke("sum", [a * a], {}).asnumpy())
    total_norm = float(np.sqrt(total))
    if check_isfinite and not np.isfinite(total_norm):
        warnings.warn("nan or inf in gradient norm")
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        for a in arrays:
            a *= scale
    return total_norm


def check_sha1(filename, sha1_hash) -> bool:
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """The local file for ``url``: ``path`` (or the URL's file name in a
    directory ``path``) when it exists and matches ``sha1_hash``; a
    ``file://`` URL copied there; otherwise ``IOError`` (nothing is
    fetched over a network)."""
    fname = path or url.split("/")[-1]
    if os.path.isdir(fname):
        fname = os.path.join(fname, url.split("/")[-1])
    if os.path.exists(fname) and not overwrite and \
            (not sha1_hash or check_sha1(fname, sha1_hash)):
        return fname
    if url.startswith("file://"):
        shutil.copyfile(url[7:], fname)
        return fname
    raise IOError(f"cannot download {url}: nothing is fetched over a "
                  "network; place the file locally and pass its path")


def shape_is_known(shape) -> bool:
    """True when every dimension of ``shape`` is known (classic
    convention: 0 is unknown, and so is an empty shape)."""
    if shape is None or len(shape) == 0:
        return False
    return all(d != 0 for d in shape)


class HookHandle:
    """Attach/detach handle over a dict of hooks (reference
    ``gluon/utils.py`` ``HookHandle``); blocks return their own handles."""

    _next_id = [0]

    def __init__(self):
        self._hooks_dict = None
        self._id = None

    def attach(self, hooks_dict, hook):
        assert self._hooks_dict is None, \
            "The same handle cannot be attached twice."
        # a running key, not id(hook): two handles of one callable differ
        HookHandle._next_id[0] += 1
        self._id = HookHandle._next_id[0]
        hooks_dict[self._id] = hook
        self._hooks_dict = hooks_dict

    def detach(self):
        if self._hooks_dict is not None and self._id in self._hooks_dict:
            del self._hooks_dict[self._id]
        self._hooks_dict = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.detach()


def replace_file(src, dst):
    """Move ``src`` onto ``dst`` atomically (``os.replace``)."""
    os.replace(src, dst)
