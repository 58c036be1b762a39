"""Utility functions and NumPy-semantics scopes (counterpart of
``mxnet_tpu/util.py``; reference ``python/mxnet/util.py``).

On the reference, ``np_shape``/``np_array`` flip the backend between legacy
MXNet shape semantics (0 = unknown, no zero-size tensors) and NumPy
semantics.  torch tensors are NumPy-semantic always (zero-size and
zero-dim shapes just work), so the flags are state only: they exist, scope
and nest as the reference's do, and ``is_np_shape``/``is_np_array`` report
them.  ``get_gpu_count``, ``get_gpu_memory`` and
``get_cuda_compute_capability`` read the card through ``torch.cuda``.
"""
from __future__ import annotations

import functools
import os
import threading

__all__ = ["makedirs", "get_gpu_count", "get_gpu_memory",
           "get_cuda_compute_capability", "set_np_shape",
           "is_np_shape", "np_shape", "use_np_shape", "np_array", "is_np_array",
           "use_np_array", "use_np", "set_np", "reset_np", "set_module",
           "wraps_safely",
           "np_ufunc_legal_option", "wrap_np_unary_func", "wrap_np_binary_func"]

_state = threading.local()


def _flags():
    if not hasattr(_state, "np_shape"):
        _state.np_shape = False
        _state.np_array = False
    return _state


def makedirs(d):
    """mkdir -p (reference util.py:42)."""
    os.makedirs(os.path.expanduser(d), exist_ok=True)


def get_gpu_count():
    """The number of CUDA cards this process sees (reference util.py:52);
    0 without CUDA."""
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def get_gpu_memory(gpu_dev_id=0):
    """``(free, total)`` bytes of card ``gpu_dev_id``, from
    ``cudaMemGetInfo`` (``torch.cuda.mem_get_info``; reference
    util.py:87).  Raises MXNetError without such a card."""
    import torch
    from .base import MXNetError
    if not (torch.cuda.is_available()
            and 0 <= gpu_dev_id < torch.cuda.device_count()):
        raise MXNetError(f"gpu({gpu_dev_id}): no such CUDA card")
    free, total = torch.cuda.mem_get_info(gpu_dev_id)
    return free, total


def wraps_safely(wrapped, assigned=functools.WRAPPER_ASSIGNMENTS):
    """functools.wraps tolerant of partial metadata (reference util.py:243)."""
    present = [a for a in assigned if hasattr(wrapped, a)]
    return functools.wraps(wrapped, assigned=present)


def set_module(module):
    """Decorator overriding ``__module__`` for doc rendering
    (reference util.py:335)."""
    def deco(obj):
        if module is not None:
            obj.__module__ = module
        return obj
    return deco


# ------------------------------------------------------------- np_shape flag
def set_np_shape(active):
    """Turn NumPy shape semantics on/off, returning the previous state
    (reference util.py:65).  Always-on under the hood here; the flag is
    bookkeeping for parity scripts."""
    f = _flags()
    prev, f.np_shape = f.np_shape, bool(active)
    return prev


def is_np_shape():
    return _flags().np_shape


class _NumpyShapeScope:
    def __init__(self, active):
        self._active = active
        self._prev = None

    def __enter__(self):
        self._prev = set_np_shape(self._active)
        return self

    def __exit__(self, *exc):
        set_np_shape(self._prev)


def np_shape(active=True):
    """``with np_shape():`` scope (reference util.py:174)."""
    return _NumpyShapeScope(active)


def use_np_shape(func):
    """Decorate a function or class to run under np-shape semantics
    (reference util.py:254)."""
    if isinstance(func, type):
        import inspect
        for name, attr in list(func.__dict__.items()):
            # plain functions only: wrapping a staticmethod/classmethod
            # descriptor as a function would rebind it as an instance method
            if inspect.isfunction(attr) and not name.startswith("__"):
                setattr(func, name, use_np_shape(attr))
        return func

    @wraps_safely(func)
    def wrapped(*args, **kwargs):
        with np_shape(True):
            return func(*args, **kwargs)
    return wrapped


# ------------------------------------------------------------- np_array flag
def np_array(active=True):
    """``with np_array():`` scope (reference util.py:378)."""
    return _NumpyArrayScope(active)


class _NumpyArrayScope:
    def __init__(self, active):
        self._active = active
        self._prev = None

    def __enter__(self):
        f = _flags()
        self._prev, f.np_array = f.np_array, bool(self._active)
        return self

    def __exit__(self, *exc):
        _flags().np_array = self._prev


def is_np_array():
    return _flags().np_array


def use_np_array(func):
    """Decorate a function or class to run under np-array semantics
    (reference util.py:430)."""
    if isinstance(func, type):
        import inspect
        for name, attr in list(func.__dict__.items()):
            if inspect.isfunction(attr) and not name.startswith("__"):
                setattr(func, name, use_np_array(attr))
        return func

    @wraps_safely(func)
    def wrapped(*args, **kwargs):
        with np_array(True):
            return func(*args, **kwargs)
    return wrapped


def use_np(func):
    """use_np_shape + use_np_array combined (reference util.py:512)."""
    return use_np_shape(use_np_array(func))


def set_np(shape=True, array=True):
    """Module-level activation of NumPy semantics (reference util.py:700)."""
    if not shape and array:
        raise ValueError("NumPy-array semantics require NumPy-shape semantics")
    set_np_shape(shape)
    _flags().np_array = bool(array)


def reset_np():
    """Back to classic semantics flags (reference util.py:779)."""
    set_np(shape=False, array=False)


def get_cuda_compute_capability(ctx):
    """The compute capability of the card of ``ctx`` as major * 10 + minor
    (90 on an H100; reference util.py:787).  A context that is not a card
    raises ValueError."""
    import torch
    if ctx.device_type != "gpu":
        raise ValueError(f"Expecting a gpu context to get cuda compute "
                         f"capability, while received ctx {ctx}")
    major, minor = torch.cuda.get_device_capability(
        ctx.torch_device().index or 0)
    return major * 10 + minor


# ---------------------------------------------------------------------------
# numpy-ufunc kwarg validation (reference util.py:575-672): the np ufunc
# protocol carries kwargs (where/casting/order/dtype/subok) the ops do not
# implement — surface a clear TypeError / NotImplementedError instead of
# silently ignoring them.
# ---------------------------------------------------------------------------
_NP_UFUNC_DEFAULTS = {"where": True, "casting": "same_kind", "order": "K",
                      "dtype": None, "subok": True}


def np_ufunc_legal_option(key, value):
    """True when (key, value) is a recognized np-ufunc option combination."""
    if key == "where":
        return True
    if key == "casting":
        return value in ("no", "equiv", "safe", "same_kind", "unsafe")
    if key == "order":
        return isinstance(value, str)
    if key == "dtype":
        import numpy as _np
        names = {"int8", "uint8", "int32", "int64",
                 "float16", "float32", "float64"}
        return value in names or getattr(_np.dtype(value), "name", None) in names
    if key == "subok":
        return isinstance(value, bool)
    return False


def _check_ufunc_kwargs(fname, kwargs):
    for key, value in kwargs.items():
        if key not in _NP_UFUNC_DEFAULTS:
            raise TypeError(f"{key} is an invalid keyword to function {fname!r}")
        if value != _NP_UFUNC_DEFAULTS[key]:
            if np_ufunc_legal_option(key, value):
                raise NotImplementedError(
                    f"{key}={value} is not implemented yet for operator {fname}")
            raise TypeError(f"{key}={value} not understood for operator {fname}")


def wrap_np_unary_func(func):
    """Uniform ufunc-kwarg error handling for unary numpy-compat ops."""
    @wraps_safely(func)
    def wrapped(x, out=None, **kwargs):
        _check_ufunc_kwargs(func.__name__, kwargs)
        return func(x, out=out)
    return wrapped


def wrap_np_binary_func(func):
    """Uniform ufunc-kwarg error handling for binary numpy-compat ops."""
    @wraps_safely(func)
    def wrapped(x1, x2, out=None, **kwargs):
        _check_ufunc_kwargs(func.__name__, kwargs)
        return func(x1, x2, out=out)
    return wrapped
