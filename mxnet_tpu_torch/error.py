"""Structured exception hierarchy (reference ``python/mxnet/error.py``).

Counterpart of ``mxnet_tpu/error.py``: a registry maps error *names* to
exception classes with the reference's public surface.
"""
from __future__ import annotations

from .base import MXNetError

__all__ = ["MXNetError", "register_error", "register", "InternalError",
           "get_error_class"]

_ERROR_TYPES = {}


def register_error(func_name=None, cls=None):
    """Register an error class keyed by name (reference error.py
    ``register_error``).

    Usable as ``@register_error`` on a class, or as
    ``register_error("ValueError", ValueError)``.
    """
    if callable(func_name) and cls is None:  # bare decorator
        klass = func_name
        _ERROR_TYPES[klass.__name__] = klass
        return klass
    if cls is not None:
        _ERROR_TYPES[func_name] = cls
        return cls

    def deco(klass):
        _ERROR_TYPES[func_name or klass.__name__] = klass
        return klass
    return deco


register = register_error


@register_error
class InternalError(MXNetError):
    """Framework-internal invariant violation (reference error.py:31)."""


register_error("ValueError", ValueError)
register_error("TypeError", TypeError)
register_error("AttributeError", AttributeError)
register_error("IndexError", IndexError)
register_error("NotImplementedError", NotImplementedError)


def get_error_class(name: str):
    """Look up a registered error class; MXNetError when unknown."""
    return _ERROR_TYPES.get(name, MXNetError)
