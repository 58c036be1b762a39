"""Structured exception hierarchy (reference ``python/mxnet/error.py``).

Counterpart of ``mxnet_tpu/error.py``: a registry maps error *names* to
exception classes with the reference's public surface.  It also holds the
port's copies of the serving errors of ``mxnet_tpu/resilience/policy.py``
that the serving and resilience layers raise (overload, deadline,
backend down, a dead rank).  ``mxnet_tpu_torch.resilience`` re-exports
these very classes, so an ``except`` on either name catches both.
"""
from __future__ import annotations

from .base import MXNetError, RequestCancelledError, ServerClosedError

__all__ = ["MXNetError", "register_error", "register", "InternalError",
           "get_error_class", "OverloadedError", "DeadlineExceededError",
           "BackendUnavailableError", "ServerClosedError",
           "RequestCancelledError", "RankFailureError"]

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


@register_error
class BackendUnavailableError(MXNetError):
    """The backend (or one served model) is unavailable: its circuit
    breaker is open, or the retry budget gave up.  Unlike the JAX package,
    the port never degrades to the CPU instead of raising this."""


@register_error
class DeadlineExceededError(MXNetError, TimeoutError):
    """A request's deadline passed before it ran."""


@register_error
class OverloadedError(MXNetError):
    """Admission control refused the request (queue full); retry after
    ``retry_after_s`` seconds."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


@register_error
class RankFailureError(MXNetError):
    """A distributed collective did not complete within
    ``MXNET_KVSTORE_TIMEOUT``: a peer rank is dead or wedged."""


register_error("ServerClosedError", ServerClosedError)
register_error("RequestCancelledError", RequestCancelledError)
register_error("ValueError", ValueError)
register_error("TypeError", TypeError)
register_error("AttributeError", AttributeError)
register_error("IndexError", IndexError)
register_error("NotImplementedError", NotImplementedError)


def get_error_class(name: str):
    """Look up a registered error class; MXNetError when unknown."""
    return _ERROR_TYPES.get(name, MXNetError)
