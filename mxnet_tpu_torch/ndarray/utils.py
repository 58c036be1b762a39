"""``mx.nd.utils`` (counterpart of ``mxnet_tpu/ndarray/utils.py``,
reference ``python/mxnet/ndarray/utils.py``): creation that routes on the
storage type, and save/load.  Only the dense storage type is ported; the
``row_sparse`` and ``csr`` routes, and ``scipy.sparse`` input, raise until
the sparse arrays exist (ROADMAP A15)."""
from __future__ import annotations

from ..base import MXNetError
from .ndarray import array as _dense_array, load, save  # noqa: F401
from .ndarray import zeros as _dense_zeros, empty as _dense_empty
from . import load_frombuffer  # noqa: F401

__all__ = ["zeros", "empty", "array", "load", "save", "load_frombuffer"]


def _dense_only(stype, what):
    if stype not in (None, "default"):
        raise MXNetError(f"{what}: stype {stype!r} needs the sparse arrays, "
                         "which are not ported yet (ROADMAP A15)")


def zeros(shape, ctx=None, dtype=None, stype=None, **kwargs):
    _dense_only(stype, "zeros")
    return _dense_zeros(shape, ctx=ctx, dtype=dtype or "float32")


def empty(shape, ctx=None, dtype=None, stype=None):
    _dense_only(stype, "empty")
    return _dense_empty(shape, ctx=ctx, dtype=dtype or "float32")


def array(source_array, ctx=None, dtype=None):
    """A dense array from any array-like; a ``scipy.sparse`` matrix
    raises (ROADMAP A15)."""
    if type(source_array).__module__.startswith("scipy.sparse"):
        raise MXNetError("array: scipy.sparse input needs the sparse "
                         "arrays, which are not ported yet (ROADMAP A15)")
    return _dense_array(source_array, ctx=ctx, dtype=dtype)
