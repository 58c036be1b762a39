"""``mx.nd`` namespace: NDArray plus a function for every registered op.

Counterpart of ``mxnet_tpu/ndarray/__init__.py`` (the reference's
import-time codegen, ``_init_op_module``, ``python/mxnet/base.py:730``).
``mx.nd.random`` is the sampler namespace; the ``sparse``, ``linalg``,
``contrib`` and ``image`` submodules are not ported yet.
"""
from __future__ import annotations

import sys as _sys

from .. import ops as _ops  # noqa: F401  (registers the ops)
from ..ops import registry as _registry
from .ndarray import (NDArray, invoke, array, zeros, ones, empty, full,
                      arange, concatenate, save, load, waitall)


def _make_op_func(op: "_registry.Operator", name: str):
    if op.nin is None or op.nin == 0:
        def fn(*args, out=None, **kwargs):
            if op.nin == 0 or not args:
                return invoke(op, [], kwargs, out=out)
            # variadic: positional arrays become the group input
            return invoke(op, [list(args)], kwargs, out=out)
    else:
        def fn(*args, out=None, **kwargs):
            return invoke(op, list(args), kwargs, out=out)
    fn.__name__ = name
    fn.__qualname__ = name
    fn.__doc__ = op.doc
    return fn


# (``_this``, not ``_mod``: the loop must not hide the op ``_mod``)
_this = _sys.modules[__name__]
for _name, _op in list(_registry.REGISTRY.items()):
    if not hasattr(_this, _name):
        setattr(_this, _name, _make_op_func(_op, _name))
del _this, _name, _op

from . import random  # noqa: E402,F401  (mx.nd.random)
from .._fluent import attach_fluent as _attach_fluent  # noqa: E402

_attach_fluent(NDArray, _sys.modules[__name__])


def _nd_slice_assign(self, rhs, begin, end, step=()):
    """Write ``rhs`` into ``self[begin:end:step]`` (reference ndarray.py
    slice_assign over ``_slice_assign``)."""
    out = invoke("_slice_assign", [self, rhs],
                 {"begin": begin, "end": end, "step": step})
    self._set_data(out._data)
    return self


def _nd_slice_assign_scalar(self, value, begin, end, step=()):
    out = invoke("_slice_assign_scalar", [self],
                 {"scalar": value, "begin": begin, "end": end, "step": step})
    self._set_data(out._data)
    return self


NDArray.slice_assign = _nd_slice_assign
NDArray.slice_assign_scalar = _nd_slice_assign_scalar


# module-level arithmetic (reference ndarray.py add/subtract/...): scalar
# operands go to the *_scalar ops, as NDArray's operators do
def _module_binop(dunder, doc):
    def fn(lhs, rhs):
        if isinstance(lhs, NDArray):
            return getattr(lhs, f"__{dunder}__")(rhs)
        if isinstance(rhs, NDArray):
            return getattr(rhs, f"__r{dunder}__")(lhs)
        raise TypeError("add/subtract/... need at least one NDArray operand")
    fn.__name__ = doc
    fn.__doc__ = f"Element-wise broadcast {doc} (reference mx.nd.{doc})."
    return fn


add = _module_binop("add", "add")
subtract = _module_binop("sub", "subtract")
multiply = _module_binop("mul", "multiply")
divide = _module_binop("truediv", "divide")
true_divide = divide
modulo = _module_binop("mod", "modulo")
power = _module_binop("pow", "power")


def maximum(lhs, rhs):
    """Element-wise broadcast maximum (reference mx.nd.maximum)."""
    if isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
        return invoke("broadcast_maximum", [lhs, rhs], {})
    if isinstance(lhs, NDArray):
        return invoke("_maximum_scalar", [lhs], {"scalar": rhs})
    return invoke("_maximum_scalar", [rhs], {"scalar": lhs})


def minimum(lhs, rhs):
    """Element-wise broadcast minimum (reference mx.nd.minimum)."""
    if isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
        return invoke("broadcast_minimum", [lhs, rhs], {})
    if isinstance(lhs, NDArray):
        return invoke("_minimum_scalar", [lhs], {"scalar": rhs})
    return invoke("_minimum_scalar", [rhs], {"scalar": lhs})
