"""``mx.nd`` namespace: NDArray plus a function for every registered op.

Counterpart of ``mxnet_tpu/ndarray/__init__.py`` (the reference's
import-time codegen, ``_init_op_module``, ``python/mxnet/base.py:730``).
``mx.nd.random`` is the sampler namespace, ``mx.nd.linalg``,
``mx.nd.contrib`` and ``mx.nd.image`` the op namespaces, ``mx.nd._internal``
every op by name and ``mx.nd.utils`` the creation routes; the sparse
arrays (``mx.nd.sparse``) are not ported yet (ROADMAP A15).
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
from . import contrib, image, linalg  # noqa: E402,F401

# ``_contrib_<x>`` ops also as mx.nd.contrib.<x> (after the loop above:
# they forward to its functions)
contrib._codegen_contrib_namespace()
from . import _internal  # noqa: E402,F401
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


def _nd_tostype(self, stype):
    """The array in storage type ``stype``: only ``"default"`` (itself) is
    ported; ``row_sparse`` and ``csr`` wait for ROADMAP A15."""
    if stype == "default":
        return self
    from ..base import MXNetError
    raise MXNetError(f"tostype({stype!r}): the sparse arrays are not ported "
                     "yet (ROADMAP A15)")


def Custom(*data, op_type: str = "", **kwargs):
    """Run the Python operator registered as ``op_type`` with
    ``mx.operator.register`` (reference ``src/operator/custom/custom.cc``);
    it runs eagerly, one tape node per call."""
    from ..operator import _invoke_custom
    return _invoke_custom(list(data), op_type=op_type, **kwargs)


def moveaxis(tensor, source, destination):
    """Move axes to new positions (reference ndarray.py moveaxis)."""
    nd = tensor.ndim

    def _norm(ax):
        ax = (ax,) if isinstance(ax, int) else tuple(ax)
        return tuple(a % nd for a in ax)

    src, dst = _norm(source), _norm(destination)
    if len(src) != len(dst):
        raise ValueError("source and destination must have the same length")
    order = [a for a in range(nd) if a not in src]
    for d, s in sorted(zip(dst, src)):
        order.insert(d, s)
    return invoke("transpose", [tensor], {"axes": tuple(order)})


def linspace(start, stop, num, endpoint=True, ctx=None, dtype="float32"):
    """``num`` evenly spaced values (computed in float64 on the host, as
    the JAX package does, then cast)."""
    import numpy as _onp
    return array(_onp.linspace(start, stop, num, endpoint=endpoint).astype(
        dtype), ctx=ctx)


def eye(N, M=0, k=0, ctx=None, dtype="float32"):
    """An N x M (N x N when M is 0) array with ones on diagonal ``k``."""
    import numpy as _onp
    return array(_onp.eye(N, M if M else None, k, dtype=dtype), ctx=ctx)


def onehot_encode(indices, out):
    """One-hot rows of ``indices`` written into ``out`` (its width is the
    depth; reference ndarray.py onehot_encode)."""
    return invoke("one_hot", [indices], {"depth": out.shape[1]}, out=out)


def imdecode(str_img, clip_rect=(0, 0, 0, 0), out=None, index=0, channels=3,
             mean=None):
    """Decode an image byte string (the legacy form of
    ``mx.image.imdecode``), minus ``mean``, cropped to ``clip_rect``
    (x0, y0, x1, y1) when it is set."""
    from .. import image as _image
    img = _image.imdecode(str_img, flag=1 if channels == 3 else 0)
    if mean is not None:
        img = img.astype("float32") - mean
    x0, y0, x1, y1 = clip_rect
    if x1 > 0 and y1 > 0:
        img = img[y0:y1, x0:x1]
    if out is not None:
        out[:] = img.reshape(out.shape)
        return out
    return img


def load_frombuffer(buf):
    """Load NDArrays from the bytes of a file ``save`` wrote."""
    import io as _io
    return load(_io.BytesIO(bytes(buf)))


def from_numpy(ndarray, zero_copy=True):
    """An NDArray from a numpy array on the current context.  It is a
    copy, as in the JAX package: the port's width policy (float64 ->
    float32, int64 -> int32) rewrites the buffer, and the default context
    is the card."""
    return array(ndarray)


# DLPack (reference ndarray.py to_dlpack_for_read/_write, from_dlpack)
def to_dlpack_for_read(data):
    """A DLPack capsule over the array's buffer, for a reader."""
    from torch.utils import dlpack as _dlpack
    return _dlpack.to_dlpack(data._data.detach())


def to_dlpack_for_write(data):
    """A DLPack capsule over the array's buffer itself: what the consumer
    writes there, the array holds (the reference's meaning, which the JAX
    package, whose buffers are immutable, cannot give).  An operation that
    rebinds the array's buffer afterwards (``x += 1``, ``x[:] = v``)
    leaves the capsule on the old one."""
    from torch.utils import dlpack as _dlpack
    data.wait_to_read()
    return _dlpack.to_dlpack(data._data.detach())


def from_dlpack(dlpack):
    """An NDArray over a DLPack capsule's (or a ``__dlpack__`` object's)
    memory, without a copy."""
    from torch.utils import dlpack as _dlpack
    return NDArray(_dlpack.from_dlpack(dlpack))


NDArray.tostype = _nd_tostype
NDArray.to_dlpack_for_read = to_dlpack_for_read
NDArray.to_dlpack_for_write = to_dlpack_for_write

from . import utils  # noqa: E402,F401  (mx.nd.utils)
