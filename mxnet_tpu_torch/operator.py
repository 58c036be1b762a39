"""Python operators: ``CustomOp``, ``CustomOpProp``, ``register`` and the
``Custom`` op (counterpart of ``mxnet_tpu/operator.py``, reference
``python/mxnet/operator.py:435`` and ``src/operator/custom/custom.cc``).

``mx.nd.Custom(*data, op_type=...)`` builds the registered prop, infers
the outputs' shapes and dtypes from it, and runs the user's
``CustomOp.forward`` eagerly on NDArrays; under ``autograd.record()`` the
call is one tape node whose backward runs ``CustomOp.backward``.  The
output and input-gradient arrays are allocated on the inputs' device, so
an op on the card computes there.  There is no ``mx.sym.Custom``, as in
the JAX package.
"""
from __future__ import annotations

from typing import Dict, List

__all__ = ["CustomOp", "CustomOpProp", "register", "get_prop"]

_PROPS: Dict[str, type] = {}


class CustomOp:
    """Base class of a Python operator (reference operator.py:435)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` as ``req`` says: ``"write"`` (or
        ``"inplace"``) replaces, ``"add"`` adds, ``"null"`` does nothing."""
        if req in ("null", None):
            return
        if req == "add":
            dst[:] = dst + src
        else:
            dst[:] = src


class CustomOpProp:
    """A Python operator's signature (reference operator.py:488)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self) -> List[str]:
        return ["data"]

    def list_outputs(self) -> List[str]:
        return ["output"]

    def list_auxiliary_states(self) -> List[str]:
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def create_operator(self, ctx, in_shapes, in_dtypes) -> CustomOp:
        raise NotImplementedError

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = list(out_grad) if self.need_top_grad_ else []
        return deps + list(in_data) + list(out_data)


def register(reg_name: str):
    """Class decorator: register a ``CustomOpProp`` as ``op_type``
    ``reg_name`` for ``mx.nd.Custom``."""

    def deco(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise TypeError("register() expects a CustomOpProp subclass")
        _PROPS[reg_name] = prop_cls
        return prop_cls

    return deco


def get_prop(op_type: str) -> type:
    try:
        return _PROPS[op_type]
    except KeyError:
        raise KeyError(f"custom op {op_type!r} is not registered; known: "
                       f"{sorted(_PROPS)}") from None


def _invoke_custom(inputs, op_type: str = "", **kwargs):
    """``mx.nd.Custom``: one ``autograd.Function`` node per call.  The
    last ``len(list_auxiliary_states())`` inputs are the aux states,
    passed to forward and backward as they are."""
    from . import autograd
    from .ndarray.ndarray import zeros

    prop = get_prop(op_type)(**kwargs)
    n_out = len(prop.list_outputs())
    n_aux = len(prop.list_auxiliary_states())
    data_in = list(inputs[:len(inputs) - n_aux])
    aux = list(inputs[len(data_in):])
    ctx = data_in[0].context
    in_shapes = [tuple(x.shape) for x in data_in]
    in_dtypes = [x.dtype for x in data_in]
    out_shapes = list(prop.infer_shape(in_shapes)[1])
    inferred = prop.infer_type(in_dtypes)
    out_dtypes = list(inferred[1]) if len(inferred) > 1 else in_dtypes
    op = prop.create_operator(ctx, in_shapes, in_dtypes)
    # read before the node runs: Function runs forward under pause(),
    # which clears the training flag
    is_train = autograd.is_training()

    class _CustomFn(autograd.Function):
        def forward(self, *ins):
            out_data = [zeros(s, ctx=ctx, dtype=dt)
                        for s, dt in zip(out_shapes, out_dtypes)]
            op.forward(is_train, ["write"] * n_out, list(ins), out_data, aux)
            self.save_for_backward(*ins, *out_data)
            return out_data[0] if n_out == 1 else tuple(out_data)

        def backward(self, *out_grads):
            saved = self.saved_tensors
            ins, outs = list(saved[:len(data_in)]), list(saved[len(data_in):])
            in_grad = [zeros(s, ctx=ctx, dtype=dt)
                       for s, dt in zip(in_shapes, in_dtypes)]
            op.backward(["write"] * len(ins), list(out_grads), ins, outs,
                        in_grad, aux)
            return in_grad[0] if len(in_grad) == 1 else tuple(in_grad)

    _CustomFn.__name__ = f"Custom[{op_type}]"
    return _CustomFn()(*data_in)
