"""Fluent-method codegen: ``x.exp()`` is ``nd.exp(x)`` (reference
``python/mxnet/ndarray/ndarray.py`` fluent block).  Counterpart of
``mxnet_tpu/_fluent.py``; names whose op is not ported are skipped."""
from __future__ import annotations

# reference fluent-method names (ndarray.py:1300-2350); every entry forwards
# to the registry op of the same name
FLUENT_OPS = [
    "reshape_like", "zeros_like", "ones_like", "broadcast_axes", "repeat",
    "pad", "swapaxes", "split", "split_v2", "slice", "slice_axis",
    "slice_like", "take", "one_hot", "pick", "sort", "topk", "argsort",
    "argmax", "argmax_channel", "argmin", "clip", "abs", "sign", "flatten",
    "shape_array", "size_array", "expand_dims", "tile", "transpose", "flip",
    "depth_to_space", "space_to_depth", "diag", "sum", "nansum", "prod",
    "nanprod", "mean", "max", "min", "norm", "round", "rint", "fix", "floor",
    "ceil", "trunc", "sin", "cos", "tan", "arcsin", "arccos", "arctan",
    "degrees", "radians", "sinh", "cosh", "tanh", "arcsinh", "arccosh",
    "arctanh", "exp", "expm1", "log", "log10", "log2", "log1p", "sqrt",
    "rsqrt", "cbrt", "rcbrt", "square", "reciprocal", "relu", "sigmoid",
    "softmax", "log_softmax", "softmin", "squeeze", "broadcast_to",
    "broadcast_like",
]


def attach_fluent(cls, op_module, names=None) -> None:
    """Attach forwarding methods for each op name available on
    ``op_module``; methods already defined on the class win."""
    for name in names if names is not None else FLUENT_OPS:
        if hasattr(cls, name):
            continue
        fn = getattr(op_module, name, None)
        if fn is None:
            continue

        def method(self, *args, _fn=fn, **kwargs):
            return _fn(self, *args, **kwargs)

        method.__name__ = name
        method.__qualname__ = f"{cls.__name__}.{name}"
        method.__doc__ = f"Fluent form of ``nd.{name}(self, ...)``."
        setattr(cls, name, method)
