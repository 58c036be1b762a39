"""``mx.sym``: :class:`Symbol` plus a composer for every registered op.

Counterpart of ``mxnet_tpu/symbol/__init__.py`` (the reference's
import-time codegen, ``python/mxnet/symbol/register.py``): each op of the
registry ``mx.nd`` is generated from becomes a function taking Symbols
and ``name=``.  A learnable input left out of ``FullyConnected``,
``Convolution``, ``BatchNorm``, ``LayerNorm`` or ``Embedding`` becomes a
variable named ``{node}_{suffix}``, as in the reference.
"""
from __future__ import annotations

import sys as _sys

from .. import ops as _ops  # noqa: F401  (registers the ops)
from ..ops import registry as _registry
from .symbol import (Executor, Group, NameManager, ResolvedName, Symbol,
                     Variable, invoke_symbol, load, load_json,
                     trace_to_symbol, var)

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "Executor", "trace_to_symbol", "invoke_symbol", "NameManager"]

# learnable inputs created as {node}_{suffix} variables when omitted
_AUTO_VAR_INPUTS = {
    "FullyConnected": ("weight", "bias"),
    "Convolution": ("weight", "bias"),
    "BatchNorm": ("gamma", "beta", "moving_mean", "moving_var"),
    "LayerNorm": ("gamma", "beta"),
    "Embedding": ("weight",),
}
_NO_BIAS_OPS = {"FullyConnected", "Convolution"}


def _with_auto_vars(op_name: str, args, kwargs, name):
    """``(args, name)`` with the missing trailing learnable inputs added
    as variables (and the node's name resolved once for them)."""
    suffixes = _AUTO_VAR_INPUTS.get(op_name)
    args = list(args)
    if suffixes is None or not args:
        return args, name
    if op_name in _NO_BIAS_OPS and str(kwargs.get("no_bias", False)) in \
            ("True", "1", "true"):
        suffixes = suffixes[:-1]
    if len(args) >= 1 + len(suffixes):
        return args, name
    name = ResolvedName(NameManager.resolve(name, op_name))
    for suffix in suffixes[len(args) - 1:]:
        args.append(var(f"{name}_{suffix}"))
    return args, name


def _make_sym_func(op: "_registry.Operator", op_name: str):
    canonical = op.name
    if op.nin is None or op.nin == 0:
        def fn(*args, name=None, **kwargs):
            if op.nin == 0 or not args:
                return invoke_symbol(op_name, [], kwargs, name=name)
            args, name = _with_auto_vars(canonical, args, kwargs, name)
            return invoke_symbol(op_name, [args], kwargs, name=name)
    else:
        def fn(*args, name=None, **kwargs):
            args, name = _with_auto_vars(canonical, args, kwargs, name)
            return invoke_symbol(op_name, args, kwargs, name=name)
    fn.__name__ = op_name
    fn.__qualname__ = op_name
    fn.__doc__ = op.doc
    return fn


_mod = _sys.modules[__name__]
for _name, _op in list(_registry.REGISTRY.items()):
    if not hasattr(_mod, _name):
        setattr(_mod, _name, _make_sym_func(_op, _name))
del _mod, _name, _op

from .._fluent import attach_fluent as _attach_fluent  # noqa: E402

_attach_fluent(Symbol, _sys.modules[__name__])

