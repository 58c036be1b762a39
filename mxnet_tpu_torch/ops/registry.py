"""Operator registry.

Counterpart of ``mxnet_tpu/ops/registry.py``.  An op is a function over
``torch.Tensor`` operands; shapes and dtypes come from running it, and
gradients from torch autograd, or from the op's own ``grad`` where it
registers one (the reference's FGradient).  The ``mx.nd`` namespace is
generated from this registry (``ndarray/__init__.py``).
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict, List, Optional

__all__ = ["Operator", "register", "get", "list_ops", "alias", "REGISTRY"]

REGISTRY: Dict[str, "Operator"] = {}


class Operator:
    """A registered operator.

    Attributes
    ----------
    name : canonical op name.
    fn : ``fn(*tensors, **params) -> tensor | tuple`` over torch tensors.
    nin : number of tensor inputs; None for variadic (first arg is a list);
        0 for creation ops, which take the target ``device`` as a param.
    nout : number of outputs.
    differentiable : participates in autograd (False: outputs are
        constants).
    grad : optional custom gradient
        ``grad(params, inputs, outputs, out_grads) -> in_grads``.
    takes_training : the op takes ``_training`` (BatchNorm, Dropout), which
        :func:`~mxnet_tpu_torch.ndarray.ndarray.invoke` sets from
        ``autograd.is_training()``.
    needs_rng : the op takes ``generator``, the device's ``mx.random``
        stream unless the caller passes one.
    infer_shapes : optional ``infer_shapes(shapes, params) -> shapes`` that
        fills the unknown shapes of an op's variable inputs (weight, bias)
        from its data input, for ``Symbol.infer_shape``.
    """

    def __init__(self, name: str, fn: Callable, *, nin: Optional[int] = None,
                 nout: int = 1, differentiable: bool = True,
                 grad: Optional[Callable] = None, doc: str = ""):
        self.name = name
        self.fn = fn
        self.nin = nin
        self.nout = nout
        self.differentiable = differentiable
        self.grad = grad
        params = inspect.signature(fn).parameters
        self.takes_training = "_training" in params
        self.needs_rng = "generator" in params
        self.infer_shapes: Optional[Callable] = None
        self.doc = doc or (fn.__doc__ or "")
        self.aliases: List[str] = []

    def __call__(self, *arrays, **params):
        return self.fn(*arrays, **params)

    def __repr__(self):
        return f"<Operator {self.name}>"


def _arity(fn: Callable) -> Optional[int]:
    """Fixed arity from the signature's leading default-less parameters;
    None when ``fn`` takes ``*args``."""
    n = 0
    for p in inspect.signature(fn).parameters.values():
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            return None
        if p.default is not p.empty or p.kind not in (
                p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            break
        n += 1
    return n


def register(name: str, *, nin="auto", nout: int = 1,
             differentiable: bool = True, grad: Optional[Callable] = None,
             aliases=()):
    """Decorator: register a function over torch tensors as an op.

    nin: int = fixed arity; None = variadic (fn's first arg is a list of
    tensors); "auto" = the signature's leading default-less params."""

    def deco(fn: Callable) -> Callable:
        if name in REGISTRY:
            raise ValueError(f"op {name!r} already registered")
        REGISTRY[name] = Operator(
            name, fn, nin=_arity(fn) if nin == "auto" else nin, nout=nout,
            differentiable=differentiable, grad=grad)
        for a in aliases:
            alias(name, a)
        return fn

    return deco


def alias(name: str, alias_name: str) -> None:
    op = REGISTRY[name]
    op.aliases.append(alias_name)
    REGISTRY[alias_name] = op


def get(name: str) -> Operator:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"operator {name!r} is not registered; known: "
                       f"{len(REGISTRY)} ops") from None


def list_ops() -> List[str]:
    return sorted(REGISTRY.keys())


def expose_contrib_namespace(contrib_mod, parent_mod) -> None:
    """Surface every ``_contrib_<x>`` registration as ``<x>`` on
    ``contrib_mod``, forwarding to the generated function on
    ``parent_mod`` (the reference's ``_init_op_module`` contrib split,
    ``python/mxnet/base.py:730``).  Shared by ``mx.nd.contrib`` and
    ``mx.sym.contrib``; a name ``contrib_mod`` defines itself wins.  The
    names are looked up in the module's ``__dict__``: ``hasattr`` would
    run its ``__getattr__``, which makes a second function."""
    defined = vars(contrib_mod)
    for full_name in list(REGISTRY):
        if not full_name.startswith("_contrib_"):
            continue
        short = full_name[len("_contrib_"):]
        if short in defined:
            continue
        fn = getattr(parent_mod, full_name, None)
        if fn is not None:
            setattr(contrib_mod, short, fn)


def resolve_contrib_late(contrib_mod, name: str, maker):
    """The body of a contrib namespace's ``__getattr__``: a function for
    an op registered after import (``maker(op, full_name)``), kept on the
    module, or AttributeError."""
    full = "_contrib_" + name
    if full in REGISTRY:
        fn = maker(get(full), full)
        setattr(contrib_mod, name, fn)
        return fn
    raise AttributeError(f"{contrib_mod.__name__} has no op {name!r}")
