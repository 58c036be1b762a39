"""Operator registry.

Counterpart of ``mxnet_tpu/ops/registry.py``.  An op is a function over
``torch.Tensor`` operands; shapes and dtypes come from running it, and
gradients from torch autograd, or from the op's own ``grad`` where it
registers one (the reference's FGradient).  The ``mx.nd`` namespace is
generated from this registry (``ndarray/__init__.py``).
"""
from __future__ import annotations

import functools
import inspect
from typing import Callable, Dict, List, Optional, Sequence

__all__ = ["Operator", "register", "get", "list_ops", "alias", "REGISTRY",
           "OpNamespace"]

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
    mutates : indices of inputs that the front end writes results back
        into (the reference's FMutateInputs; no op of the JAX package
        declares any).
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
                 grad: Optional[Callable] = None,
                 mutates: Sequence[int] = (), doc: str = ""):
        self.name = name
        self.fn = fn
        self.nin = nin
        self.nout = nout
        self.differentiable = differentiable
        self.grad = grad
        self.mutates = tuple(mutates)
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
             mutates: Sequence[int] = (), aliases=()):
    """Decorator: register a function over torch tensors as an op.

    nin: int = fixed arity; None = variadic (fn's first arg is a list of
    tensors); "auto" = the signature's leading default-less params."""

    def deco(fn: Callable) -> Callable:
        if name in REGISTRY:
            raise ValueError(f"op {name!r} already registered")
        REGISTRY[name] = Operator(
            name, fn, nin=_arity(fn) if nin == "auto" else nin, nout=nout,
            differentiable=differentiable, grad=grad, mutates=mutates)
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


class OpNamespace:
    """The op functions that the Gluon layers' tensor ``forward``s call
    (``ops.F``), each one wrapped so that its positional tensor inputs are
    cast as the AMP policy in force says for its op
    (``contrib.amp.amp.autocast_arrays``); while AMP is off the wrapper
    calls the function as it is.  This is where the layers cast, as the
    JAX package's layers cast in ``invoke``, which the port's tensor
    ``forward``s do not pass through.

    An attribute is the function of that name in ``modules`` (first
    module first), else the function of the op registered under that
    name.  Its op is the one registered with that very function, else the
    one registered under the attribute's name, else ``names[attr]``; an
    attribute with no op raises, so that no layer calls an op past the
    casts."""

    def __init__(self, *modules, names: Optional[Dict[str, str]] = None):
        self._modules = modules
        self._names = dict(names or {})

    def __getattr__(self, attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        home = next((m for m in self._modules if hasattr(m, attr)), None)
        fn = getattr(home, attr) if home is not None else (
            REGISTRY[attr].fn if attr in REGISTRY else None)
        name = next((op.name for op in REGISTRY.values() if op.fn is fn),
                    None)
        if name is None:
            name = (REGISTRY[attr].name if attr in REGISTRY
                    else self._names.get(attr))
        if fn is None or name is None:
            raise AttributeError(f"ops.F.{attr}: no op function of that "
                                 "name implements a registered op")
        wrapped = _autocasting(name, fn, home, attr)
        setattr(self, attr, wrapped)
        return wrapped


def _autocasting(op_name: str, fn: Callable, home, attr: str) -> Callable:
    """``fn`` casting its positional tensor inputs for ``op_name`` under
    AMP.  A module's function is looked up in ``home`` at each call, so
    that a patched module function is the one that runs."""
    from ..contrib.amp import amp

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if amp._state["active"]:
            args = amp.autocast_arrays(op_name, list(args))
        return (fn if home is None else getattr(home, attr))(*args, **kwargs)

    return call


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
