"""``Block`` and ``HybridBlock`` (counterparts of ``mxnet_tpu/gluon/block.py``,
reference ``python/mxnet/gluon/block.py``).

A :class:`Block` is a ``torch.nn.Module``, so the port has one tree of
modules: children are the module's submodules, and each Gluon
:class:`~.parameter.Parameter` assigned as an attribute registers its tensor
as the module's ``nn.Parameter`` (or buffer), under the same name.
``block.weight`` is therefore the tensor, as the training slices use it,
and the Gluon handles are ``collect_params()`` (prefixed names, the
reference's ``_BlockScope`` naming) and ``_collect_params_with_prefix()``
(structural names, which ``save_parameters`` writes).

Calling a block with NDArrays is the Gluon boundary: the block runs with
torch's grad mode set from ``mx.autograd.is_recording()`` and every
module of its tree in training mode exactly when
``mx.autograd.is_training()`` (so BatchNorm uses batch statistics and
updates its moving ones only under ``record()``), on the NDArrays'
tensors, and returns NDArrays.  The parameters' NDArrays share the
modules' tensors (see ``parameter.py``), so ``backward`` reaches them.
Calling a block with tensors is plain PyTorch: ``module.training`` and
torch's grad mode decide.  The layers of the port compute on tensors; a
block whose ``forward`` is defined outside the port (a user's), and a
``HybridBlock`` that defines ``hybrid_forward(F, x, **params)`` (``F`` is
``mx.nd``), compute on NDArrays, whichever way they are called.

``hybridize()`` records that it was asked and changes nothing else: blocks
run eagerly (compiling a block waits for a later slice).
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict
from typing import Dict, Optional

import torch
from torch import nn

from .. import autograd
from .. import ndarray as _ndmod
from ..context import Context, cpu, resolve_device
from ..ndarray import ndarray as _nd
from ..ndarray.ndarray import NDArray
from .parameter import (DeferredInitializationError, Parameter, ParameterDict,
                        _shape_known)

__all__ = ["Block", "HybridBlock"]

_PACKAGE = __name__.split(".")[0] + "."
_tls = threading.local()


class _BlockScope:
    """Automatic prefix naming: a block made inside ``with
    parent.name_scope():`` is named ``parent.prefix + hint + count``; one
    made outside every scope takes a per-process count."""

    def __init__(self, block: "Block"):
        self._block = block
        self._counter: Dict[str, int] = {}
        self._old_scope = None

    @staticmethod
    def current() -> Optional["_BlockScope"]:
        return getattr(_tls, "scope", None)

    @staticmethod
    def create(prefix, params, hint):
        current = _BlockScope.current()
        if current is None:
            if prefix is None:
                prefix = f"{hint}{_global_count(hint)}_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = f"{hint}{count}_"
        parent = current._block
        if params is None:
            params = ParameterDict(parent.prefix + prefix,
                                   parent._params._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return parent.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_tls, "scope", None)
        _tls.scope = self
        return self

    def __exit__(self, *exc):
        if self._block._empty_prefix:
            return
        _tls.scope = self._old_scope


_global_counters: Dict[str, int] = {}


def _global_count(hint: str) -> int:
    c = _global_counters.get(hint, 0)
    _global_counters[hint] = c + 1
    return c


# ---------------------------------------------------------------------------
# NDArray <-> tensor at the boundary
# ---------------------------------------------------------------------------
def _first_ctx(args) -> Optional[Context]:
    for a in args:
        if isinstance(a, NDArray):
            return a.context
        if isinstance(a, (list, tuple)):
            c = _first_ctx(a)
            if c is not None:
                return c
    return None


def _to_tensors(x):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, (list, tuple)):
        return type(x)(_to_tensors(a) for a in x)
    return x


def _to_arrays(x, ctx):
    if isinstance(x, torch.Tensor):
        return NDArray(x, ctx)
    if isinstance(x, (list, tuple)):
        return type(x)(_to_arrays(a, ctx) for a in x)
    return x


def _tensor_ctx(args) -> Context:
    for a in args:
        if isinstance(a, torch.Tensor):
            return Context.of(a.device)
    return cpu()


class _TrainMode:
    """Every module of ``root``'s tree in training mode ``flag`` for the
    duration, restored after."""

    def __init__(self, root: nn.Module, flag: bool):
        self._modules = list(root.modules())
        self._flag = flag

    def __enter__(self):
        self._saved = [m.training for m in self._modules]
        for m in self._modules:
            m.training = self._flag

    def __exit__(self, *exc):
        for m, t in zip(self._modules, self._saved):
            m.training = t


def _boundary_ctx() -> Optional[Context]:
    stack = getattr(_tls, "nd_ctx", None)
    return stack[-1] if stack else None


class _HookHandle:
    def __init__(self, handle):
        self._handle = handle

    def detach(self):
        self._handle.remove()

    remove = detach


class Block(nn.Module):
    """Base of the Gluon layers: prefix naming, parameter registration,
    ``collect_params``, ``initialize``, saving and loading, ``cast`` and
    forward hooks, on ``torch.nn.Module``.  ``device`` (a port keyword)
    allocates the parameters whose shape is known when the block is made;
    without it they wait for ``initialize``."""

    _nd_forward = False

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if "forward" in cls.__dict__ and "_nd_forward" not in cls.__dict__:
            # a forward written outside the port computes on NDArrays
            cls._nd_forward = not cls.__module__.startswith(_PACKAGE)

    def __init__(self, prefix=None, params=None, device=None):
        super().__init__()
        self._device = None if device is None else resolve_device(device)
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = (self._prefix[:-1] if self._prefix.endswith("_")
                      else self._prefix)
        self._scope = _BlockScope(self)
        self._reg_params: "OrderedDict[str, Parameter]" = OrderedDict()
        self._deferred = []

    def _alias(self) -> str:
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    @property
    def params(self) -> ParameterDict:
        return self._params

    def name_scope(self):
        return self._scope

    # ------------------------------------------------------------ registration
    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self._register_param(name, value)
            return
        super().__setattr__(name, value)

    def _register_param(self, name: str, param: Parameter) -> None:
        t = param._bind(self, name, self._device)
        for table in (self._parameters, self._buffers):
            table.pop(name, None)
        self.__dict__.pop(name, None)
        if isinstance(t, nn.Parameter):
            self.register_parameter(name, t)
        else:
            self.register_buffer(name, t)
        self._reg_params[name] = param
        if not param._allocated():
            self._deferred.append(param)

    def register_child(self, block: "Block", name: Optional[str] = None):
        if name is None:
            name = str(len(self._modules))
        self.add_module(name, block)

    def _child_blocks(self):
        return [m for m in self._modules.values() if isinstance(m, Block)]

    def register_forward_pre_hook(self, hook):
        """``hook(block, args)`` before each forward; under the Gluon
        boundary ``args`` are NDArrays."""
        def wrapped(module, args):
            ctx = _boundary_ctx()
            hook(module, _to_arrays(args, ctx) if ctx else args)
        return _HookHandle(super().register_forward_pre_hook(wrapped))

    def register_forward_hook(self, hook):
        """``hook(block, args, out)`` after each forward; under the Gluon
        boundary ``args`` and ``out`` are NDArrays."""
        def wrapped(module, args, out):
            ctx = _boundary_ctx()
            if ctx:
                args, out = _to_arrays(args, ctx), _to_arrays(out, ctx)
            hook(module, args, out)
        return _HookHandle(super().register_forward_hook(wrapped))

    # ------------------------------------------------------------------ params
    def collect_params(self, select: Optional[str] = None) -> ParameterDict:
        """This block's and its children's parameters by full name; with
        ``select``, those whose name the regex matches from its start."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret._params.update({k: v for k, v in self.params.items()
                                if pattern.match(k)})
        for child in self._child_blocks():
            ret._params.update(child.collect_params(select)._params)
        return ret

    def _collect_params_with_prefix(self, prefix="") -> Dict[str, Parameter]:
        """Parameters by structural name (``features.0.weight``)."""
        if prefix:
            prefix += "."
        ret = {prefix + n: p for n, p in self._reg_params.items()}
        for name, child in self._modules.items():
            if isinstance(child, Block):
                ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter of the tree (see
        :meth:`ParameterDict.initialize`); ``ctx`` defaults to each
        tensor's device, else the current context (the card)."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)
        return self

    def save_parameters(self, filename, deduplicate=False):
        """Save the parameters under their structural names, in the
        reference's file format."""
        params = self._collect_params_with_prefix()
        _nd.save(filename, {name: p.data() for name, p in params.items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load a file of ``save_parameters`` (either package's) into the
        parameters in place; deferred ones take their shapes from it."""
        with cpu():
            loaded = _nd.load(filename)
        params = self._collect_params_with_prefix()
        if not isinstance(loaded, dict):
            raise ValueError("expected dict-style parameter file")
        if loaded and params and not any(k in params for k in loaded):
            # a file of collect_params().save(): strip this block's prefix
            prefix = self.prefix
            loaded = {k[len(prefix):] if k.startswith(prefix) else k: v
                      for k, v in loaded.items()}
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise IOError(f"parameter {name} missing in {filename}")
        for name, arr in loaded.items():
            if name not in params:
                if not ignore_extra:
                    raise IOError(f"parameter {name} in file not found in "
                                  "Block")
                continue
            p = params[name]
            if not p._allocated():
                p.shape = arr.shape
                p.initialize(ctx=ctx)
                p._finish_deferred_init()
            if cast_dtype and dtype_source == "saved":
                p.cast(arr.dtype)
            p.set_data(arr)

    def cast(self, dtype):
        """Cast the tree's parameters to ``dtype``; returns the block."""
        for child in self._child_blocks():
            child.cast(dtype)
        for p in self._reg_params.values():
            p.cast(dtype)
        return self

    def hybridize(self, active=True, **kwargs):
        for child in self._child_blocks():
            child.hybridize(active, **kwargs)

    # ----------------------------------------------------------------- forward
    def _shape_hint(self, *args):
        """Layers with deferred parameters set their shapes from the
        inputs here."""
        raise DeferredInitializationError(
            f"{type(self).__name__} cannot infer its parameter shapes; "
            "give in_units/in_channels")

    def _finish_deferred(self, *args):
        """Allocate the parameters that wait for this first forward."""
        pending = [p for p in self._deferred if not p._allocated()]
        if any(not _shape_known(p.shape) for p in pending):
            self._shape_hint(*args)
        for p in pending:
            p._finish_deferred_init()
        self._deferred = [p for p in pending if not p._allocated()]

    def __call__(self, *args, **kwargs):
        if self._deferred:
            self._finish_deferred(*args)
        ctx = _first_ctx(args)
        if ctx is not None:
            return self._call_gluon(ctx, args, kwargs)
        if self._nd_forward:
            ctx = _tensor_ctx(args)
            with autograd._RecordingState(torch.is_grad_enabled(),
                                          self.training):
                out = super().__call__(*_to_arrays(args, ctx), **kwargs)
            return _to_tensors(out)
        return super().__call__(*args, **kwargs)

    def _call_gluon(self, ctx: Context, args, kwargs):
        """The Gluon boundary (see the module docstring)."""
        stack = getattr(_tls, "nd_ctx", None)
        if stack is None:
            stack = _tls.nd_ctx = []
        stack.append(ctx)
        try:
            with torch.set_grad_enabled(autograd.is_recording()), \
                    _TrainMode(self, autograd.is_training()):
                if self._nd_forward:
                    return super().__call__(*args, **kwargs)
                out = super().__call__(*_to_tensors(args), **kwargs)
            return _to_arrays(out, ctx)
        finally:
            stack.pop()

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """A block that ``hybridize`` may compile (not yet: see the module
    docstring).  Subclasses define a tensor ``forward`` (the port's
    layers) or ``hybrid_forward(self, F, x, *args, **params)``, which gets
    ``F = mx.nd``, NDArrays, and each registered parameter's NDArray by
    name."""

    _active = False

    def hybridize(self, active=True, **kwargs):
        self._active = active
        super().hybridize(active, **kwargs)
        return self

    def input_signature(self):
        """``((shape, dtype), ...)`` of the NDArray inputs of the last
        NDArray call, or None before one."""
        return getattr(self, "_in_sig", None)

    def __call__(self, *args, **kwargs):
        if any(isinstance(a, NDArray) for a in args):
            self._in_sig = tuple((tuple(a.shape), str(a.dtype))
                                 for a in args if isinstance(a, NDArray))
        return super().__call__(*args, **kwargs)

    def forward(self, x, *args):
        """Tensors in, tensors out: ``hybrid_forward`` on NDArrays over
        them, recording when torch's grad mode is on."""
        ctx = Context.of(x.device)
        with autograd._RecordingState(torch.is_grad_enabled(),
                                      self.training):
            params = {name: p.data() for name, p in self._reg_params.items()}
            out = self.hybrid_forward(_ndmod, _to_arrays(x, ctx),
                                      *_to_arrays(args, ctx), **params)
        return _to_tensors(out)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
