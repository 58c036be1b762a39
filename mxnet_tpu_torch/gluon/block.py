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

Calling a block with Symbols composes a graph instead: a
``HybridBlock`` runs its reference-form ``hybrid_forward(F=mx.sym, x,
**param_vars)`` on variables named after its parameters, as the JAX
package's does, which is how :meth:`HybridBlock.export` writes the symbol
JSON that :class:`SymbolBlock` (of either package) loads.  The port's
layers keep their tensor ``forward`` as the path every tensor or NDArray
call takes; their ``hybrid_forward`` is the symbolic form.

``hybridize()`` routes the block's NDArray calls through a
:class:`~mxnet_tpu_torch.cached_op.CachedOp`, keyed per input signature:
on the card each entry replays CUDA graphs of the block (its forward, and
under ``record()`` its forward and backward), on the CPU it runs the
block eagerly.
"""
from __future__ import annotations

import json
import re
import sys
import threading
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .. import autograd
from .. import ndarray as _ndmod
from ..base import MXNetError
from ..cached_op import CachedOp
from ..context import Context, cpu, current_context, resolve_device
from ..ndarray import ndarray as _nd
from ..ndarray.ndarray import NDArray
from .parameter import (DeferredInitializationError, Parameter, ParameterDict,
                        _shape_known)

__all__ = ["Block", "HybridBlock", "SymbolBlock"]

_PACKAGE = __name__.split(".")[0] + "."
_SYMBOL_MODULE = _PACKAGE + "symbol.symbol"
_tls = threading.local()


def _is_symbol(x) -> bool:
    sym = sys.modules.get(_SYMBOL_MODULE)
    return sym is not None and isinstance(x, sym.Symbol)


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

    def register_op_hook(self, callback, monitor_all=False):
        """Install ``callback(name, array)`` on this block and every child
        (reference ``Block.register_op_hook``; the JAX package calls it at
        block boundaries too): after each forward, with the block's output
        (``<name>_output<i>`` when there are several, else the block's
        name), and first each input (``<name>_input<i>``) when
        ``monitor_all``.  Under the Gluon boundary the arrays are
        NDArrays.  A CUDA graph's capture and replays run no Python, so
        on the card a hybridized block's callback sees its eager calls
        only.  A second call replaces the hook."""
        for child in self._child_blocks():
            child.register_op_hook(callback, monitor_all)
        old = self.__dict__.get("_op_hook_handle")
        if old is not None:
            old.detach()

        def hook(block, args, out):
            if torch.cuda.is_available() and \
                    torch.cuda.is_current_stream_capturing():
                return
            if monitor_all:
                for i, a in enumerate(args):
                    callback(f"{block.name}_input{i}", a)
            outs = out if isinstance(out, (list, tuple)) else (out,)
            for i, o in enumerate(outs):
                callback(f"{block.name}_output{i}" if len(outs) > 1
                         else block.name, o)
        self.__dict__["_op_hook_handle"] = self.register_forward_hook(hook)

    def summary(self, *inputs):
        """Print and return one line per block of the tree (its name,
        class and the elements of its own parameters whose shape is
        known), then the total (the JAX package's form; ``inputs`` are
        accepted and not run)."""
        rows = []

        def walk(block, depth):
            n = sum(int(np.prod(p.shape)) for p in block._reg_params.values()
                    if _shape_known(p.shape))
            rows.append((depth, block.name, type(block).__name__, n))
            for child in block._child_blocks():
                walk(child, depth + 1)

        walk(self, 0)
        out = "\n".join(f"{'  ' * d}{name} ({cls}): {n} params"
                        for d, name, cls, n in rows)
        out += f"\nTotal params: {sum(r[3] for r in rows)}"
        print(out)
        return out

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
        if args and _is_symbol(args[0]):
            return self._call_symbol(*args, **kwargs)
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

    def _call_symbol(self, *args, **kwargs):
        """A call with Symbols: the forward composes the graph."""
        return self.forward(*args, **kwargs)

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """A block with a symbolic form.  Subclasses define a tensor
    ``forward`` (the port's layers) and ``hybrid_forward(self, F, x,
    *args, **params)``, or ``hybrid_forward`` alone, which then also
    serves NDArray and tensor calls with ``F = mx.nd``, NDArrays, and each
    registered parameter's NDArray by name.  With Symbols,
    ``hybrid_forward`` gets ``F = mx.sym`` and each parameter's
    variable."""

    _active = False
    _cached_op = None

    def hybridize(self, active=True, **kwargs):
        """Route NDArray calls through a CachedOp (``active``); the
        children run inside this block's entry, as in the JAX package,
        where only the outermost hybridized block compiles (a hybridized
        child called there runs inside its parent's graph and keeps no
        entry of its own).  The reference's flags (``static_alloc``,
        ``static_shape``, ...) become the CachedOp's ``flags``; they select
        nothing, since an entry on the card is a CUDA graph whatever they
        say."""
        self._active = active
        self._flags = kwargs
        self._cached_op = None
        return self

    def _eager_forward(self, *args):
        """The block's NDArray call without its CachedOp (what an entry
        runs, and what the serving engine caches)."""
        return Block.__call__(self, *args)

    def _call_symbol(self, *args, **kwargs):
        from .. import symbol as F
        if type(self).hybrid_forward is HybridBlock.hybrid_forward:
            raise MXNetError(f"{type(self).__name__} has no symbolic form "
                             "(no hybrid_forward)")
        params = {name: p.var() for name, p in self._reg_params.items()}
        return self.hybrid_forward(F, *args, **kwargs, **params)

    def export(self, path, epoch=0):
        """Write ``{path}-symbol.json`` (the traced graph, input
        ``data``), ``{path}-{epoch:04d}.params`` (``arg:``/``aux:`` keys by
        ``grad_req``, the shared ``.npz`` format) and, once an NDArray call
        captured the input signature, ``{path}-signature.json``, as
        ``mxnet_tpu/gluon/block.py:export`` does; returns the first two
        paths."""
        from ..symbol import trace_to_symbol
        sym = trace_to_symbol(self)
        sym.save(f"{path}-symbol.json")
        params = {f"{'aux' if p.grad_req == 'null' else 'arg'}:{name}":
                  p.data() for name, p in self.collect_params().items()}
        _nd.save(f"{path}-{epoch:04d}.params", params)
        sig = self.input_signature()
        if sig is not None:
            with open(f"{path}-signature.json", "w") as f:
                json.dump({"inputs": [{"shape": list(shape), "dtype": dt}
                                      for shape, dt in sig]}, f)
        return f"{path}-symbol.json", f"{path}-{epoch:04d}.params"

    def input_signature(self):
        """``((shape, dtype), ...)`` of the NDArray inputs of the last
        NDArray call, or None before one."""
        return getattr(self, "_in_sig", None)

    def __call__(self, *args, **kwargs):
        if any(isinstance(a, NDArray) for a in args):
            self._in_sig = tuple((tuple(a.shape), str(a.dtype))
                                 for a in args if isinstance(a, NDArray))
            if self._active and not kwargs:
                if self._cached_op is None:
                    self._cached_op = CachedOp(
                        self._eager_forward,
                        list(self.collect_params().values()),
                        flags=getattr(self, "_flags", {}))
                return self._cached_op(*args)
        return super().__call__(*args, **kwargs)

    def forward(self, x, *args, **kwargs):
        """Tensors in, tensors out: ``hybrid_forward`` on NDArrays over
        them, recording when torch's grad mode is on."""
        ctx = Context.of(x.device)
        with autograd._RecordingState(torch.is_grad_enabled(),
                                      self.training):
            params = {name: p.data() for name, p in self._reg_params.items()}
            out = self.hybrid_forward(
                _ndmod, _to_arrays(x, ctx), *_to_arrays(args, ctx),
                **{k: _to_arrays(v, ctx) for k, v in kwargs.items()},
                **params)
        return _to_tensors(out)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class SymbolBlock(HybridBlock):
    """A block over a loaded symbol and its parameters (reference
    ``gluon/block.py:SymbolBlock``): the forward binds the inputs by name
    (``inputs``) and each parameter by its variable's name, and walks the
    graph through the registry in predict mode, as the JAX package's
    does.  ``params`` maps ``arg:name``/``aux:name`` (or bare names) to
    NDArrays; each becomes a Parameter on the NDArray's device (``aux:``
    ones take no gradient)."""

    _nd_forward = True

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=None)
        self._sym_outputs = outputs
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        self._sym_inputs = [x if isinstance(x, str) else x.name
                            for x in inputs]
        for key, arr in (params or {}).items():
            aux = key.startswith("aux:")
            name = key[4:] if key.startswith(("arg:", "aux:")) else key
            p = Parameter(name, shape=arr.shape, dtype=str(arr.dtype),
                          grad_req="null" if aux else "write",
                          differentiable=not aux)
            self._params._params[name] = p
            self._device = arr.context.torch_device()
            self._register_param(name.replace(".", "_"), p)
            p.set_data(arr)

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock from an export's files, its parameters on
        ``ctx`` (default: the current context)."""
        from ..symbol import load as sym_load
        sym = sym_load(symbol_file)
        params = {}
        if param_file:
            with (ctx or current_context()):
                params = _nd.load(param_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        return SymbolBlock(sym, input_names, params)

    def forward(self, *args):
        bindings = dict(zip(self._sym_inputs, args))
        for name, p in self._params.items():
            bindings[name] = p.data()
        return self._sym_outputs.eval_with(bindings)
