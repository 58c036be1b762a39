"""Gluon parameters: ``Parameter``, ``Constant``, ``ParameterDict`` and
``DeferredInitializationError`` (counterparts of
``mxnet_tpu/gluon/parameter.py``, reference
``python/mxnet/gluon/parameter.py``).

A :class:`Parameter` is a handle over one torch tensor: the
``nn.Parameter`` of the block it is assigned to, or the block's buffer
when it is not differentiable (BatchNorm's moving statistics), so
``state_dict()``, ``parameters()`` and ``CompiledTrainStep`` see the same
tensors as ``collect_params()``.  A shape with an unknown (0) dimension
makes an ``UninitializedParameter`` (``UninitializedBuffer``) that the
first forward materialises, on the device and in the dtype that
:meth:`Parameter.initialize` named.  A block built with a ``device``
allocates the tensors whose shape it knows at once; the others wait for
``initialize``.

:meth:`Parameter.data` is an NDArray whose tensor *is* the module's
tensor, marked as an autograd variable: a forward under
``mx.autograd.record()`` records onto it, ``backward`` writes
:meth:`Parameter.grad`, and every write through it (``set_data``, the
optimizer's update, ``data()[:] = v``) goes into the module's storage in
place, so the module and the Gluon handle never part.
"""
from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from .. import initializer
from ..base import MXNetError, dtype_torch, numpy_dtype
from ..context import Context, cpu, current_context
from ..ndarray import ndarray as _nd
from ..ndarray.ndarray import NDArray

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict"]


class DeferredInitializationError(MXNetError):
    """A parameter was read before its shape was known."""


def _shape_known(shape) -> bool:
    return shape is not None and all(s > 0 for s in shape)


def _uninitialized(t) -> bool:
    return isinstance(t, nn.parameter.UninitializedTensorMixin)


class _ParamArray(NDArray):
    """The NDArray of a parameter: its tensor is the module's, and a write
    goes into that storage instead of rebinding the array."""

    __slots__ = ()

    def _set_data(self, new: torch.Tensor) -> None:
        with torch.no_grad():
            self._data.copy_(new)
        self._version += 1


def _as_ctx(ctx) -> List[Context]:
    if ctx is None:
        return None
    return [ctx] if isinstance(ctx, Context) else list(ctx)


class Parameter:
    """A named, shaped tensor with its gradient settings.  ``grad_req`` is
    ``'write'``, ``'add'`` or ``'null'``; ``lr_mult`` and ``wd_mult`` scale
    the optimizer's rate and decay for it; ``init`` is its own
    initializer, which wins over the one given to ``initialize``."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        if stype != "default" or grad_stype != "default":
            raise MXNetError(f"{name}: sparse parameters are not ported")
        self.name = name
        self._grad_req = grad_req if differentiable else "null"
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = tuple(shape) if shape is not None else None
        self._dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self._allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._stype = stype
        self._grad_stype = grad_stype
        self._t: Optional[torch.Tensor] = None
        self._owner = None           # (weakref to the block, attribute)
        self._nd: Optional[_ParamArray] = None
        self._grad: Optional[NDArray] = None
        self._deferred_init = ()
        self._ctx_list: Optional[List[Context]] = None
        self._initialized = False

    # ------------------------------------------------------------ the tensor
    def _make_tensor(self, device=None) -> torch.Tensor:
        """The tensor this parameter registers on its block: allocated on
        ``device`` when that and the shape are known (constant
        initializers applied at once), else uninitialised."""
        dt = dtype_torch(self._dtype)
        if device is not None and _shape_known(self._shape):
            t = torch.empty(self._shape, dtype=dt, device=device)
            init = None if self.init is None else initializer.create(
                self.init)
            if isinstance(init, (initializer.Zero, initializer.One,
                                 initializer.Constant)):
                init._fill(initializer.InitDesc(self.name), t, None)
            if self._differentiable:
                t = nn.Parameter(t, requires_grad=self._grad_req != "null")
            return t
        if self._differentiable:
            return nn.parameter.UninitializedParameter(
                requires_grad=self._grad_req != "null", dtype=dt)
        return nn.parameter.UninitializedBuffer(dtype=dt)

    def _bind(self, block, attr: str, device=None) -> torch.Tensor:
        """The tensor to register as ``block.<attr>``; the first block a
        parameter is assigned to owns it, and shared blocks register the
        same tensor."""
        if self._t is None:
            self._t = self._make_tensor(device)
        if self._owner is None:
            self._owner = (weakref.ref(block), attr)
        self._refresh()
        return self._t

    def _tensor(self) -> Optional[torch.Tensor]:
        """The current tensor, read from the owning block (a buffer moved
        with ``module.to`` is a new tensor)."""
        if self._owner is not None:
            block = self._owner[0]()
            if block is not None:
                t = getattr(block, self._owner[1], None)
                if isinstance(t, torch.Tensor):
                    self._t = t
        return self._t

    def _allocated(self) -> bool:
        t = self._tensor()
        return t is not None and not _uninitialized(t)

    # ------------------------------------------------------------------ props
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError(f"invalid grad_req {req}")
        if not self._differentiable:
            req = "null"
        if self._grad_req == req:
            return
        self._grad_req = req
        t = self._tensor()
        if isinstance(t, nn.Parameter):
            t.requires_grad_(req != "null")
        if req == "null":
            self._grad = None
        if self._nd is not None:
            self._mark(self._nd)

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        if self._shape is None:
            self._shape = tuple(new_shape)
            return
        if len(self._shape) != len(new_shape):
            raise AssertionError(f"shape mismatch for {self.name}: "
                                 f"{self._shape} vs {new_shape}")
        merged = tuple(n if o in (0, -1) else o
                       for o, n in zip(self._shape, new_shape))
        for o, n in zip(merged, new_shape):
            if n not in (0, -1) and o != n:
                raise AssertionError(f"shape mismatch for {self.name}: "
                                     f"{self._shape} vs {new_shape}")
        self._shape = merged

    @property
    def dtype(self):
        """The tensor's dtype (numpy's name for it) once allocated, else
        the dtype asked for."""
        if self._allocated():
            return numpy_dtype(self._t.dtype)
        return self._dtype

    @dtype.setter
    def dtype(self, value):
        self._dtype = value

    # ------------------------------------------------------------------ init
    def initialize(self, init=None, ctx=None, default_init="uniform",
                   force_reinit=False):
        """Fill the tensor from ``init`` (this parameter's own ``init``
        wins; ``default_init`` when neither is given) on ``ctx``: the
        tensor's device when it has one, else the current context (the
        card unless the caller names the CPU).  With the shape unknown and
        deferred init allowed, the fill waits for the first forward."""
        if self._initialized and not force_reinit:
            return
        ctx = _as_ctx(ctx) or self._default_ctx()
        self._ctx_list = ctx
        ctx[0].torch_device()  # raises for a card this process cannot see
        if not _shape_known(self._shape):
            if self._allow_deferred_init:
                self._deferred_init = (init, ctx, default_init)
                return
            raise ValueError(f"cannot initialize {self.name}: shape "
                             f"{self._shape} unknown and deferred init not "
                             "allowed")
        self._finish_init(init, ctx, default_init)

    def _default_ctx(self) -> List[Context]:
        """Where a parameter goes when no context is named: its tensor's
        device, else the context it was last given, else the current
        one."""
        if self._allocated():
            return [Context.of(self._t.device)]
        if self._deferred_init:
            return list(self._deferred_init[1])
        return list(self._ctx_list or [current_context()])

    @torch.no_grad()
    def _finish_init(self, init, ctx, default_init):
        self._deferred_init = ()
        dev = ctx[0].torch_device()
        dt = dtype_torch(self._dtype)
        t = self._tensor()
        if t is None:
            t = self._t = self._make_tensor(dev)
        elif _uninitialized(t):
            t.materialize(self._shape, device=dev, dtype=dt)
        elif t.device != dev:
            t.data = t.data.to(dev)
        initializer.create(init if init is not None
                           else (self.init or default_init))._fill(
            initializer.InitDesc(self.name), t,
            initializer._random.device_generator(dev))
        self._initialized = True
        self._refresh()._version += 1

    def _finish_deferred_init(self):
        """Allocate and fill a deferred parameter now that its shape is
        known (a block calls this at its first forward)."""
        if not self._deferred_init:
            if self._allocated():
                return
            raise RuntimeError(f"parameter {self.name} has not been "
                               "initialized; call initialize() first")
        if not _shape_known(self._shape):
            raise DeferredInitializationError(
                f"parameter {self.name} has unknown shape {self._shape}")
        init, ctx, default_init = self._deferred_init
        self._finish_init(init, ctx, default_init)

    # ------------------------------------------------------------------ access
    def _check_initialized(self):
        if self._allocated():
            return
        if self._deferred_init:
            raise DeferredInitializationError(
                f"parameter {self.name} not initialized yet (deferred: shape "
                "unknown until the first forward)")
        raise RuntimeError(f"parameter {self.name} has not been initialized;"
                           " call initialize() first")

    def _mark(self, arr: _ParamArray) -> None:
        """Make ``arr`` an autograd variable (or not) per ``grad_req``.
        Under ``'write'`` the gradient array starts empty (``backward``
        rebinds it; :meth:`grad` reads zeros until then), so marking
        costs no memory."""
        t = arr._data
        if self._grad_req == "null":
            arr._grad, arr._grad_req = None, None
            t.__dict__.pop("_mx_variable", None)
            return
        g = self._grad
        if g is None or g._data.dtype != t.dtype or \
                g._data.device != t.device or (
                    g._data.shape != t.shape
                    and (g._data.numel() or self._grad_req == "add")):
            shape = t.shape if self._grad_req == "add" else (0,)
            self._grad = NDArray(torch.zeros(shape, dtype=t.dtype,
                                             device=t.device), arr._ctx)
        arr._grad, arr._grad_req = self._grad, self._grad_req
        t._mx_variable = weakref.ref(arr)

    def _refresh(self) -> Optional[_ParamArray]:
        """The NDArray over the current tensor, made and marked anew when
        the tensor changed; None while unallocated.  Called wherever a
        tensor is allocated, so a forward records onto the parameter
        before anyone asks for its data."""
        t = self._tensor()
        if t is None or _uninitialized(t):
            return None
        arr = self._nd
        if arr is None or arr._data is not t:
            arr = self._nd = _ParamArray(t, Context.of(t.device))
        self._mark(arr)
        return arr

    def data(self, ctx: Optional[Context] = None) -> NDArray:
        """The parameter as an NDArray over the module's tensor (the same
        object on every call while the tensor stays)."""
        self._check_initialized()
        arr = self._nd
        if arr is None or arr._data is not self._t or \
                arr._grad is not self._grad:
            arr = self._refresh()
        return arr

    def list_data(self) -> List[NDArray]:
        return [self.data()]

    def grad(self, ctx: Optional[Context] = None) -> NDArray:
        arr = self.data()
        if self._grad_req == "null":
            raise RuntimeError(f"parameter {self.name} has grad_req='null'")
        g = arr._grad
        if g._data.shape != arr._data.shape:  # no backward has written it
            g._data = torch.zeros_like(arr._data, requires_grad=False)
        return g

    def list_grad(self) -> List[NDArray]:
        return [self.grad()]

    def list_ctx(self) -> List[Context]:
        if not self._allocated() and not self._deferred_init:
            self._check_initialized()
        return self._default_ctx()

    def set_data(self, data):
        """Write ``data`` (NDArray, tensor or array-like) into the tensor
        in place; a deferred parameter takes its shape from it.  A later
        ``initialize()`` keeps the value."""
        self.shape = tuple(data.shape)
        if not self._allocated():
            if self._deferred_init:
                self._finish_deferred_init()
            else:
                raise RuntimeError(f"parameter {self.name} not initialized")
        if isinstance(data, NDArray):
            src = data._data
        elif isinstance(data, torch.Tensor):
            src = data
        else:
            src = _nd.array(data, ctx=cpu())._data
        with torch.no_grad():
            self._t.copy_(src)
        self._initialized = True
        if self._nd is not None:
            self._nd._version += 1

    def zero_grad(self):
        if self._grad is not None:
            self._grad[:] = 0.0

    def cast(self, dtype):
        """Cast the tensor to ``dtype`` in place (the module sees it)."""
        self._dtype = dtype
        if self._allocated():
            with torch.no_grad():
                self._t.data = self._t.data.to(dtype_torch(dtype))
            self._refresh()

    def var(self):
        """This parameter as a symbol variable (name, shape, dtype); a
        ``grad_req='null'`` one is an auxiliary state of the graph."""
        from ..symbol import var
        s = var(self.name, shape=self.shape, dtype=self.dtype)
        if self._grad_req == "null":
            s._outputs[0][0].attrs["__aux__"] = True
        return s

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self._shape}, "
                f"dtype={self.dtype})")


class Constant(Parameter):
    """A parameter that holds a fixed value and takes no gradient; it is
    its block's buffer."""

    def __init__(self, name, value):
        if isinstance(value, NDArray):
            value = value.asnumpy()
        value = np.asarray(value)
        if value.dtype == np.float64:
            value = value.astype(np.float32)
        self.value = value
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=str(value.dtype),
                         init=initializer.Constant(value),
                         differentiable=False)


class ParameterDict:
    """Parameters by full name under a ``prefix``; ``get`` creates or
    returns one, and a dict built over ``shared`` takes the parameters it
    names from there."""

    def __init__(self, prefix="", shared: Optional["ParameterDict"] = None):
        self._prefix = prefix
        self._params: "OrderedDict[str, Parameter]" = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __getitem__(self, key) -> Parameter:
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs) -> Parameter:
        """The parameter ``prefix + name``, created from ``kwargs`` if
        new; for an existing one, a given shape merges into its own and
        the other settings fill only what it lacks."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
        else:
            for k, v in kwargs.items():
                if k == "shape" and v is not None:
                    param.shape = v if not isinstance(v, int) else (v,)
                elif getattr(param, k if k != "grad_req" else "_grad_req",
                             None) is None and v is not None:
                    setattr(param, k, v)
        return param

    def get_constant(self, name, value=None) -> Constant:
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise KeyError(f"constant {name} not found and no value "
                               "given")
            param = Constant(name, value)
            self._params[name] = param
        return param

    def update(self, other: "ParameterDict"):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError(f"duplicate parameter name {k}")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter; ``init`` is only the default, each
        parameter's own ``init`` wins."""
        for p in self.values():
            p.initialize(init=None, ctx=ctx,
                         default_init=init if init is not None else "uniform",
                         force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def setattr(self, name, value):
        for p in self.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix=""):
        arg = {}
        for p in self.values():
            name = p.name
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arg[name] = p.data()
        _nd.save(filename, arg)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        with cpu():
            loaded = _nd.load(filename)
        if isinstance(loaded, list):
            raise ValueError("expected a name->array dict file")
        loaded = {restore_prefix + k: v for k, v in loaded.items()}
        self.load_dict(loaded, ctx=ctx, allow_missing=allow_missing,
                       ignore_extra=ignore_extra)

    def load_dict(self, param_dict, ctx=None, allow_missing=False,
                  ignore_extra=False, cast_dtype=False,
                  dtype_source="current"):
        """Load a name -> array dict; with ``cast_dtype``, ``dtype_source``
        keeps each parameter's dtype (``'current'``) or takes the saved
        one (``'saved'``)."""
        if dtype_source not in ("current", "saved"):
            raise ValueError("dtype_source must be 'current' or 'saved'")
        if not allow_missing:
            for name in self.keys():
                if name not in param_dict:
                    raise IOError(f"parameter {name} missing from "
                                  "param_dict")
        for name, arr in param_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise IOError(f"parameter {name} in dict is not in this "
                                  "ParameterDict")
                continue
            p = self._params[name]
            if not p._allocated():
                p.shape = arr.shape
                p.initialize(ctx=ctx)
                p._finish_deferred_init()
            if cast_dtype and dtype_source == "saved":
                p.cast(arr.dtype)
            p.set_data(arr)

    def __repr__(self):
        s = "\n".join(repr(p) for p in self.values())
        return f"ParameterDict '{self._prefix}' (\n{s}\n)"
