"""NDArray: the imperative tensor type, over a ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py`` (reference
``include/mxnet/ndarray.h``, ``src/ndarray/ndarray.cc``).  CUDA's stream
already gives the asynchronous dispatch the reference's engine existed
for; what this layer keeps is the semantics the engine exposed:

* a version counter per array (``_version``, the engine var's version),
  bumped by every write;
* ``wait_to_read`` / ``waitall``, where asynchronous CUDA errors surface;
* copies between devices (``copyto``, ``as_in_context``);
* value semantics: as in the JAX package, whose arrays are immutable, no
  two arrays share a buffer.  ``x[1:3]``, ``reshape`` and the other ops
  that torch would answer with a view return a copy (:func:`invoke`), and
  ``x += 1`` / ``x[:] = v`` swap the array's buffer instead of writing
  into it, so a tensor that autograd saved is never changed under it.  The
  one writer in place is a runtime-compiled kernel (``mx.rtc``), which
  writes its outputs' own buffers.

Every operator application goes through :func:`invoke`, the analog of
``Imperative::Invoke`` (``src/imperative/imperative.cc:89``).
"""
from __future__ import annotations

import os
import sys as _sys
import time as _time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as _np
import torch

from .. import autograd
from ..base import (BFLOAT16, MXNetError, dtype_torch, env, narrow_source,
                    numpy_dtype)
from ..context import Context, current_context
from ..ops import registry as _registry

__all__ = [
    "NDArray", "invoke", "array", "zeros", "ones", "empty", "full", "arange",
    "concatenate", "save", "load", "waitall",
]

# set by mxnet_tpu_torch.profiler while it collects: called as
# hook(op_name, t0, t1) around each op's dispatch (host time)
_PROFILE_HOOK = None


class NDArray:
    __slots__ = ("_data", "_ctx", "_version", "_grad", "_grad_req",
                 "__weakref__")

    def __init__(self, data: torch.Tensor, ctx: Optional[Context] = None):
        self._data = data
        self._ctx = ctx if ctx is not None else Context.of(data.device)
        self._version = 0
        self._grad: Optional["NDArray"] = None
        self._grad_req: Optional[str] = None

    # ------------------------------------------------------------------ props
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """The numpy dtype (``base.BFLOAT16`` for bfloat16)."""
        return numpy_dtype(self._data.dtype)

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def ndim(self) -> int:
        return self._data.ndim

    @property
    def context(self) -> Context:
        return self._ctx

    ctx = context

    @property
    def stype(self) -> str:
        return "default"

    @property
    def grad(self) -> Optional["NDArray"]:
        return self._grad

    @property
    def T(self) -> "NDArray":
        return invoke("transpose", [self], {})

    @property
    def handle(self) -> torch.Tensor:
        """The underlying tensor."""
        return self._data

    # --------------------------------------------------------------- sync/copy
    def wait_to_read(self) -> None:
        """Block until the value is computed; asynchronous CUDA errors
        surface here (reference ``Engine::WaitForVar``)."""
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)

    def asnumpy(self) -> _np.ndarray:
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            if isinstance(BFLOAT16, str):
                raise MXNetError("asnumpy of a bfloat16 array needs the "
                                 "ml_dtypes package; use .astype('float32')")
            return t.view(torch.int16).cpu().numpy().view(BFLOAT16)
        return t.cpu().numpy().copy() if not t.is_cuda else t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def copyto(self, other: Union["NDArray", Context]) -> "NDArray":
        """Reference ``CopyFromTo`` (ndarray.cc:1198)."""
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device(),
                                                  copy=True), other)
        if other is self:
            return other
        other._set_data(self._data.detach().to(other._data.device, copy=True))
        return other

    def as_in_context(self, ctx: Context) -> "NDArray":
        if ctx == self._ctx:
            return self
        return self.copyto(ctx)

    as_in_ctx = as_in_context

    def astype(self, dtype, copy: bool = True) -> "NDArray":
        if not copy and dtype_torch(dtype) == self._data.dtype:
            return self
        return invoke("cast", [self], {"dtype": dtype})

    def copy(self) -> "NDArray":
        return invoke("copy", [self], {})

    def detach(self) -> "NDArray":
        return NDArray(self._data.detach(), self._ctx)

    def zeros_like(self, **kw) -> "NDArray":
        return invoke("zeros_like", [self], {})

    def ones_like(self, **kw) -> "NDArray":
        return invoke("ones_like", [self], {})

    # ------------------------------------------------------------- autograd
    def attach_grad(self, grad_req: str = "write", stype: Optional[str] = None
                    ) -> None:
        """Attach a gradient array (zeros, this array's shape and dtype)."""
        if stype not in (None, "default"):
            raise ValueError(f"attach_grad: unsupported gradient stype "
                             f"{stype!r} (sparse arrays are not ported)")
        grad = NDArray(torch.zeros_like(self._data.detach()), self._ctx)
        autograd.mark_variables([self], [grad], [grad_req])

    def backward(self, out_grad: Optional["NDArray"] = None,
                 retain_graph: bool = False, train_mode: bool = True) -> None:
        autograd.backward([self], [out_grad], retain_graph, train_mode)

    # ------------------------------------------------------------- mutation
    def _set_data(self, new: torch.Tensor) -> None:
        """Rebind the buffer; bumps the version.  A variable stays a leaf
        (its new buffer is not on the tape), as in the JAX package, where
        this leaves the array's tape node alone."""
        if autograd._is_variable(self):
            new = autograd.leaf(self, new)
        self._data = new
        self._version += 1

    def __setitem__(self, key, value) -> None:
        dev = self._data.device
        key = _clean_index(key, dev)
        if isinstance(value, NDArray):
            value = value._data
        with torch.no_grad():
            value = torch.as_tensor(value, device=dev)
            if (isinstance(key, tuple) and len(key) == 0) or (
                    isinstance(key, slice) and key == slice(None)):
                new = torch.broadcast_to(value.to(self._data.dtype),
                                         self.shape).clone()
            else:
                new = self._data.detach().clone()
                new[key] = value
        self._set_data(new)

    def __getitem__(self, key) -> "NDArray":
        key = _clean_index(key, self._data.device)
        return invoke("_getitem", [self], {"key": _FrozenIndex(key)})

    # ------------------------------------------------------------- conversion
    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def __len__(self) -> int:
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self) -> bool:
        if self.size == 1:
            return bool(self._data.item())
        raise ValueError("The truth value of an NDArray with multiple "
                         "elements is ambiguous")

    def __int__(self):
        return int(self._data.item())

    def __float__(self):
        return float(self._data.item())

    def __index__(self):
        return int(self._data.item())

    def __repr__(self) -> str:
        t = self._data.detach().cpu()
        body = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        return (f"\n{body!r}\n<NDArray {'x'.join(map(str, self.shape))} "
                f"@{self._ctx}>")

    def __hash__(self):
        return id(self)

    # ------------------------------------------------------------- arithmetic
    def __add__(self, other):  return _binary("broadcast_add", "_plus_scalar", self, other)
    def __radd__(self, other): return _binary("broadcast_add", "_plus_scalar", self, other)
    def __sub__(self, other):  return _binary("broadcast_sub", "_minus_scalar", self, other)
    def __rsub__(self, other): return _binary_r("broadcast_sub", "_rminus_scalar", self, other)
    def __mul__(self, other):  return _binary("broadcast_mul", "_mul_scalar", self, other)
    def __rmul__(self, other): return _binary("broadcast_mul", "_mul_scalar", self, other)
    def __truediv__(self, other):  return _binary("broadcast_div", "_div_scalar", self, other)
    def __rtruediv__(self, other): return _binary_r("broadcast_div", "_rdiv_scalar", self, other)
    def __mod__(self, other):  return _binary("broadcast_mod", "_mod_scalar", self, other)
    def __rmod__(self, other): return _binary_r("broadcast_mod", "_rmod_scalar", self, other)
    def __pow__(self, other):  return _binary("broadcast_power", "_power_scalar", self, other)
    def __rpow__(self, other): return _binary_r("broadcast_power", "_rpower_scalar", self, other)
    def __floordiv__(self, other): return _binary("broadcast_floordiv", "_floordiv_scalar", self, other)
    def __matmul__(self, other): return invoke("matmul", [self, other], {})
    def __neg__(self):  return invoke("negative", [self], {})
    def __abs__(self):  return invoke("abs", [self], {})

    def __iadd__(self, other):
        self._adopt(self.__add__(other))
        return self

    def __isub__(self, other):
        self._adopt(self.__sub__(other))
        return self

    def __imul__(self, other):
        self._adopt(self.__mul__(other))
        return self

    def __itruediv__(self, other):
        self._adopt(self.__truediv__(other))
        return self

    def _adopt(self, other: "NDArray") -> None:
        """Take ``other``'s buffer and, when it was recorded, its place on
        the tape (``x += y`` under ``record()``)."""
        self._set_data(other._data)
        if other._data.grad_fn is not None:
            self._data = other._data

    def __eq__(self, other):  return _binary("broadcast_equal", "_equal_scalar", self, other)
    def __ne__(self, other):  return _binary("broadcast_not_equal", "_not_equal_scalar", self, other)
    def __lt__(self, other):  return _binary("broadcast_lesser", "_lesser_scalar", self, other)
    def __le__(self, other):  return _binary("broadcast_lesser_equal", "_lesser_equal_scalar", self, other)
    def __gt__(self, other):  return _binary("broadcast_greater", "_greater_scalar", self, other)
    def __ge__(self, other):  return _binary("broadcast_greater_equal", "_greater_equal_scalar", self, other)

    # --------------------------------------------------- registry method fallback
    def reshape(self, *shape, **kwargs):
        """Reference NDArray.reshape: ``reshape(2, 3)``, ``reshape((2, 3))``
        or ``reshape(shape=(2, 3), reverse=...)``, with the special codes
        0/-1/-2/-3/-4 (matrix_op-inl.h InferReshapeShape)."""
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if shape:
            kwargs["shape"] = tuple(shape)
        return invoke("reshape", [self], kwargs)

    def __getattr__(self, name: str):
        # any registered op is a method with `self` as first operand
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            op = _registry.get(name)
        except KeyError:
            raise AttributeError(
                f"'NDArray' object has no attribute {name!r}") from None

        def method(*args, **kwargs):
            return invoke(op, [self, *args], kwargs)

        method.__name__ = name
        return method


class _BoundArray(NDArray):
    """An array bound to an ``Executor``: the executor's storage, as the
    reference's bound NDArrays are.  A write of the same shape, dtype and
    device (``arr[:] = v``, a kvstore ``pull``, ``Module.set_params``) lands
    in its buffer in place, so a CUDA graph that reads it there sees it; a
    write of another shape rebinds it."""

    __slots__ = ()

    def _set_data(self, new: torch.Tensor) -> None:
        old = self._data
        if new.shape != old.shape or new.dtype != old.dtype or \
                new.device != old.device or old.requires_grad:
            NDArray._set_data(self, new)
            return
        with torch.no_grad():
            old.copy_(new)
        self._version += 1


def bind_in_place(arr: NDArray) -> NDArray:
    """Make a plain array write in place (:class:`_BoundArray`)."""
    if type(arr) is NDArray:
        arr.__class__ = _BoundArray
    return arr


def _clean_index(key, device):
    def one(k):
        if isinstance(k, NDArray):
            return k._data.to(device)
        if isinstance(k, (list, _np.ndarray)):
            # python-list fancy indexing; an empty list indexes as int
            arr = _np.asarray(k)
            if arr.size == 0:
                arr = arr.astype(_np.int64)
            return torch.as_tensor(arr, device=device)
        return k
    if isinstance(key, tuple):
        return tuple(one(k) for k in key)
    return one(key)


class _FrozenIndex:
    """Wrapper that carries an index object as an op param."""

    __slots__ = ("key",)

    def __init__(self, key):
        self.key = key


def _binary(op_name: str, scalar_op: str, lhs: NDArray, rhs) -> NDArray:
    if isinstance(rhs, NDArray):
        return invoke(op_name, [lhs, rhs], {})
    return invoke(scalar_op, [lhs], {"scalar": rhs})


def _binary_r(op_name: str, scalar_op: str, lhs: NDArray, rhs) -> NDArray:
    # reflected: scalar <op> array
    if isinstance(rhs, NDArray):
        return invoke(op_name, [rhs, lhs], {})
    return invoke(scalar_op, [lhs], {"scalar": rhs})


# ---------------------------------------------------------------------------
# invoke: the single imperative dispatch path (Imperative::Invoke analog)
# ---------------------------------------------------------------------------
class _OpGrad(torch.autograd.Function):
    """An op with its own registered gradient as one autograd node."""

    @staticmethod
    def forward(ctx, op, params, *tensors):
        out = op.fn(*tensors, **params)
        outs = tuple(out) if isinstance(out, (tuple, list)) else (out,)
        ctx.save_for_backward(*tensors, *outs)
        ctx.op, ctx.params, ctx.n_in = op, params, len(tensors)
        return out

    @staticmethod
    def backward(ctx, *out_grads):
        saved = ctx.saved_tensors
        grads = ctx.op.grad(ctx.params, list(saved[:ctx.n_in]),
                            list(saved[ctx.n_in:]), list(out_grads))
        return (None, None) + tuple(grads)


_SYMBOL_MODULE = __name__.split(".")[0] + ".symbol.symbol"


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _own(outs: List[torch.Tensor], raw: List[Any]) -> List[torch.Tensor]:
    """The outputs, each copied where it shares a buffer with an input (a
    view, or the input itself): arrays never share buffers."""
    shared = {_storage(t) for x in raw
              for t in (x if isinstance(x, list) else [x])
              if isinstance(t, torch.Tensor) and t.numel()}
    return [r.clone() if r.numel() and _storage(r) in shared else r
            for r in outs]


def invoke(op, inputs: Sequence[Any], params: Optional[Dict[str, Any]] = None,
           out: Optional[Union[NDArray, Sequence[NDArray]]] = None):
    """Execute a registered op on NDArrays.

    Mirrors ``Imperative::Invoke`` (``src/imperative/imperative.cc:40-108``):
    while recording, an op on an array that is on the tape runs with
    torch's grad mode on and so records its node; otherwise it records
    nothing.  A ``ctx`` param places the result of an op without array
    inputs.  Symbol inputs compose a graph node instead
    (``symbol.invoke_symbol``), so one ``hybrid_forward(F, ...)`` serves
    both ``mx.nd`` and a symbolic trace, as in the JAX package."""
    if isinstance(op, str):
        op = _registry.get(op)
    params = dict(params) if params else {}
    sym = _sys.modules.get(_SYMBOL_MODULE)
    if sym is not None and any(
            isinstance(x, sym.Symbol) or (isinstance(x, (list, tuple)) and x
                                          and isinstance(x[0], sym.Symbol))
            for x in inputs):
        params.pop("ctx", None)
        return sym.invoke_symbol(op.name, list(inputs), params,
                                 name=params.pop("name", None))
    hook = _PROFILE_HOOK
    t0 = hook and _time.perf_counter()
    ctx = params.pop("ctx", None)
    nd_inputs: List[NDArray] = []
    for x in inputs:
        if isinstance(x, NDArray):
            nd_inputs.append(x)
        elif isinstance(x, (list, tuple)) and x and isinstance(x[0], NDArray):
            nd_inputs.extend(x)
    if nd_inputs:
        ctx = nd_inputs[0]._ctx
        device = nd_inputs[0]._data.device
    else:
        ctx = Context(ctx) if ctx is not None else current_context()
        device = ctx.torch_device()
    raw: List[Any] = []
    for x in inputs:
        if isinstance(x, NDArray):
            raw.append(x._data)
        elif isinstance(x, (list, tuple)) and x and isinstance(x[0], NDArray):
            raw.append([e._data for e in x])
        elif isinstance(x, _np.ndarray):
            raw.append(torch.as_tensor(narrow_source(x), device=device))
        else:
            raw.append(x)
    if op.nin == 0:
        params["device"] = device
    if op.takes_training and "_training" not in params:
        params["_training"] = autograd.is_training()
    if op.needs_rng and params.get("generator") is None:
        from .. import random as _random
        params["generator"] = _random.device_generator(device)

    recording = (autograd.is_recording() and op.differentiable
                 and any(x._data.requires_grad for x in nd_inputs))
    with torch.set_grad_enabled(recording):
        if recording and op.grad is not None:
            result = _OpGrad.apply(op, params, *raw)
        else:
            result = op.fn(*raw, **params)
    if hook is not None:
        hook(op.name, t0, _time.perf_counter())
    multi = isinstance(result, (tuple, list))
    outs_raw = _own(list(result) if multi else [result], raw)
    if recording:
        autograd.note_op(op.name, params, raw, outs_raw)
    if autograd.is_recording() and op.differentiable:
        # a non-differentiable op (isnan, isinf, isfinite, logical_not)
        # puts no node on the tape, as in the JAX package: a head it made
        # cannot be differentiated
        autograd.link_untracked([x._data for x in nd_inputs], outs_raw)
    if out is not None:
        out_list = out if isinstance(out, (list, tuple)) else [out]
        for o, r in zip(out_list, outs_raw):
            # writing into an existing array keeps its dtype (reference
            # kWriteTo)
            o._set_data(r if r.dtype == o._data.dtype else r.to(o._data.dtype))
        return out if not isinstance(out, (list, tuple)) or multi else out_list[0]
    out_nd = [NDArray(r, ctx) for r in outs_raw]
    return out_nd if multi else out_nd[0]


# ---------------------------------------------------------------------------
# creation / io
# ---------------------------------------------------------------------------
def _target(ctx: Optional[Context]):
    c = ctx if ctx is not None else current_context()
    return c, c.torch_device()


def _from_numpy(a: _np.ndarray) -> torch.Tensor:
    """A torch copy of ``a`` (a numpy bfloat16 array included)."""
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(_np.ascontiguousarray(a).view(_np.int16)
                                .copy()).view(torch.bfloat16)
    # (a negatively strided view, x[..., ::-1], needs a contiguous copy;
    # np.ascontiguousarray would make a 0-d array 1-d)
    return torch.tensor(a if a.flags.c_contiguous else a.copy())


def array(source, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """An array holding a copy of ``source`` (array-like, numpy array,
    NDArray or tensor).  The JAX package's width policy holds: 64-bit
    floats become float32, and 64-bit integers int32 when every value fits
    (else ValueError); a list of Python floats is float32."""
    c, dev = _target(ctx)
    if isinstance(source, NDArray):
        source = source._data
    req = dtype_torch(dtype, narrow=False)
    if isinstance(source, torch.Tensor):
        t = source.detach()
        if t.dtype == torch.int64 or req == torch.int64:
            t = torch.from_numpy(narrow_source(
                t.cpu().numpy().astype(_np.int64)))
    else:
        a = _np.asarray(source)
        if req is not None and req != torch.bfloat16 and \
                str(a.dtype) != "bfloat16":
            a = a.astype(numpy_dtype(req))
        t = _from_numpy(narrow_source(a))
    dt = dtype_torch(dtype) or dtype_torch(t.dtype)
    return NDArray(t.to(dev, dt, copy=True), c)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _dtype(dtype):
    return dtype_torch(dtype) or dtype_torch(env.MXNET_DEFAULT_DTYPE)


def empty(shape, ctx=None, dtype=None) -> NDArray:
    """An uninitialised array (the JAX package, which cannot leave memory
    uninitialised, returns zeros)."""
    c, dev = _target(ctx)
    return NDArray(torch.empty(_shape(shape), dtype=_dtype(dtype),
                               device=dev), c)


def zeros(shape, ctx=None, dtype=None) -> NDArray:
    c, dev = _target(ctx)
    return NDArray(torch.zeros(_shape(shape), dtype=_dtype(dtype),
                               device=dev), c)


def ones(shape, ctx=None, dtype=None) -> NDArray:
    c, dev = _target(ctx)
    return NDArray(torch.ones(_shape(shape), dtype=_dtype(dtype),
                              device=dev), c)


def full(shape, val, ctx=None, dtype=None) -> NDArray:
    c, dev = _target(ctx)
    return NDArray(torch.full(_shape(shape), val, dtype=_dtype(dtype),
                              device=dev), c)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None
           ) -> NDArray:
    from ..ops.matrix import arange_values
    c, dev = _target(ctx)
    return NDArray(arange_values(start, stop, step, repeat,
                                 dtype or "float32").to(dev), c)


def concatenate(arrays: Sequence[NDArray], axis: int = 0) -> NDArray:
    return invoke("concat", [list(arrays)], {"dim": axis})


def waitall() -> None:
    """Reference ``Engine::WaitForAll``: wait for all work queued on every
    card; asynchronous CUDA errors surface here."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


# -- serialization: the JAX package's format (reference ndarray.cc:1596 Save
#    / :1719 Load there): a numpy .npz archive with a ``__manifest__`` of
#    "name\x00dtype" entries, bfloat16 stored as uint16 views, so a file
#    saved by one package loads in the other
def save(fname: str, data) -> None:
    if isinstance(data, NDArray):
        payload, names = [data], [""]
    elif isinstance(data, (list, tuple)):
        payload, names = list(data), [""] * len(data)
    elif isinstance(data, dict):
        names, payload = list(data.keys()), list(data.values())
    else:
        raise TypeError("save expects NDArray, list, or dict")
    arrs = {}
    manifest = []
    for i, (n, a) in enumerate(zip(names, payload)):
        t = a._data.detach().cpu()
        if t.dtype == torch.bfloat16:
            arrs[f"arr_{i}"] = t.view(torch.int16).numpy().view(_np.uint16)
            manifest.append(f"{n}\x00bfloat16")
        else:
            arrs[f"arr_{i}"] = t.numpy()
            manifest.append(f"{n}\x00{t.numpy().dtype}")
    arrs["__manifest__"] = _np.array(manifest)
    _np.savez(fname, **arrs)
    # numpy appends .npz; the reference contract is the exact fname
    if not fname.endswith(".npz") and os.path.exists(fname + ".npz"):
        os.replace(fname + ".npz", fname)


def load(fname):
    """The arrays ``save`` wrote to ``fname`` (a path or a binary file
    object): a list, or a dict when they were saved with names."""
    if not isinstance(fname, (str, os.PathLike)):
        path = fname
    else:
        path = fname if os.path.exists(fname) else fname + ".npz"
    with _np.load(path, allow_pickle=False) as zf:
        manifest = [s.split("\x00") for s in zf["__manifest__"]]
        out = []
        for i, fields in enumerate(manifest):
            name, dt = fields[0], fields[1]
            if len(fields) >= 4 and fields[2] in ("row_sparse", "csr"):
                raise NotImplementedError(
                    f"{fname}: {name!r} is a {fields[2]} array; sparse "
                    "arrays are not ported")
            x = zf[f"arr_{i}"]
            if dt == "bfloat16":
                t = (torch.from_numpy(x.view(_np.int16).copy())
                     .view(torch.bfloat16) if x.dtype == _np.uint16
                     else torch.from_numpy(x).to(torch.bfloat16))
                out.append((name, array(t)))
            else:
                out.append((name, array(x)))
    if all(n == "" for n, _ in out):
        return [a for _, a in out]
    return {n: a for n, a in out}
