"""Runtime kernel compilation (reference ``python/mxnet/rtc.py``).

Counterpart of ``mxnet_tpu/rtc.py``, whose ``PallasKernel.launch`` (``:88``)
runs user Pallas source through ``pl.pallas_call``.  The port has two
routes, each with its own meaning of ``grid_dims`` and ``block_dims``:

* :class:`CudaModule` / :class:`CudaKernel`, on the card: the reference
  MXNet 1.6's API.  NVRTC compiles user CUDA C source straight to a CUBIN
  for the card (``sm_90a`` on an H100), the driver loads it into the
  device's primary context, and ``launch`` runs it on the NDArrays'
  device on PyTorch's current stream.  ``grid_dims`` and ``block_dims``
  are CUDA's grid and threads per block; the kernel computes its own
  offsets and writes its outputs in place.  Each scalar is passed as the
  C type its signature declares.  A CPU context or array raises: nothing
  falls back to the host.
* :class:`PallasModule` / :class:`PallasKernel`, the plain version, with
  the JAX package's meaning: the source defines Python kernels over
  "refs", ``grid_dims`` is the Pallas grid (trailing 1s trimmed) and
  ``block_dims`` each array's block shape.  Here a ref is a torch view of
  the block, and the grid's programs run one after another on CPU tensors,
  as Pallas's interpreter runs them on the CPU.  The source sees ``torch``
  and ``np`` (not ``jnp`` or ``pl``).

Example on the card::

    source = r'''
    extern "C" __global__ void axpy(const float *x, const float *y,
                                    float *o, const float a, const int n) {
        int i = blockIdx.x * blockDim.x + threadIdx.x;
        if (i < n) o[i] = a * x[i] + y[i];
    }'''
    module = mx.rtc.CudaModule(source, exports=["axpy"])
    k = module.get_kernel("axpy", "const float *x, const float *y, "
                                  "float *o, const float a, const int n")
    k.launch([x, y, out, 2.0, n], mx.gpu(0), ((n + 255) // 256, 1, 1),
             (256, 1, 1))

As in the reference, kernels run outside autograd (wrap them in an
``autograd.Function`` for gradients).
"""
from __future__ import annotations

import ctypes
import itertools
import re
import time
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from . import _cuda_driver, _graphs
from .base import MXNetError
from .context import Context, current_context

__all__ = ["CudaModule", "CudaKernel", "PallasModule", "PallasKernel"]

# The JAX package's signature types (rtc.py:35-40), plus CUDA's own name
# for bfloat16.
_CTYPE_TO_TORCH = {
    "float": torch.float32, "double": torch.float64, "__half": torch.float16,
    "half": torch.float16, "bfloat16": torch.bfloat16,
    "__nv_bfloat16": torch.bfloat16, "uint8_t": torch.uint8,
    "int8_t": torch.int8, "int32_t": torch.int32, "int": torch.int32,
    "int64_t": torch.int64, "long": torch.int64,
}
# how a scalar argument is passed to a CUDA kernel; 16-bit floats as their
# raw bits
_SCALAR_CTYPE = {
    torch.float32: ctypes.c_float, torch.float64: ctypes.c_double,
    torch.float16: ctypes.c_uint16, torch.bfloat16: ctypes.c_uint16,
    torch.uint8: ctypes.c_uint8, torch.int8: ctypes.c_int8,
    torch.int32: ctypes.c_int32, torch.int64: ctypes.c_int64,
}
_MAX_THREADS = 1024
_MAX_BLOCK = (1024, 1024, 64)
_MAX_GRID = (2 ** 31 - 1, 65535, 65535)
_MAX_DYNAMIC_SMEM = 232448   # 227 KB, Hopper's per-block limit
_STATIC_SMEM = 48 * 1024     # above this, dynamic shared memory needs opting in


def _torch_dtype(ctype: str) -> torch.dtype:
    try:
        return _CTYPE_TO_TORCH[ctype]
    except KeyError:
        raise ValueError(f"unsupported signature type {ctype!r}; one of "
                         f"{sorted(_CTYPE_TO_TORCH)}") from None


def _parse_signature(signature: str):
    """Parse a reference-style kernel signature (reference rtc.py:112
    ``get_kernel``): ``const float *x`` is an input array, ``float *y`` an
    output array, ``const int n`` / ``int n`` a scalar.  Returns
    ``[(name, torch dtype, kind)]``, kind in {"in", "out", "scalar"}."""
    args = []
    pattern = re.compile(r"^\s*(const\s+)?([\w_]+)\s*(\*?)\s*([\w_]+)\s*$")
    for tok in signature.split(","):
        m = pattern.match(tok)
        if not m:
            raise ValueError(f"cannot parse signature fragment {tok!r}")
        const, ctype, star, name = m.groups()
        kind = ("in" if const else "out") if star else "scalar"
        args.append((name, _torch_dtype(ctype), kind))
    return args


def _scalar(value, dtype: torch.dtype):
    """``value`` rounded to the declared dtype, as a Python number."""
    return torch.tensor(value, dtype=dtype).item()


def _c_scalar(value, dtype: torch.dtype):
    """``value`` as the ctypes value of its declared C type; a 16-bit float
    as its raw bits."""
    value = _scalar(value, dtype)
    if dtype in (torch.float16, torch.bfloat16):
        value = torch.tensor(value, dtype=dtype).view(torch.int16).item() \
            & 0xFFFF
    return _SCALAR_CTYPE[dtype](value)


def _check_array(name, arg, dtype):
    from .ndarray.ndarray import NDArray
    if not isinstance(arg, NDArray):
        raise TypeError(f"argument {name!r} must be an NDArray")
    if arg._data.dtype != dtype:
        raise TypeError(f"argument {name!r}: dtype {arg.dtype} != declared "
                        f"{str(dtype).replace('torch.', '')}")
    return arg._data


# ---------------------------------------------------------------------------
# the card: NVRTC + the driver API
# ---------------------------------------------------------------------------
def _arch() -> str:
    major, minor = torch.cuda.get_device_capability()
    return f"sm_{major}{minor}" + ("a" if (major, minor) == (9, 0) else "")


class CudaModule:
    """Compile CUDA C source at run time with NVRTC (reference rtc.py:42).

    ``options`` are appended to NVRTC's (``--gpu-architecture`` of the
    card, C++17, the toolkit's include directory); ``exports`` names the
    kernels to look up by their C++ name expressions (a kernel declared
    ``extern "C"`` can be got without being exported).  Compiles once, at
    construction; the CUBIN is loaded on each device at its first launch
    there.  Raises :class:`MXNetError` without a CUDA card, and with
    NVRTC's log when the source does not compile."""

    def __init__(self, source: str, options: Sequence[str] = (),
                 exports: Sequence[str] = ()):
        if not torch.cuda.is_available():
            raise MXNetError("mx.rtc.CudaModule compiles for a CUDA card and "
                             "CUDA is not available (PallasModule is the "
                             "plain version, on the CPU)")
        opts = [f"--gpu-architecture={_arch()}", "--std=c++17"]
        inc = _cuda_driver.toolkit_include()
        if inc:
            opts.append(f"--include-path={inc}")
        self._exports = list(exports)
        t0 = time.perf_counter()
        self._cubin, self._lowered, self.log = _cuda_driver.compile_cubin(
            source, opts + list(options), self._exports)
        self.compile_seconds = time.perf_counter() - t0
        self._modules: Dict[int, ctypes.c_void_p] = {}
        self._functions: Dict[Tuple[str, int], list] = {}

    def get_kernel(self, name: str, signature: str) -> "CudaKernel":
        """Bind kernel ``name`` to a C-style signature (reference
        rtc.py:112)."""
        if self._exports and name not in self._exports:
            raise ValueError(f"kernel {name!r} not in exports {self._exports}")
        return CudaKernel(self, name, _parse_signature(signature))

    def _function(self, name: str, device: torch.device, shared_mem: int):
        """The CUfunction of ``name`` on ``device``, allowed ``shared_mem``
        bytes of dynamic shared memory."""
        key = (name, device.index)
        entry = self._functions.get(key)
        if entry is None:
            module = self._modules.get(device.index)
            if module is None:
                module = _cuda_driver.load_module(self._cubin, device)
                self._modules[device.index] = module
            entry = [_cuda_driver.get_function(
                module, self._lowered.get(name, name)), _STATIC_SMEM]
            self._functions[key] = entry
        if shared_mem > entry[1]:
            _cuda_driver.set_max_dynamic_smem(entry[0], shared_mem)
            entry[1] = shared_mem
        return entry[0]


def _dims(dims, what: str, limits) -> Tuple[int, int, int]:
    d = tuple(int(x) for x in dims) + (1,) * (3 - len(dims))
    if len(d) != 3 or any(x < 1 or x > m for x, m in zip(d, limits)):
        raise ValueError(f"{what} {tuple(dims)}: each of three dims must be "
                         f"in [1, {limits}]")
    return d


class CudaKernel:
    """A kernel of a :class:`CudaModule` bound to its signature (reference
    rtc.py:173).  ``launches`` counts its launches."""

    def __init__(self, module: CudaModule, name: str, arg_spec):
        self._module = module
        self._name = name
        self._spec = arg_spec
        self.launches = 0
        # a CUDA graph that captured a launch advances it at each replay
        _graphs.count_launches(self, "launches")

    @property
    def name(self) -> str:
        return self._name

    def launch(self, args: Sequence, ctx=None, grid_dims=(1, 1, 1),
               block_dims=(1, 1, 1), shared_mem: int = 0):
        """Run the kernel on NDArray/scalar ``args`` (signature order) on
        ``ctx``'s card: ``grid_dims`` blocks of ``block_dims`` threads with
        ``shared_mem`` bytes of dynamic shared memory.  Inputs are read
        from dense copies where they are strided; outputs must be dense and
        are written in place (their version is bumped).  Returns the
        output array, or the list of them."""
        if len(args) != len(self._spec):
            raise ValueError(f"kernel {self._name} expects {len(self._spec)} "
                             f"args, got {len(args)}")
        grid = _dims(grid_dims, "grid_dims", _MAX_GRID)
        block = _dims(block_dims, "block_dims", _MAX_BLOCK)
        if block[0] * block[1] * block[2] > _MAX_THREADS:
            raise ValueError(f"block_dims {block}: more than {_MAX_THREADS} "
                             "threads per block")
        if not 0 <= int(shared_mem) <= _MAX_DYNAMIC_SMEM:
            raise ValueError(f"shared_mem {shared_mem}: at most "
                             f"{_MAX_DYNAMIC_SMEM} bytes per block")
        ctx = current_context() if ctx is None else Context(ctx)
        if ctx.device_type != "gpu":
            raise MXNetError(f"CudaKernel.launch runs on a GPU context, not "
                             f"{ctx}")
        device = ctx.torch_device()
        params, keep, outs = [], [], []
        for (name, dtype, kind), arg in zip(self._spec, args):
            if kind == "scalar":
                params.append(_c_scalar(arg, dtype))
                continue
            t = _check_array(name, arg, dtype)
            if t.device != device:
                raise MXNetError(f"argument {name!r} lies on {arg.context}, "
                                 f"the launch on {ctx}")
            if kind == "in":
                t = t.detach().contiguous()
                keep.append(t)
            elif not t.is_contiguous():
                raise MXNetError(f"output {name!r} is not contiguous; the "
                                 "kernel writes dense memory")
            else:
                outs.append(arg)
            params.append(ctypes.c_void_p(t.data_ptr()))
        if not outs:
            raise ValueError("kernel signature declares no output (non-const "
                             "pointer) argument")
        fn = self._module._function(self._name, device, int(shared_mem))
        _cuda_driver.launch(fn, grid, block, int(shared_mem),
                            torch.cuda.current_stream(device), params)
        self.launches += 1
        for o in outs:
            o._version += 1
            torch.autograd.graph.increment_version(o._data)
        return outs[0] if len(outs) == 1 else outs


# ---------------------------------------------------------------------------
# the plain version: the JAX package's Pallas semantics on CPU tensors
# ---------------------------------------------------------------------------
_JAX_NAMES = ("jax", "jnp", "pl", "pltpu", "lax")


def _explained(e: NameError) -> NameError:
    if getattr(e, "name", None) in _JAX_NAMES:
        return NameError(f"{e}: the port's PallasModule runs kernel source "
                         "over torch tensors; write it with torch and np")
    return e


class PallasKernel:
    """A kernel of a :class:`PallasModule` bound to its signature."""

    def __init__(self, fn, name: str, arg_spec):
        self._fn = fn
        self._name = name
        self._spec = arg_spec

    @property
    def name(self) -> str:
        return self._name

    def launch(self, args: Sequence, ctx=None, grid_dims: Tuple = (1, 1, 1),
               block_dims: Tuple = (0, 0, 0), shared_mem: int = 0):
        """Run the kernel on NDArray/scalar ``args`` (signature order) on the
        CPU.  grid_dims: the Pallas grid, trailing 1s trimmed; block_dims:
        the block shape each array ref sees (zeros or empty: the whole
        array).  Program ``pid`` sees block ``pid[d]`` along each of the
        leading dims that the grid and the block share.  Outputs are fresh
        buffers that replace the output arrays' data."""
        if shared_mem:
            raise ValueError("shared_mem has no Pallas analog; pass 0, or use "
                             "CudaModule for a kernel on the card")
        if len(args) != len(self._spec):
            raise ValueError(f"kernel {self._name} expects {len(self._spec)} "
                             f"args, got {len(args)}")
        on_card = [a for a in args if getattr(a, "context", None) is not None
                   and a.context.device_type == "gpu"]
        if (ctx is not None and Context(ctx).device_type == "gpu") or on_card:
            raise MXNetError("PallasKernel runs on the CPU; on the card, "
                             "compile CUDA C with mx.rtc.CudaModule")
        grid = tuple(int(g) for g in grid_dims)
        while grid and grid[-1] == 1:
            grid = grid[:-1]
        block = tuple(int(b) for b in (block_dims or ()) if int(b) > 0)
        nb = min(len(grid), len(block))

        values, outs = [], []
        for (name, dtype, kind), arg in zip(self._spec, args):
            if kind == "scalar":
                values.append(_scalar(arg, dtype))
                continue
            t = _check_array(name, arg, dtype)
            if kind == "in":
                values.append(t.detach().clone())
            else:
                values.append(torch.zeros_like(t, requires_grad=False))
                outs.append((arg, values[-1]))
        if not outs:
            raise ValueError("kernel signature declares no output (non-const "
                             "pointer) argument")

        def ref(v, pid):
            if not isinstance(v, torch.Tensor) or not block:
                return v
            idx = tuple(slice(pid[d] * block[d], (pid[d] + 1) * block[d])
                        if d < nb else slice(0, block[d])
                        for d in range(len(block)))
            return v[idx]

        with torch.no_grad():
            for pid in itertools.product(*(range(g) for g in grid)):
                try:
                    self._fn(*(ref(v, pid) for v in values))
                except NameError as e:
                    raise _explained(e) from None
        for arg, buf in outs:
            arg._set_data(buf)
        targets = [a for a, _ in outs]
        return targets[0] if len(targets) == 1 else targets


class PallasModule:
    """Kernel source in Python over refs (the JAX package's
    ``PallasModule``), run as the plain version of :class:`CudaModule`."""

    def __init__(self, source: str, options: Sequence[str] = (),
                 exports: Sequence[str] = ()):
        namespace = {"torch": torch, "np": np}
        try:
            exec(compile(source, "<mx.rtc source>", "exec"), namespace)  # noqa: S102 — user kernel source, by design
        except NameError as e:
            raise _explained(e) from None
        self._namespace = namespace
        self._exports = list(exports)
        for name in self._exports:
            if not callable(namespace.get(name)):
                raise ValueError(f"export {name!r} is not defined by the "
                                 "kernel source")

    def get_kernel(self, name: str, signature: str) -> PallasKernel:
        """Bind an exported kernel function to a C-style signature
        (reference rtc.py:112)."""
        fn = self._namespace.get(name)
        if not callable(fn):
            raise ValueError(f"kernel {name!r} not found in module source")
        if self._exports and name not in self._exports:
            raise ValueError(f"kernel {name!r} not in exports {self._exports}")
        return PallasKernel(fn, name, _parse_signature(signature))
