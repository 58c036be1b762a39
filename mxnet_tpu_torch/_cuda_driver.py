"""ctypes bindings to NVRTC and the CUDA driver API, for ``mx.rtc``.

NVRTC (``libnvrtc.so`` of the CUDA toolkit) compiles CUDA C source at run
time straight to a CUBIN for the card's architecture; the driver
(``libcuda.so.1``) loads the CUBIN into the device's primary context, the
one PyTorch's runtime uses, and launches its kernels on a PyTorch stream.
A CUBIN rather than PTX: a toolkit newer than the driver may emit PTX the
driver refuses (``CUDA_ERROR_UNSUPPORTED_PTX_VERSION``).  Neither library
is loaded until the first call; every call checks its return code and
raises :class:`MXNetError` with the library's message (and, for a failed
compilation, NVRTC's log).
"""
from __future__ import annotations

import ctypes
import glob
import os
import threading
from typing import Dict, List, Sequence, Tuple

import torch

from .base import MXNetError

__all__ = ["compile_cubin", "load_module", "get_function", "launch",
           "set_max_dynamic_smem", "toolkit_include", "nvrtc_version"]

# CUfunction_attribute (cuda.h)
_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8

_lock = threading.RLock()
_libs: Dict[str, ctypes.CDLL] = {}
_contexts: Dict[int, ctypes.c_void_p] = {}


def _toolkit() -> str:
    return os.environ.get("CUDA_HOME") or "/usr/local/cuda"


def toolkit_include() -> str:
    """The toolkit's include directory (``cuda_fp16.h``, ``cuda_bf16.h``),
    or "" when there is none."""
    inc = os.path.join(_toolkit(), "include")
    return inc if os.path.isdir(inc) else ""


def _load(kind: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(kind)
        if lib is not None:
            return lib
        if kind == "cuda":
            candidates = ["libcuda.so.1", "libcuda.so"]
        else:
            found = sorted(glob.glob(os.path.join(
                _toolkit(), "lib64", "libnvrtc.so*")), key=len)
            candidates = found + ["libnvrtc.so", "libnvrtc.so.12"]
        errors = []
        for name in candidates:
            try:
                lib = ctypes.CDLL(name)
                break
            except OSError as e:
                errors.append(str(e))
        else:
            raise MXNetError(f"cannot load lib{kind} ({'; '.join(errors)})")
        _declare(kind, lib)
        _libs[kind] = lib
        return lib


def _declare(kind, lib):
    P, I, S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    CP, U = ctypes.c_char_p, ctypes.c_uint
    sigs = {
        "nvrtc": {
            "nvrtcGetErrorString": ([I], CP),
            "nvrtcVersion": ([ctypes.POINTER(I), ctypes.POINTER(I)], I),
            "nvrtcCreateProgram": ([ctypes.POINTER(P), CP, CP, I, P, P], I),
            "nvrtcAddNameExpression": ([P, CP], I),
            "nvrtcCompileProgram": ([P, I, ctypes.POINTER(CP)], I),
            "nvrtcGetProgramLogSize": ([P, ctypes.POINTER(S)], I),
            "nvrtcGetProgramLog": ([P, CP], I),
            "nvrtcGetCUBINSize": ([P, ctypes.POINTER(S)], I),
            "nvrtcGetCUBIN": ([P, CP], I),
            "nvrtcGetLoweredName": ([P, CP, ctypes.POINTER(CP)], I),
            "nvrtcDestroyProgram": ([ctypes.POINTER(P)], I),
        },
        "cuda": {
            "cuInit": ([U], I),
            "cuGetErrorString": ([I, ctypes.POINTER(CP)], I),
            "cuDeviceGet": ([ctypes.POINTER(I), I], I),
            "cuDevicePrimaryCtxRetain": ([ctypes.POINTER(P), I], I),
            "cuCtxSetCurrent": ([P], I),
            "cuModuleLoadData": ([ctypes.POINTER(P), P], I),
            "cuModuleGetFunction": ([ctypes.POINTER(P), P, CP], I),
            "cuFuncSetAttribute": ([P, I, I], I),
            "cuLaunchKernel": ([P, U, U, U, U, U, U, U, P,
                                ctypes.POINTER(P), P], I),
        },
    }[kind]
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res


def _nvrtc_check(code: int, what: str, log: str = "") -> None:
    if code:
        msg = _load("nvrtc").nvrtcGetErrorString(code).decode()
        raise MXNetError(f"NVRTC {what} failed: {msg}" +
                         (f"\n{log}" if log else ""))


def _cu_check(code: int, what: str) -> None:
    if code:
        s = ctypes.c_char_p()
        _load("cuda").cuGetErrorString(code, ctypes.byref(s))
        raise MXNetError(f"CUDA driver {what} failed: error {code} "
                         f"({(s.value or b'?').decode()})")


def nvrtc_version() -> Tuple[int, int]:
    major, minor = ctypes.c_int(), ctypes.c_int()
    _nvrtc_check(_load("nvrtc").nvrtcVersion(ctypes.byref(major),
                                             ctypes.byref(minor)), "version")
    return major.value, minor.value


def compile_cubin(source: str, options: Sequence[str],
                  name_expressions: Sequence[str] = ()
                  ) -> Tuple[bytes, Dict[str, str], str]:
    """Compile ``source`` with NVRTC; returns the CUBIN, the lowered
    (mangled) name of each of ``name_expressions``, and the compiler log.
    Raises with the log when compilation fails."""
    lib = _load("nvrtc")
    prog = ctypes.c_void_p()
    _nvrtc_check(lib.nvrtcCreateProgram(ctypes.byref(prog), source.encode(),
                                        b"mx_rtc.cu", 0, None, None),
                 "nvrtcCreateProgram")
    try:
        for expr in name_expressions:
            _nvrtc_check(lib.nvrtcAddNameExpression(prog, expr.encode()),
                         f"nvrtcAddNameExpression({expr!r})")
        opts = (ctypes.c_char_p * len(options))(*(o.encode() for o in options))
        code = lib.nvrtcCompileProgram(prog, len(options), opts)
        size = ctypes.c_size_t()
        lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
        buf = ctypes.create_string_buffer(size.value)
        lib.nvrtcGetProgramLog(prog, buf)
        log = buf.value.decode(errors="replace")
        _nvrtc_check(code, "compilation", log)
        _nvrtc_check(lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _nvrtc_check(lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        lowered = {}
        for expr in name_expressions:
            out = ctypes.c_char_p()
            _nvrtc_check(lib.nvrtcGetLoweredName(prog, expr.encode(),
                                                 ctypes.byref(out)),
                         f"nvrtcGetLoweredName({expr!r})")
            lowered[expr] = out.value.decode()
        return cubin.raw, lowered, log
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


def _make_current(device: torch.device) -> None:
    """Make ``device``'s primary context (PyTorch's) current on this
    thread."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    lib = _load("cuda")
    with _lock:
        ctx = _contexts.get(idx)
        if ctx is None:
            torch.cuda.init()
            torch.cuda.synchronize(idx)  # PyTorch's context exists from here
            _cu_check(lib.cuInit(0), "cuInit")
            dev = ctypes.c_int()
            _cu_check(lib.cuDeviceGet(ctypes.byref(dev), idx), "cuDeviceGet")
            ctx = ctypes.c_void_p()
            _cu_check(lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
                      "cuDevicePrimaryCtxRetain")
            _contexts[idx] = ctx
    _cu_check(lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")


def load_module(cubin: bytes, device: torch.device) -> ctypes.c_void_p:
    """Load ``cubin`` into ``device``'s primary context; the CUmodule."""
    _make_current(device)
    module = ctypes.c_void_p()
    _cu_check(_load("cuda").cuModuleLoadData(ctypes.byref(module), cubin),
              "cuModuleLoadData")
    return module


def get_function(module: ctypes.c_void_p, name: str) -> ctypes.c_void_p:
    """The kernel ``name`` (its lowered name) of a loaded module."""
    fn = ctypes.c_void_p()
    _cu_check(_load("cuda").cuModuleGetFunction(ctypes.byref(fn), module,
                                                name.encode()),
              f"cuModuleGetFunction({name!r})")
    return fn


def set_max_dynamic_smem(fn: ctypes.c_void_p, nbytes: int) -> None:
    """Let ``fn`` take ``nbytes`` of dynamic shared memory (needed above
    48 KB)."""
    _cu_check(_load("cuda").cuFuncSetAttribute(
        fn, _MAX_DYNAMIC_SHARED_SIZE_BYTES, int(nbytes)),
        "cuFuncSetAttribute(MAX_DYNAMIC_SHARED_SIZE_BYTES)")


def launch(fn: ctypes.c_void_p, grid: Sequence[int], block: Sequence[int],
           shared_mem: int, stream: torch.cuda.Stream,
           args: List[ctypes._SimpleCData]) -> None:
    """``cuLaunchKernel`` of ``fn`` on ``stream``; ``args`` are the kernel's
    parameters as ctypes values, each of its declared C type."""
    _make_current(stream.device)
    params = (ctypes.c_void_p * max(len(args), 1))(
        *(ctypes.cast(ctypes.byref(a), ctypes.c_void_p) for a in args))
    _cu_check(_load("cuda").cuLaunchKernel(
        fn, *(int(g) for g in grid), *(int(b) for b in block),
        int(shared_mem), ctypes.c_void_p(stream.cuda_stream), params, None),
        "cuLaunchKernel")
