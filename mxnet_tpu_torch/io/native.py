"""ctypes binding of the native recordio reader (counterpart of
``mxnet_tpu/io/native.py``).

Its C++ is ``mxnet_tpu_torch/csrc/recordio_core.cc``.  The shared library
is built at first use with the system ``g++`` into ``build/torch_kernels/``
at the root of the checkout, named by a hash of the source and the flags,
so an edited source is rebuilt and a stale library never loads.  Where the
toolchain or the build is missing, :func:`available` is false and
``recordio`` reads through its Python reader, which gives the same bytes;
only the batched read's speed differs.

A ctypes call releases the GIL, so a prefetch thread's ``read_batch``
overlaps the decode threads and the step on the card.

``MXNET_TPU_NO_NATIVE=1`` turns the native path off.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..base import env as _env

__all__ = ["available", "index_file", "payload_size", "read_batch",
           "write_batch", "library_path"]

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "recordio_core.cc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_FLAGS = ("-O2", "-std=c++14", "-shared", "-fPIC")
_ERRCAP = 512

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """``build/torch_kernels/libmxtpu_recordio-<hash>.so``; the hash
    covers the source and the flags."""
    h = hashlib.sha256("\0".join(_FLAGS).encode() + b"\0"
                       + _SRC.read_bytes())
    return _BUILD_DIR / f"libmxtpu_recordio-{h.hexdigest()[:12]}.so"


def _build(lib: Path) -> bool:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a process-unique path, then publish atomically: another
    # process's first use must never load a half-written library
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        res = subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                             capture_output=True, timeout=120)
        if res.returncode != 0 or not tmp.exists():
            return False
        os.replace(tmp, lib)
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        if tmp.exists():
            try:
                tmp.unlink()
            except OSError:
                pass
    return lib.exists()


def _load() -> Optional[ctypes.CDLL]:
    """Build (if needed), load and declare the signatures; ``None`` means
    the Python reader."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if _env.MXNET_TPU_NO_NATIVE:
            return None
        if not _SRC.exists():
            return None
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
            lib.mxtpu_rio_index.restype = ctypes.c_longlong
            lib.mxtpu_rio_index.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64)),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32)),
                ctypes.c_char_p, ctypes.c_size_t]
            lib.mxtpu_rio_free.argtypes = [ctypes.c_void_p]
            lib.mxtpu_rio_read_batch.restype = ctypes.c_longlong
            lib.mxtpu_rio_read_batch.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_ubyte), ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_char_p,
                ctypes.c_size_t]
            lib.mxtpu_rio_payload_size.restype = ctypes.c_longlong
            lib.mxtpu_rio_payload_size.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
                ctypes.c_size_t]
            lib.mxtpu_rio_write_batch.restype = ctypes.c_int
            lib.mxtpu_rio_write_batch.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte),
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_char_p,
                ctypes.c_size_t]
            lib.mxtpu_rio_abi_version.restype = ctypes.c_int
            if lib.mxtpu_rio_abi_version() != 1:
                return None
        except (OSError, AttributeError):
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


# A small free-list of batch buffers: a fresh multi-MB np.empty faults in
# every page on each call.  read_batch copies the records out as bytes
# before it returns, so a buffer is checked out for one call only.
_buf_pool: List[np.ndarray] = []


def _take_buffer(total: int) -> np.ndarray:
    with _lock:
        for i, arr in enumerate(_buf_pool):
            if arr.size >= total:
                return _buf_pool.pop(i)
    return np.empty(max(total, 1), np.uint8)


def _return_buffer(arr: np.ndarray) -> None:
    with _lock:
        if len(_buf_pool) < 4:
            _buf_pool.append(arr)


def index_file(path: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Scan a .rec file: (payload offsets u64, sizes u32), or ``None``
    without the native library."""
    lib = _load()
    if lib is None:
        return None
    off_p = ctypes.POINTER(ctypes.c_uint64)()
    size_p = ctypes.POINTER(ctypes.c_uint32)()
    err = ctypes.create_string_buffer(_ERRCAP)
    n = lib.mxtpu_rio_index(path.encode(), ctypes.byref(off_p),
                            ctypes.byref(size_p), err, _ERRCAP)
    if n < 0:
        raise IOError(f"recordio index scan failed: {err.value.decode()}")
    try:
        offsets = (np.ctypeslib.as_array(off_p, shape=(n,)).copy() if n
                   else np.empty(0, np.uint64))
        sizes = (np.ctypeslib.as_array(size_p, shape=(n,)).copy() if n
                 else np.empty(0, np.uint32))
    finally:
        if n:
            lib.mxtpu_rio_free(off_p)
            lib.mxtpu_rio_free(size_p)
    return offsets, sizes


def payload_size(path: str, record_offset: int) -> Optional[int]:
    lib = _load()
    if lib is None:
        return None
    err = ctypes.create_string_buffer(_ERRCAP)
    n = lib.mxtpu_rio_payload_size(path.encode(), record_offset, err,
                                   _ERRCAP)
    if n < 0:
        raise IOError(f"recordio header read failed: {err.value.decode()}")
    return int(n)


def read_batch(path: str, payload_offsets: Sequence[int],
               sizes: Sequence[int]) -> Optional[List[bytes]]:
    """Many payloads in one native call; ``None`` without the library."""
    lib = _load()
    if lib is None:
        return None
    offs = np.ascontiguousarray(payload_offsets, dtype=np.uint64)
    szs = np.ascontiguousarray(sizes, dtype=np.uint32)
    total = int(szs.sum())
    dest = _take_buffer(total)
    try:
        dest_offs = np.zeros(len(offs), np.uint64)
        err = ctypes.create_string_buffer(_ERRCAP)
        got = lib.mxtpu_rio_read_batch(
            path.encode(),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            szs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(offs),
            dest.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), total,
            dest_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), err,
            _ERRCAP)
        if got < 0:
            raise IOError(f"recordio batch read failed: "
                          f"{err.value.decode()}")
        # bytes, the Python reader's type
        return [dest[int(s):int(s) + int(n)].tobytes()
                for s, n in zip(dest_offs, szs)]
    finally:
        _return_buffer(dest)


def write_batch(path: str, payloads: Sequence[bytes]) -> Optional[np.ndarray]:
    """Append framed records in one native call; returns their record
    offsets (for the .idx file), or ``None`` without the library."""
    lib = _load()
    if lib is None:
        return None
    sizes = np.array([len(p) for p in payloads], np.uint32)
    blob = b"".join(payloads)
    buf = (ctypes.c_ubyte * max(len(blob), 1)).from_buffer_copy(
        blob if blob else b"\x00")
    rec_offs = np.zeros(len(payloads), np.uint64)
    err = ctypes.create_string_buffer(_ERRCAP)
    rc = lib.mxtpu_rio_write_batch(
        path.encode(), buf,
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(payloads),
        rec_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), err,
        _ERRCAP)
    if rc != 0:
        raise IOError(f"recordio batch write failed: {err.value.decode()}")
    return rec_offs
