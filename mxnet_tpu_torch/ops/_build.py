"""Build the port's CUDA kernels from ``mxnet_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with :mod:`ctypes`; no source
includes PyTorch's headers, so a build takes seconds.  Libraries land in
``build/torch_kernels/`` at the root of the checkout, named by a hash of
their source, the ``csrc/*.cuh`` headers it includes and the compiler
flags, so an edited kernel, header or flag is rebuilt and a stale library
never loads.
A failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

from ..base import MXNetError

__all__ = ["KERNEL_SOURCES", "build", "load"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNEL_SOURCES = ("flash_fwd", "flash_fwd_tf32", "flash_fwd_wgmma",
                  "fused_conv_bn", "fused_conv_bn_wgmma", "embedding_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise MXNetError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                     "port's CUDA kernels are built from source at first use")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _local_headers(src: Path) -> list:
    """The ``csrc`` headers ``src`` includes with quotes, and theirs, in
    the order first met."""
    seen, todo = [], [src]
    while todo:
        for name in _LOCAL_INCLUDE.findall(todo.pop(0).read_bytes()):
            header = src.parent / name.decode()
            if header.exists() and header not in seen:
                seen.append(header)
                todo.append(header)
    return seen


def library_path(name: str) -> Path:
    """``build/torch_kernels/lib<name>-<hash>.so``; the hash covers
    ``csrc/<name>.cu``, every local header it includes and ``NVCC_FLAGS``."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for path in [src] + _local_headers(src):
        h.update(b"\0" + path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, Path]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together.  Returns the path
    of each library; the compiler's output (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside it as ``<library>.log``."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        out.with_name(out.name + ".log").write_text(log)
        if proc.returncode:
            failures.append(f"nvcc failed for csrc/{name}.cu "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise MXNetError("\n".join(failures))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _loaded[name] = lib
        return lib
