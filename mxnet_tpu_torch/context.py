"""Device contexts and device resolution.

Counterpart of ``mxnet_tpu/context.py``.  A :class:`Context` names a torch
device: ``cpu(i)`` the host, ``gpu(i)`` the CUDA card ``i``; ``tpu(i)`` is
kept as an alias of the accelerator, as the JAX package keeps ``gpu(i)``;
``cpu_pinned(i)`` is the host in page-locked memory, which the card copies
from asynchronously.

Entry points run on the card unless the caller asks for the CPU: the
default context is ``gpu(0)``, and placing data on a card where there is
none raises :class:`MXNetError` instead of quietly running on the host (the
JAX package falls back to ``cpu(0)``).  ``with ctx:`` scopes are
thread-local; :func:`set_default_context` is process-wide.
"""
from __future__ import annotations

import threading
from typing import Optional, Union

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "cpu_pinned", "gpu", "tpu", "current_context",
           "set_default_context", "num_gpus", "gpu_memory_info",
           "resolve_device"]

_tls = threading.local()


class Context:
    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned"}
    devstr2type = {"cpu": 1, "gpu": 2, "tpu": 2, "cpu_pinned": 3}

    def __init__(self, device_type: Union[str, "Context"], device_id: int = 0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, device_type.device_id
        if device_type not in self.devstr2type:
            raise ValueError(f"unknown device type {device_type!r}")
        self.device_typeid = self.devstr2type[device_type]
        self.device_id = int(device_id)

    @property
    def device_type(self) -> str:
        return self.devtype2str[self.device_typeid]

    def torch_device(self) -> torch.device:
        """The torch device this context names; raises for a card that
        this process cannot see."""
        if self.device_typeid != 2:
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                f"{self}: CUDA is not available; use mx.cpu() to run on the "
                "host")
        if self.device_id >= torch.cuda.device_count():
            raise MXNetError(f"{self}: only {torch.cuda.device_count()} CUDA "
                             "device(s)")
        return torch.device("cuda", self.device_id)

    @classmethod
    def of(cls, device: torch.device) -> "Context":
        """The context of a torch device."""
        if device.type == "cuda":
            return cls("gpu", device.index or 0)
        return cls("cpu", 0)

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def __enter__(self):
        if not hasattr(_tls, "stack"):
            _tls.stack = []
        _tls.stack.append(self)
        return self

    def __exit__(self, *exc):
        _tls.stack.pop()


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def cpu_pinned(device_id: int = 0) -> Context:
    """The host in page-locked memory: an NDArray made on it holds a
    pinned CPU tensor where a card exists to pin for (CPU-only torch has
    nothing to pin, and there it is a plain CPU tensor)."""
    return Context("cpu_pinned", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def tpu(device_id: int = 0) -> Context:
    """Alias of :func:`gpu`: scripts written for the JAX package's
    accelerator context land on the card."""
    return Context("tpu", device_id)


def num_gpus() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def gpu_memory_info(device_id: int = 0):
    """``(free, total)`` bytes of card ``device_id`` (reference
    ``context.py gpu_memory_info`` → ``cudaMemGetInfo``): one
    implementation, ``util.get_gpu_memory``."""
    from .util import get_gpu_memory
    return get_gpu_memory(device_id)


# process-wide default (set_default_context); `with ctx:` scopes layered on
# top stay thread-local
_process_default: Optional[Context] = None


def set_default_context(ctx: Optional[Context]) -> Optional[Context]:
    """Set the process-wide default context (``None`` restores
    ``gpu(0)``); returns the previous setting."""
    global _process_default
    prev, _process_default = _process_default, ctx
    return prev


def current_context() -> Context:
    stack = getattr(_tls, "stack", None)
    if stack:
        return stack[-1]
    if _process_default is not None:
        return _process_default
    return Context("gpu", 0)


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``cuda``.
    Raises :class:`MXNetError` for a CUDA device when CUDA is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError(
            "CUDA is not available; pass device='cpu' to run on the host")
    return dev
