"""Custom-kernel registry: how an op with hand-written kernels picks its
implementation, and how a user injects a kernel of their own.

Counterpart of ``mxnet_tpu/ops/kernels.py`` (the reference's
``SubgraphProperty``/``MXLoadLib`` hook).  Entries are (predicate, impl,
priority) per op name; the highest-priority entry whose predicate accepts
the call wins.  The port registers its CUDA kernels at priority 10 on the
``"cuda"`` platform (``ops/attention.py``, ``ops/fused_conv_bn.py``), as
the JAX package registers its Pallas ones on ``"tpu"``.  The platform of a
call is its tensor's device (``"cuda"``, ``"cpu"``, ``"meta"``), never a
process-wide backend.  No entry claims a CPU call by default, and the op
then runs its plain PyTorch version; a CUDA call that no entry claims
raises in the op (no plain version on the card).

``MXNET_KERNEL_BACKEND`` forces the choice: ``auto`` (the default) picks
by device; ``cuda`` keeps only the ``"cuda"`` entries and refuses a CPU
call; ``xla``, ``torch`` and ``interpret`` mean the plain version on CPU
tensors and raise :class:`MXNetError` on a CUDA tensor.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, NamedTuple, Optional

from ..base import MXNetError

__all__ = ["register_kernel", "lookup_kernel", "list_kernels",
           "current_platform"]

_PLAIN_BACKENDS = ("xla", "torch", "interpret")


class _Entry(NamedTuple):
    impl: Callable
    predicate: Callable[..., bool]
    priority: int
    name: str
    platform: str


_KERNELS: Dict[str, List[_Entry]] = {}


def current_platform(tensor=None) -> str:
    """The platform of a call: its tensor's device type (``"cuda"``,
    ``"cpu"`` or ``"meta"``).  Without a tensor, the device of the
    current default context (``mx.gpu(0)`` unless set)."""
    if tensor is not None:
        return tensor.device.type
    from ..context import current_context
    return "cuda" if current_context().device_type == "gpu" else "cpu"


def register_kernel(op_name: str, *, platform: str = "cuda",
                    priority: int = 0, predicate: Optional[Callable] = None,
                    name: str = ""):
    """Decorator: register ``impl`` as a kernel for ``op_name`` on
    ``platform`` (``"cuda"``, ``"cpu"`` or ``"any"``).

    ``predicate(**call_info)`` may further gate on the call (the ops pass
    ``dtype``, shapes and flags); it is asked only for calls on the
    entry's platform."""

    def deco(impl: Callable) -> Callable:
        def pred(**info) -> bool:
            plat = info.get("platform")
            if platform != "any" and plat != platform:
                return False
            return predicate(**info) if predicate is not None else True

        entries = _KERNELS.setdefault(op_name, [])
        entries.append(_Entry(impl, pred, priority, name or impl.__name__,
                              platform))
        entries.sort(key=lambda e: -e.priority)
        return impl

    return deco


def _backend() -> str:
    forced = os.environ.get("MXNET_KERNEL_BACKEND", "auto") or "auto"
    if forced not in ("auto", "cuda") + _PLAIN_BACKENDS:
        raise MXNetError(f"MXNET_KERNEL_BACKEND={forced!r}: expected auto, "
                         f"cuda, {', '.join(_PLAIN_BACKENDS)}")
    return forced


def lookup_kernel(op_name: str, **call_info) -> Optional[Callable]:
    """The kernel that claims this call, or None: the op then runs its
    plain version, which it may only do on a CPU or ``meta`` tensor.
    ``call_info`` carries ``platform`` (from :func:`current_platform`)
    and whatever the op describes its call with."""
    plat = call_info.setdefault("platform", current_platform())
    if plat == "meta":
        return None  # shape inference: the plain version's shapes
    forced = _backend()
    if forced in _PLAIN_BACKENDS:
        if plat == "cuda":
            raise MXNetError(
                f"{op_name}: MXNET_KERNEL_BACKEND={forced} asks for the "
                "plain version, which never runs on a CUDA tensor")
        return None
    if forced == "cuda" and plat != "cuda":
        raise MXNetError(f"{op_name}: MXNET_KERNEL_BACKEND=cuda forces the "
                         f"CUDA kernels, but the call is on {plat}")
    for entry in _KERNELS.get(op_name, ()):
        if forced == "cuda" and entry.platform != "cuda":
            continue
        if entry.predicate(**call_info):
            return entry.impl
    return None


def list_kernels() -> Dict[str, List[str]]:
    """Registered kernel names per op, highest priority first."""
    return {op: [e.name for e in entries] for op, entries in _KERNELS.items()}
