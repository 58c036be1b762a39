"""Device meshes (counterpart of ``mxnet_tpu/parallel/mesh.py``).

The JAX package names its parallelism as the axes of a
``jax.sharding.Mesh`` driven by one controller; the port keeps that
model.  A :class:`DeviceMesh` is a grid of *positions* with named axes,
each position a ``torch.device``.  One process drives every position:
:func:`~mxnet_tpu_torch.parallel.collectives.shard_map` runs a body over
the positions in lockstep, and every movement of data between positions
is an explicit call of the collectives there.

Several positions may name the same device (``[torch.device("cuda")] *
4``, or ``[torch.device("cpu")] * 8`` as the tests fake 8 devices), so a
mesh's semantics, the shapes each position sees and its memory can be
held on one card; positions on one device share its memory and its
stream, so such a mesh measures no interconnect.

Axis names used throughout: ``dp`` data, ``fsdp`` parameter sharding,
``tp`` tensor, ``pp`` pipeline stages, ``sp`` sequence, ``ep`` experts.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["AXIS_ORDER", "DeviceMesh", "make_mesh", "current_mesh",
           "default_mesh", "PartitionSpec", "NamedSharding", "param_layouts",
           "layout_of"]

# the JAX package's order: tp innermost
AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "sp", "tp")

_state = threading.local()


class PartitionSpec(tuple):
    """Per-dimension mesh axes (a name, a tuple of names, or None), as
    ``jax.sharding.PartitionSpec``: ``PartitionSpec("dp", None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


class NamedSharding:
    """A :class:`PartitionSpec` over a :class:`DeviceMesh`."""

    def __init__(self, mesh: "DeviceMesh", spec: PartitionSpec):
        self.mesh, self.spec = mesh, PartitionSpec(*spec)

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __hash__(self):
        return hash((id(self.mesh), self.spec))

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def _visible_devices():
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


class DeviceMesh:
    """Named axes over positions.  ``devices`` (default: the visible
    cards, else one CPU) gives each position its device in row-major
    order over the axes, which follow :data:`AXIS_ORDER`; a mesh larger
    than ``devices`` raises, so positions that share a device are passed
    explicitly."""

    def __init__(self, axes: Dict[str, int],
                 devices: Optional[Sequence] = None):
        devices = [torch.device(d) for d in
                   (devices if devices is not None else _visible_devices())]
        sizes = {k: int(v) for k, v in axes.items() if int(v) > 0}
        n = math.prod(sizes.values()) if sizes else 1
        if n > len(devices):
            raise ValueError(f"mesh {sizes} needs {n} devices, have "
                             f"{len(devices)}")
        names = tuple(a for a in AXIS_ORDER if a in sizes) + tuple(
            a for a in sizes if a not in AXIS_ORDER)
        self.axes = {a: sizes[a] for a in names}
        self._devices = devices[:n]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.axes)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)

    def axis_size(self, name: str) -> int:
        return self.axes.get(name, 1)

    @property
    def size(self) -> int:
        return len(self._devices)

    @property
    def devices(self):
        """Each position's device, in row-major order over the axes."""
        return list(self._devices)

    def device_grid(self) -> np.ndarray:
        """The positions' devices as an array of the mesh's shape."""
        grid = np.empty(len(self._devices), dtype=object)
        grid[:] = self._devices
        return grid.reshape(tuple(self.axes.values()) or ())

    def sharding(self, *spec) -> NamedSharding:
        """A :class:`NamedSharding` from a spec; axis names this mesh lacks
        are dropped, so rules may name axes a small mesh does not have."""
        clean = []
        for entry in spec:
            if entry is None:
                clean.append(None)
            elif isinstance(entry, (tuple, list)):
                kept = tuple(a for a in entry if a in self.axes)
                clean.append(kept if kept else None)
            else:
                clean.append(entry if entry in self.axes else None)
        return NamedSharding(self, PartitionSpec(*clean))

    def replicated(self) -> NamedSharding:
        return NamedSharding(self, PartitionSpec())

    def __enter__(self):
        stack = getattr(_state, "stack", None)
        if stack is None:
            stack = _state.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _state.stack.pop()
        return False

    def __repr__(self):
        return f"DeviceMesh({self.axes})"


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """A mesh; by default pure data parallelism over every device."""
    if axes is None:
        axes = {"dp": len(devices) if devices is not None
                else len(_visible_devices())}
    return DeviceMesh(axes, devices)


def current_mesh() -> Optional[DeviceMesh]:
    """The innermost mesh entered with ``with mesh:`` on this thread."""
    stack = getattr(_state, "stack", None)
    return stack[-1] if stack else None


_default: Optional[DeviceMesh] = None


def default_mesh() -> DeviceMesh:
    """The entered mesh, else a process-wide ``dp`` mesh over every
    visible device (built lazily)."""
    global _default
    active = current_mesh()
    if active is not None:
        return active
    if _default is None or _default.size != len(_visible_devices()):
        _default = make_mesh()
    return _default


@contextlib.contextmanager
def param_layouts(specs: Dict[int, PartitionSpec]):
    """Within the block, :func:`layout_of` gives the spec recorded for a
    tensor (``specs`` is keyed by ``id``): how a training step over a mesh
    tells the sharded ops where its parameters lie."""
    prev = getattr(_state, "layouts", None)
    _state.layouts = specs
    try:
        yield
    finally:
        _state.layouts = prev


def layout_of(tensor) -> Optional[PartitionSpec]:
    """The spec :func:`param_layouts` recorded for ``tensor``, else None."""
    layouts = getattr(_state, "layouts", None)
    return None if layouts is None else layouts.get(id(tensor))
