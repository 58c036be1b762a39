"""Seeded random streams: one :class:`torch.Generator` per device.

The JAX package keys a global threefry stream (``mxnet_tpu/random.py``).
The port keeps one generator per device instead: :func:`seed` (the
reference's ``mx.random.seed``) reseeds every device's stream, and
:func:`device_generator` gives the stream of a device, which Gluon's
initializers and ``Dropout`` draw from.  Code that wants a stream of its
own passes an explicit generator (:func:`generator`); a ``Dropout`` that
holds one is kept here by weak reference, so a Trainer snapshot rewinds
its generator with the device streams (the JAX package's one global
stream is what its snapshot rewinds).  The same seed
gives other bits than JAX's, so tests copy weights across rather than
compare draws.

A CUDA graph replays the random numbers of its capture unless the
generator it drew from is registered with it; the JAX package passes "a
fresh threefry key as an input" for the same reason.  A capture registers
its device's stream (``CUDAGraph.register_generator_state``), so each
replay draws fresh bits and advances the stream as an eager call would.  :func:`seed` reseeds
the streams in place, so the graphs they are registered with follow it.
"""
from __future__ import annotations

import weakref
from typing import Dict, List, Optional, Union

import torch

from .context import resolve_device

__all__ = ["generator", "seed", "device_generator"]

_seed = 0
_streams: Dict[str, torch.Generator] = {}
_holders: "weakref.WeakSet" = weakref.WeakSet()  # Dropout blocks


def _new(device: torch.device, seed_state: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed_state))
    return gen


def generator(seed: int, device: Optional[Union[str, torch.device]] = None
              ) -> torch.Generator:
    """A generator on ``device`` (default ``cuda``) seeded with ``seed``."""
    return _new(resolve_device(device), seed)


def _all_streams() -> List[torch.Generator]:
    """Every device's stream, then the generator of every live block that
    holds one of its own."""
    gens = list(_streams.values())
    for block in list(_holders):
        g = getattr(block, "generator", None)
        if isinstance(g, torch.Generator) and all(g is not h for h in gens):
            gens.append(g)
    return gens


def seed(seed_state: int, ctx=None) -> None:
    """Restart every device's stream from ``seed_state`` (reference
    ``mx.random.seed``; ``ctx`` is accepted and, as in the JAX package,
    every device is reseeded)."""
    global _seed
    _seed = int(seed_state)
    for gen in _streams.values():
        gen.manual_seed(_seed)


def device_generator(device: Union[str, torch.device]) -> torch.Generator:
    """The stream of ``device``, started from the last :func:`seed` (0 if
    none) at its first use."""
    dev = torch.device(device)
    key = str(dev)
    gen = _streams.get(key)
    if gen is None:
        gen = _streams[key] = _new(dev, _seed)
    return gen

