"""Seeded random streams: one explicit :class:`torch.Generator` per use,
created on the device the numbers are drawn on.

The JAX package keys a global threefry stream (``mxnet_tpu/random.py``);
the port passes generators explicitly instead.  The same seed gives other
bits than JAX's, so tests copy weights across rather than compare draws.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from .context import resolve_device

__all__ = ["generator"]


def generator(seed: int, device: Optional[Union[str, torch.device]] = None
              ) -> torch.Generator:
    """A generator on ``device`` (default ``cuda``) seeded with ``seed``."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    return gen
