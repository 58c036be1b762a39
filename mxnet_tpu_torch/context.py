"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default device is ``cuda``, and asking for CUDA where there is none raises
instead of quietly running on the host.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from .base import MXNetError

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``cuda``.
    Raises :class:`MXNetError` for a CUDA device when CUDA is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError(
            "CUDA is not available; pass device='cpu' to run on the host")
    return dev
