"""Reusable host staging buffers for the generation step loop and the
dynamic batcher.

The scheduler rebuilds its token, position and length arrays every step,
and the batcher packs each batch's request rows; this pool hands back the
same preallocated numpy array for each (shape, dtype, tag), zero-filled on
reuse so a previous step's rows never leak into this one's padding.
``torch.as_tensor(buf).to(device)`` copies it to the card, so the buffer
is free again once that call returns.  Single owner (the scheduler under
its lock, or the batcher's worker thread): no internal locking.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

__all__ = ["HostBufferPool"]


# serving shapes are ladders, so more distinct staging shapes than this means
# something upstream mints unbounded shapes; dropping the oldest keeps the
# pool a cache, not a leak
MAX_BUFFERS = 64


class HostBufferPool:
    """Reusable host staging arrays keyed by (shape, dtype, tag)."""

    def __init__(self):
        self._bufs: Dict[Tuple, np.ndarray] = {}

    def get(self, shape, dtype, tag: str = "", zero: bool = True
            ) -> np.ndarray:
        """A preallocated array of ``shape``/``dtype``, zeroed on reuse
        unless ``zero`` is False (the caller overwrites every row).
        ``tag`` separates buffers alive at the same time with the same
        shape and dtype."""
        key = (tuple(int(s) for s in shape), str(np.dtype(dtype)), tag)
        buf = self._bufs.get(key)
        if buf is None:
            if len(self._bufs) >= MAX_BUFFERS:
                self._bufs.pop(next(iter(self._bufs)))
            buf = np.zeros(key[0], np.dtype(dtype))
            self._bufs[key] = buf
        elif zero:
            buf.fill(0)
        return buf
