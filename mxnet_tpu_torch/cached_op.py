"""CachedOp: the per-signature cache of a hybridized block.

Counterpart of ``mxnet_tpu/cached_op.py`` (reference
``src/imperative/cached_op.{h,cc}``).  The cache is keyed as the JAX
package keys it: the inputs' shapes and dtypes, the training flag and
each parameter's ``(name, grad_req)``.  A signature's first call is a miss
that makes its entry; later calls are hits.  ``cache_stats`` is what the
serving engine reports: a bucket-ladder server shows one miss per rung,
all at warmup, and only hits after.

Where the JAX package traces a signature into one XLA program, an entry
here is its signature alone, and every call runs the block's forward
eagerly (torch's own autograd records it under ``mx.autograd.record()``).
Capturing an entry as a CUDA graph is later work.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

from . import autograd
from .ndarray.ndarray import NDArray

__all__ = ["CachedOp"]


class CachedOp:
    def __init__(self, forward_fn: Callable, params: Sequence):
        """``forward_fn(*nd_inputs)`` -> NDArray or a list of them, reading
        ``params`` (Gluon Parameters) itself."""
        self._fwd = forward_fn
        self._params = list(params)
        self._cache: Dict[Any, None] = {}  # the signatures, in order
        self._hits = 0
        self._misses = 0

    @property
    def cache_stats(self) -> Dict[str, Any]:
        """``entries``, ``hits``, ``misses`` and the cached
        ``signatures``."""
        return {"entries": len(self._cache), "hits": self._hits,
                "misses": self._misses,
                "signatures": list(self._cache.keys())}

    def _signature(self, inputs: Sequence[NDArray], training: bool):
        # grad_req is part of the key: a fine-tune unfreeze (null -> write)
        # changes what the forward records
        return (tuple((x.shape, str(x.dtype)) for x in inputs), training,
                tuple((p.name, p.grad_req) for p in self._params))

    def __call__(self, *inputs: NDArray):
        sig = self._signature(inputs, autograd.is_training())
        if sig in self._cache:
            self._hits += 1
        else:
            self._misses += 1
            self._cache[sig] = None
        return self._fwd(*inputs)
