"""Inference engine: a bucket ladder over a :class:`CachedOp`.

Counterpart of ``mxnet_tpu/serving/engine.py``.  Requests are padded up
to a fixed ladder of batch sizes (1/2/4/8/... up to ``max_batch``), so
arbitrary request sizes land on a handful of cache entries; ``warmup()``
runs every rung once at load time, after which live traffic only hits
(``cache_stats``: misses == len(ladder), all before the first request).
Where the JAX package compiles each rung, the engine's CachedOp captures
one CUDA graph per rung on the card (the largest rung first, so the
smaller ones reuse its memory pool), and every later batch replays its
rung's graph.  A padded batch is staged straight into the graph's static
input buffer (:meth:`InferenceEngine.staging`), which saves a copy.

Padding rows are zeros, made on the block's device.  In predict mode every
model-zoo op is row-independent (BatchNorm on its moving statistics,
Dropout the identity), so padding and co-batched requests cannot reach a
request's rows.

Each run opens a ``serving.engine.predict`` span (a child of the batcher's
``serving.batcher.execute``) inside a serving-owned goodput interval.  On
the card the span holds the replay's launch: the graph's work is still
queued when it ends.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as _np
import torch

from ..base import MXNetError, dtype_name, narrow_source
from ..cached_op import CachedOp
from ..context import Context, current_context
from ..ndarray import ndarray as _nd
from ..ndarray.ndarray import NDArray
from ..observability import goodput as _goodput, tracing as _tracing

__all__ = ["InferenceEngine", "bucket_ladder", "bucket_for"]


def bucket_ladder(max_batch: int) -> Tuple[int, ...]:
    """Powers of two below ``max_batch``, then ``max_batch`` itself."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    ladder = []
    b = 1
    while b < max_batch:
        ladder.append(b)
        b *= 2
    ladder.append(max_batch)
    return tuple(ladder)


def bucket_for(n: int, ladder: Sequence[int]) -> int:
    for b in ladder:
        if n <= b:
            return b
    raise MXNetError(f"request of {n} rows exceeds max bucket {ladder[-1]}")


class InferenceEngine:
    """Bucket-padded inference over an initialized Gluon block.

    ``input_spec`` is the per-input, per-sample ``(shape, dtype)`` (no
    batch axis); by default the block's captured ``input_signature()``
    without its leading axis, else the first request's.  Requests are
    placed on the device of the block's parameters."""

    def __init__(self, block, input_spec=None, max_batch: int = 8,
                 name: Optional[str] = None, stats=None):
        self._block = block
        self._ladder = bucket_ladder(max_batch)
        self.max_batch = max_batch
        self.name = name or getattr(block, "name", type(block).__name__)
        self._stats = stats
        self._lock = threading.RLock()
        self._initialized = False
        self._op = CachedOp(getattr(block, "_eager_forward", block),
                            list(block.collect_params().values()))
        if input_spec is None:
            sig = getattr(block, "input_signature", lambda: None)()
            if sig is not None:
                input_spec = [(tuple(shape[1:]), dt) for shape, dt in sig]
        self._input_spec = ([(tuple(s), dtype_name(d)) for s, d in input_spec]
                            if input_spec is not None else None)

    @classmethod
    def from_export(cls, prefix: str, epoch: int = 0, input_names=None,
                    ctx: Optional[Context] = None, **kwargs
                    ) -> "InferenceEngine":
        """An engine over the files of ``HybridBlock.export``
        (``{prefix}-symbol.json``, ``{prefix}-{epoch:04d}.params``, and
        the ``{prefix}-signature.json`` sidecar when present), its
        parameters on ``ctx`` (default: the current context)."""
        from ..gluon.block import SymbolBlock
        from ..symbol import load as sym_load
        sym = sym_load(f"{prefix}-symbol.json")
        with (ctx or current_context()):
            params = _nd.load(f"{prefix}-{epoch:04d}.params")
        pnames = {k.replace("arg:", "").replace("aux:", "") for k in params}
        if input_names is None:
            input_names = [a for a in sym.list_arguments() if a not in pnames]
        block = SymbolBlock(sym, list(input_names), params)
        sig_path = f"{prefix}-signature.json"
        if kwargs.get("input_spec") is None and os.path.exists(sig_path):
            with open(sig_path) as f:
                sig = json.load(f)["inputs"]
            kwargs["input_spec"] = [(tuple(e["shape"][1:]), e["dtype"])
                                    for e in sig]
        return cls(block, name=kwargs.pop("name", os.path.basename(prefix)),
                   **kwargs)

    # ------------------------------------------------------------ plumbing
    @property
    def ladder(self) -> Tuple[int, ...]:
        return self._ladder

    @property
    def block(self):
        """The block served (a ``SymbolBlock`` for an export)."""
        return self._block

    @property
    def input_spec(self):
        return self._input_spec

    @property
    def cache_stats(self) -> Dict[str, Any]:
        return self._op.cache_stats

    @property
    def context(self) -> Context:
        """The device of the block's parameters (the current context
        while none is allocated)."""
        for p in self._block.collect_params().values():
            if p._allocated():
                return Context.of(p._tensor().device)
        return current_context()

    def bucket_for(self, n: int) -> int:
        return bucket_for(n, self._ladder)

    def _check_spec(self, arrs) -> None:
        """Input count, per-sample shapes and dtypes against the spec,
        one batch size, at least one row."""
        if self._input_spec is not None:
            if len(arrs) != len(self._input_spec):
                raise MXNetError(f"{self.name}: expected "
                                 f"{len(self._input_spec)} inputs, got "
                                 f"{len(arrs)}")
            for a, (feat, dt) in zip(arrs, self._input_spec):
                if tuple(a.shape[1:]) != tuple(feat):
                    raise MXNetError(
                        f"{self.name}: feature shape {tuple(a.shape[1:])} "
                        f"!= declared {tuple(feat)}")
                if dtype_name(a.dtype) != dt:
                    raise MXNetError(f"{self.name}: dtype {a.dtype} != "
                                     f"declared {dt}")
        ns = {a.shape[0] for a in arrs}
        if len(ns) != 1:
            raise MXNetError(f"{self.name}: inputs disagree on batch size "
                             f"{ns}")
        if ns == {0}:
            raise MXNetError(f"{self.name}: empty request (0 rows)")

    def _normalize(self, inputs) -> List[NDArray]:
        ctx = self.context
        arrs = [x.as_in_context(ctx) if isinstance(x, NDArray)
                else _nd.array(_np.asarray(x), ctx=ctx)
                for x in (inputs if isinstance(inputs, (list, tuple))
                          else [inputs])]
        self._check_spec(arrs)
        return arrs

    def normalize_host(self, inputs) -> List[_np.ndarray]:
        """Validate one request without touching the device: host numpy
        arrays, narrowed as ``nd.array`` narrows them (the batcher's
        staging path)."""
        arrs = [x.asnumpy() if isinstance(x, NDArray)
                else narrow_source(_np.asarray(x))
                for x in (inputs if isinstance(inputs, (list, tuple))
                          else [inputs])]
        self._check_spec(arrs)
        return arrs

    def _ensure_init(self, arrs: List[NDArray]):
        """One forward before the first cached call resolves deferred
        parameter shapes and fixes the spec when none was given."""
        if self._initialized:
            return
        self._block(*arrs)
        if self._input_spec is None:
            self._input_spec = [(tuple(a.shape[1:]), dtype_name(a.dtype))
                                for a in arrs]
        self._initialized = True

    # ------------------------------------------------------------- predict
    def predict(self, inputs):
        """Run a request of ``n`` rows padded to its rung (chunked through
        the top rung above ``max_batch``); the outputs come back sliced to
        ``n`` rows, one NDArray or a list."""
        with self._lock:
            arrs = self._normalize(inputs)
            self._ensure_init(arrs)
            n = arrs[0].shape[0]
            chunks: List[List[NDArray]] = []
            single = None
            with _tracing.span("serving.engine.predict",
                               attrs={"model": self.name, "rows": n,
                                      "bucket": (self.bucket_for(n)
                                                 if n <= self.max_batch
                                                 else self.max_batch)}), \
                    _goodput.serving().owned():
                for lo in range(0, n, self.max_batch):
                    hi = min(n, lo + self.max_batch)
                    outs = self._predict_bucket([a[lo:hi] for a in arrs],
                                                hi - lo)
                    single = not isinstance(outs, (list, tuple))
                    chunks.append([outs] if single else list(outs))
            if len(chunks) == 1:
                outs = chunks[0]
            else:
                outs = [NDArray(torch.cat([c[i]._data for c in chunks]),
                                chunks[0][i].context)
                        for i in range(len(chunks[0]))]
            return outs[0] if single else outs

    def execute_padded(self, arrs: List[NDArray], rows: int):
        """Run one batch already at a rung's size (the batcher's staged
        buffer, zero rows at the end): ``(outputs, single)`` at the padded
        size; the caller splits them by request."""
        with self._lock:
            self._ensure_init(arrs)
            with _tracing.span("serving.engine.predict",
                               attrs={"model": self.name, "rows": rows,
                                      "bucket": arrs[0].shape[0]}), \
                    _goodput.serving().owned():
                outs = self._op(*arrs)
        single = not isinstance(outs, (list, tuple))
        return ([outs] if single else list(outs)), single

    def staging(self, bucket: int) -> Optional[List[NDArray]]:
        """The static input buffers of ``bucket``'s graph (NDArrays at the
        rung's size), or None while the rung has none (before warmup, on
        the CPU).  A batch written there and passed to
        :meth:`execute_padded` is not copied again."""
        if self._input_spec is None:
            return None
        return self._op.input_buffers([((bucket,) + tuple(feat), dt)
                                       for feat, dt in self._input_spec])

    def _predict_bucket(self, arrs: List[NDArray], n: int):
        bucket = self.bucket_for(n)
        if bucket != n:
            bufs = self.staging(bucket)
            if bufs is not None:
                with torch.no_grad():
                    for buf, a in zip(bufs, arrs):
                        buf._data[:n].copy_(a._data)
                        buf._data[n:].zero_()
                arrs = bufs
            else:
                arrs = [NDArray(torch.cat([a._data, a._data.new_zeros(
                    (bucket - n,) + tuple(a.shape[1:]))]), a.context)
                    for a in arrs]
        outs = self._op(*arrs)
        if bucket == n:
            return outs
        if isinstance(outs, (list, tuple)):
            return [o[:n] for o in outs]
        return outs[:n]

    # -------------------------------------------------------------- warmup
    def warmup(self, buckets: Optional[Sequence[int]] = None) -> int:
        """Run every rung of the ladder (or ``buckets``) once, on zeros,
        so no live request makes a cache entry; returns the entries
        made."""
        if self._input_spec is None:
            raise MXNetError(
                f"{self.name}: warmup needs an input_spec: pass one, run the "
                "block forward once first, or export with a signature sidecar")
        before = self._op.cache_stats["entries"]
        ctx = self.context
        # the largest rung first: the others capture into its pool
        for b in sorted(buckets or self._ladder, reverse=True):
            self.predict([_nd.zeros((b,) + tuple(feat), ctx, dtype=dt)
                          for feat, dt in self._input_spec])
        return self._op.cache_stats["entries"] - before

    def stats_snapshot(self) -> Dict[str, Any]:
        snap = (self._stats.snapshot(self.cache_stats) if self._stats
                else {"compile_cache": self.cache_stats})
        snap["ladder"] = list(self._ladder)
        return snap
