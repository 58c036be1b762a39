"""CachedOp: the per-signature cache of a hybridized block.

Counterpart of ``mxnet_tpu/cached_op.py`` (reference
``src/imperative/cached_op.{h,cc}``).  The cache is keyed as the JAX
package keys it: the inputs' shapes and dtypes, the training flag and
each parameter's ``(name, grad_req)``.  A signature's first call is a miss
that makes its entry; later calls are hits.  ``cache_stats`` is what the
serving engine reports: a bucket-ladder server shows one miss per rung,
all at warmup, and only hits after.

Where the JAX package traces a signature into XLA programs, an entry on
the card holds CUDA graphs (:mod:`~mxnet_tpu_torch._graphs`):

* in predict (outside ``autograd.record()``), one graph of the forward;
* under ``record()``, the forward with its residuals and the backward,
  joined into torch autograd by one ``torch.autograd.Function`` over the
  inputs and the learnable parameters (``grad_req != 'null'``), so
  ``loss.backward()`` replays the backward graph.  These are the JAX
  package's ``fwd_res`` and ``bwd``.  The residuals live in the graph's
  memory, so a second recorded call before the first one's backward takes
  a second pair of graphs (a *slot*) of the same entry.

A signature's first call on the card runs the block eagerly on the
graphs' side stream before the capture, so that every kernel has run
once outside it.  In predict that eager run is the call's result.  Under
``record()`` it runs the backward too, its memory is freed and the
moving statistics it moved are put back before the pair is captured
(two copies of a large model's residuals would not fit), and the call
then replays the pair like every later one.  A call copies its inputs
into the graph's static buffers, replays, and hands back fresh outputs
(clones of the static ones, as the JAX package returns fresh arrays).  Parameters
and moving statistics are read in place; their addresses are kept at
capture, and an entry whose addresses moved (``Parameter.cast``,
``module.to``) captures again (``_captures`` counts every capture).

An op over an ``nn.Module``'s method (``params`` the module) takes and
returns tensors and runs in predict only.  It reads the module's
parameters and buffers in place, and so the last ``in_place`` inputs of
a call (the generation engines' KV page pools): those are neither copied
nor keyed, and an entry captures again when one of their addresses
moved.  With ``fresh_outputs=False`` a replay hands back the graph's
static outputs themselves, which the op's next call overwrites.

On CPU tensors an entry runs the block eagerly (torch's autograd records
it under ``record()``), as every kernel wrapper takes its plain version
there.  A hybridized block called inside another's entry runs inside it
and keys nothing (only the outermost hybridized block compiles).

Every call opens a ``cachedop.execute`` span and goes through
:func:`~mxnet_tpu_torch.resilience.backend_call`: a capture (with the
eager first run before it) is the ``compile`` site, a replay, or on the
CPU the eager run, the ``execute`` site.  An injected transient fault
fires before the call it precedes, so a retried replay never follows a
half-run one; a CUDA error passes through and is not retried.  Both
sites are train goodput intervals (``compile``, ``device_compute``), which
a serving worker's own interval swallows.
"""
from __future__ import annotations

import time
import warnings
import weakref
from typing import Any, Callable, Dict, List, Sequence

import torch
from torch.autograd.function import once_differentiable

from . import _graphs, autograd
from . import random as _random
from .base import MXNetError, env
from .ndarray.ndarray import NDArray
from .observability import (goodput as _goodput, metrics as _metrics,
                            tracing as _tracing)
from .resilience import backend_call

__all__ = ["CachedOp"]

_M_HITS = _metrics.registry().counter(
    "mxnet_tpu_cachedop_cache_hits_total",
    "CachedOp signature-cache hits (warm executable reused).")
_M_MISSES = _metrics.registry().counter(
    "mxnet_tpu_cachedop_cache_misses_total",
    "CachedOp signature-cache misses (on the card, a fresh CUDA graph "
    "capture).")
_M_COMPILE_SECONDS = _metrics.registry().histogram(
    "mxnet_tpu_cachedop_compile_seconds",
    "Wall time of a signature's first call on the card: the eager run "
    "and the CUDA graph capture.")
_M_STORMS = _metrics.registry().counter(
    "mxnet_tpu_cachedop_recompile_storms_total",
    "Ops whose compile-cache miss pattern tripped the recompile-storm "
    "warning (signature churn: every request pays a capture).")


# ------------------------------------------------------------ output trees
def _tensor(x) -> torch.Tensor:
    return x._data if isinstance(x, NDArray) else x


def _wrap(tensors, ctx):
    """The tensors as NDArrays on ``ctx``, or as they are (ctx None: an op
    over an nn.Module)."""
    if ctx is None:
        return list(tensors)
    return [NDArray(t, ctx) for t in tensors]


def _flatten(x, leaves: List[torch.Tensor]):
    """The structure of a forward's result with each NDArray (or tensor)
    replaced by its index in ``leaves``, which gets its tensor."""
    if isinstance(x, (NDArray, torch.Tensor)):
        leaves.append(_tensor(x))
        return len(leaves) - 1
    if isinstance(x, (list, tuple)):
        return type(x)(_flatten(e, leaves) for e in x)
    raise MXNetError(f"a hybridized block returns NDArrays or lists of "
                     f"them, not {type(x).__name__}")


def _unflatten(struct, leaves):
    if isinstance(struct, int):
        return leaves[struct]
    return type(struct)(_unflatten(e, leaves) for e in struct)


# ------------------------------------------------------------------ graphs
class _Predict:
    """The predict graph of an entry: static inputs, the graph, its
    outputs."""

    def __init__(self, graph, static_in, outs, struct, ctx, addr, fresh):
        self.graph, self.static_in, self.outs = graph, static_in, outs
        self.struct, self.ctx, self.addr = struct, ctx, addr
        self.fresh = fresh

    def __call__(self, inputs):
        with torch.no_grad():
            # the in-place inputs past the static ones are read in place
            for s, x in zip(self.static_in, inputs):
                if _tensor(x) is not s:
                    s.copy_(_tensor(x))
            self.graph.replay()
            outs = [o.clone() for o in self.outs] if self.fresh \
                else self.outs
        return _unflatten(self.struct, _wrap(outs, self.ctx))


class _Token:
    """Lives as long as a recorded call's autograd node; its death frees
    the slot the call used."""

    __slots__ = ("__weakref__",)


class _Slot:
    """One pair of record graphs: the forward with its residuals and the
    backward, with their static buffers."""

    def __init__(self, fwd, bwd, static_in, in_grad, outs, diff, cts, grads,
                 struct, ctx, addr):
        self.fwd, self.bwd = fwd, bwd
        self.static_in, self.in_grad = static_in, in_grad
        self.outs, self.diff, self.cts, self.grads = outs, diff, cts, grads
        self.struct, self.ctx, self.addr = struct, ctx, addr
        self.busy = False
        self.generation = 0

    def release(self, generation: int) -> None:
        if self.generation == generation:
            self.busy = False

    def forward(self, inputs) -> List[torch.Tensor]:
        self.busy = True
        self.generation += 1
        with torch.no_grad():
            for s, x in zip(self.static_in, inputs):
                if x is not s:
                    s.copy_(x)
            self.fwd.replay()
            return [o.detach().clone() for o in self.outs]

    def backward(self, generation: int, grads):
        if generation != self.generation:
            raise MXNetError(
                "backward through a hybridized call whose residuals a later "
                "recorded call of the same signature overwrote (backward "
                "twice with retain_graph across calls)")
        for c, g in zip(self.cts, [g for g, d in zip(grads, self.diff) if d]):
            if g is None:
                c.zero_()
            else:
                c.copy_(g)
        self.bwd.replay()
        self.busy = False
        return tuple(None if g is None else g.clone() for g in self.grads)


class _Replay(torch.autograd.Function):
    """One recorded hybridized call: ``forward`` replays the slot's
    forward graph, ``backward`` its backward graph.  The inputs are the
    call's tensors, then the learnable parameters."""

    @staticmethod
    def forward(ctx, slot, *tensors):
        outs = slot.forward(tensors[:len(slot.static_in)])
        ctx.slot, ctx.generation = slot, slot.generation
        ctx.token = _Token()
        weakref.finalize(ctx.token, slot.release, slot.generation)
        nondiff = [o for o, d in zip(outs, slot.diff) if not d]
        if nondiff:
            ctx.mark_non_differentiable(*nondiff)
        return tuple(outs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        # a graph replay has no derivative: torch refuses to differentiate
        # it again (autograd.grad(create_graph=True) through a replay)
        return (None,) + ctx.slot.backward(ctx.generation, grads)


class _Entry:
    __slots__ = ("predict", "slots")

    def __init__(self):
        self.predict = None
        self.slots: List[_Slot] = []


def generators_of(root, device) -> List[torch.Generator]:
    """The device's stream, and any generator on the device's type that a
    module of ``root`` (a module or None) holds (``Dropout(generator=...)``):
    on the card, the generators a graph over ``root`` registers."""
    kind = torch.device(device).type
    gens = [_random.device_generator(device)]
    if root is not None:
        for m in root.modules():
            g = getattr(m, "generator", None)
            if isinstance(g, torch.Generator) and \
                    g.device.type == kind and \
                    all(g is not h for h in gens):
                gens.append(g)
    return gens


class CachedOp:
    def __init__(self, forward_fn: Callable, params, flags=(),
                 in_place: int = 0, fresh_outputs: bool = True):
        """``forward_fn(*nd_inputs)`` -> NDArray or a list of them, reading
        ``params`` (Gluon Parameters) itself; or, when ``params`` is an
        ``nn.Module``, ``forward_fn(*tensors)`` -> tensors, reading the
        module's parameters and buffers.  The last ``in_place`` inputs of
        every call are read in place, out of the key; ``fresh_outputs``
        False returns a replay's static outputs uncopied.  ``flags`` (the
        reference's ``static_alloc``, ``static_shape``, ...) are kept and
        select nothing: an entry on the card is a graph whatever they say,
        as the JAX package compiles whatever they say."""
        self._fwd = forward_fn
        if isinstance(params, torch.nn.Module):
            self._module, self._params = params, []
        else:
            self._module, self._params = None, list(params)
        self._in_place = int(in_place)
        self._fresh = bool(fresh_outputs)
        self._flags = dict(flags)
        self._cache: Dict[Any, _Entry] = {}  # the signatures, in order
        self._hits = 0
        self._misses = 0
        self._captures = 0   # entries captured (a predict graph or a
        #                      record pair), a recapture included
        self._replays = 0    # calls that replayed a graph
        self._storm_warned = False
        self._pool = None
        owner = getattr(forward_fn, "__self__", None)
        self._owner = owner if isinstance(owner, torch.nn.Module) else None
        self.__name__ = getattr(owner, "name", None) or getattr(
            forward_fn, "__name__", "cached_op")

    @property
    def cache_stats(self) -> Dict[str, Any]:
        """``entries``, ``hits``, ``misses`` and the cached
        ``signatures``."""
        return {"entries": len(self._cache), "hits": self._hits,
                "misses": self._misses,
                "signatures": list(self._cache.keys())}

    def _signature(self, inputs: Sequence[NDArray], training: bool):
        keyed = inputs[:len(inputs) - self._in_place]
        return self._key(tuple((tuple(x.shape), str(x.dtype))
                               for x in keyed), training)

    def _key(self, shapes_dtypes, training: bool):
        # grad_req is part of the key: a fine-tune unfreeze (null -> write)
        # changes what the forward records
        return (shapes_dtypes, training,
                tuple((p.name, p.grad_req) for p in self._params))

    def _maybe_warn_recompile_storm(self):
        """Warn once per op when misses dwarf hits: every request a new
        signature, so every request a new entry and its capture."""
        thr = int(env.MXNET_TPU_RECOMPILE_WARN)
        if (thr <= 0 or self._storm_warned or self._misses < thr
                or self._misses <= 2 * self._hits):
            return
        self._storm_warned = True
        _M_STORMS.inc()
        warnings.warn(
            f"cached_op {self.__name__!r}: {self._misses} compiles vs "
            f"{self._hits} cache hits — recompile storm? {len(self._cache)} "
            "distinct signatures cached; stabilize input shapes (bucket/pad) "
            "or raise MXNET_TPU_RECOMPILE_WARN to silence",
            RuntimeWarning, stacklevel=3)

    def __call__(self, *inputs: NDArray):
        if _graphs.inside():
            # called inside another block's entry: part of its graph
            return self._fwd(*inputs)
        sig = self._signature(inputs, autograd.is_training())
        entry = self._cache.get(sig)
        miss = entry is None
        if miss:
            self._misses += 1
            _M_MISSES.inc()
            entry = self._cache[sig] = _Entry()
            self._maybe_warn_recompile_storm()
        else:
            self._hits += 1
            _M_HITS.inc()
        recording = autograd.is_recording()
        with _tracing.span("cachedop.execute",
                           attrs={"op": self.__name__,
                                  "cache": "miss" if miss else "hit",
                                  "recording": recording}):
            if not inputs or not _tensor(inputs[0]).is_cuda:
                with _goodput.train().timed("device_compute"):
                    return backend_call("execute", lambda: _graphs.run_inside(
                        lambda: self._fwd(*inputs)))
            if recording:
                if self._module is not None or self._in_place:
                    raise MXNetError(f"CachedOp {self.__name__!r} over an "
                                     "nn.Module or with in-place inputs "
                                     "runs in predict only")
                return self._record(entry, sig, inputs)
            return self._predict(entry, sig, inputs)

    # --------------------------------------------------------------- card
    def _reads(self, inputs=()) -> List[torch.Tensor]:
        """The tensors a graph reads in place: the parameters (and an
        nn.Module's buffers), then the in-place ones of ``inputs``."""
        if self._module is not None:
            own = [*self._module.parameters(), *self._module.buffers()]
        else:
            own = [t for t in (p._tensor() for p in self._params)
                   if t is not None]
        return own + [_tensor(x)
                      for x in inputs[len(inputs) - self._in_place:]]

    def _generators(self, device) -> List[torch.Generator]:
        return generators_of(self._owner, device)

    def _capture(self, fn, device, sig, what):
        if self._pool is None:
            self._pool = _graphs.new_pool()
        graph, out = _graphs.capture(
            fn, device, self._pool, self._generators(device),
            f"CachedOp {self.__name__!r} {what}, inputs {sig[0]}, "
            f"training={sig[1]}")
        return graph, out

    def _predict(self, entry: _Entry, sig, inputs):
        addr = _graphs.addresses(self._reads(inputs))
        g = entry.predict
        if g is not None and g.addr == addr and \
                g.static_in[0].device == _tensor(inputs[0]).device:
            self._replays += 1
            with _goodput.train().timed("device_compute"):
                return backend_call("execute", lambda: g(inputs))
        t0 = time.perf_counter()
        with _tracing.span("cachedop.compile",
                           attrs={"op": self.__name__,
                                  "signature": repr(sig[0])}), \
                _goodput.train().timed("compile"):
            out = backend_call("compile", lambda: self._capture_predict(
                entry, sig, inputs, addr))
        _M_COMPILE_SECONDS.observe(time.perf_counter() - t0)
        return out

    def _capture_predict(self, entry: _Entry, sig, inputs, addr):
        """A signature's first call: the eager run (the result), then the
        capture of its predict graph."""
        dev = _tensor(inputs[0]).device
        out = _graphs.warm(lambda: self._fwd(*inputs), dev)
        ctx = inputs[0].context if self._module is None else None
        n = len(inputs) - self._in_place
        static_in = [_tensor(x).detach().clone() for x in inputs[:n]]
        box = []

        def fwd():
            leaves: List[torch.Tensor] = []
            box.append(_flatten(self._fwd(*_wrap(static_in, ctx),
                                          *inputs[n:]), leaves))
            return leaves
        graph, outs = self._capture(fwd, dev, sig, "forward")
        entry.predict = _Predict(graph, static_in, outs, box[0], ctx, addr,
                                 self._fresh)
        self._captures += 1
        return out

    def _record(self, entry: _Entry, sig, inputs):
        addr = _graphs.addresses(self._reads())
        dev = inputs[0]._data.device
        in_grad = tuple(x._data.requires_grad for x in inputs)
        entry.slots = [s for s in entry.slots if s.addr == addr
                       and s.static_in[0].device == dev]
        slot = next((s for s in entry.slots
                     if not s.busy and s.in_grad == in_grad), None)
        if slot is None:
            def capture():
                _graphs.warm(lambda: self._warm_record(inputs), dev)
                return self._capture_record(inputs, sig, in_grad, addr)
            t0 = time.perf_counter()
            with _tracing.span("cachedop.compile",
                               attrs={"op": self.__name__,
                                      "signature": repr(sig[0])}), \
                    _goodput.train().timed("compile"):
                slot = backend_call("compile", capture)
            _M_COMPILE_SECONDS.observe(time.perf_counter() - t0)
            entry.slots.append(slot)
        else:
            self._replays += 1

        def replay():
            if slot.bwd is None:
                outs = slot.forward([x._data for x in inputs])
                slot.busy = False
                return outs
            return _Replay.apply(slot, *[x._data for x in inputs],
                                 *self._learnable())
        with _goodput.train().timed("device_compute"):
            leaves = backend_call("execute", replay)
        return _unflatten(slot.struct,
                          [NDArray(t, slot.ctx) for t in leaves])

    def _learnable(self) -> List[torch.Tensor]:
        return [p._tensor() for p in self._params if p.grad_req != "null"]

    def _warm_record(self, inputs) -> None:
        """Before a record capture: the block's forward and backward once,
        eagerly, their memory freed before the capture takes its own; the
        parameters without a gradient (moving statistics) are put back,
        so the call that follows updates them once."""
        fixed = [t for t in (p._tensor() for p in self._params
                             if p.grad_req == "null") if t is not None]
        saved = [t.detach().clone() for t in fixed]
        leaves: List[torch.Tensor] = []
        _flatten(self._fwd(*inputs), leaves)
        heads = [t for t in leaves if t.requires_grad]
        wrt = [x._data for x in inputs if x._data.requires_grad] + [
            t for t in self._learnable() if t.requires_grad]
        if heads and wrt:
            torch.autograd.grad(heads, wrt, [torch.ones_like(h) for h in heads],
                                allow_unused=True)
        del leaves, heads
        with torch.no_grad():
            for t, v in zip(fixed, saved):
                t.copy_(v)

    def _capture_record(self, inputs, sig, in_grad, addr) -> _Slot:
        dev = inputs[0]._data.device
        ctx = inputs[0].context
        static_in = [x._data.detach().clone().requires_grad_(g)
                     for x, g in zip(inputs, in_grad)]
        box = []

        def fwd():
            leaves: List[torch.Tensor] = []
            box.append(_flatten(self._fwd(*_wrap(static_in, ctx)), leaves))
            return leaves
        fwd_graph, outs = self._capture(fwd, dev, sig, "forward")
        diff = [o.requires_grad for o in outs]
        heads = [o for o, d in zip(outs, diff) if d]
        wrt = [s for s in static_in if s.requires_grad] + [
            t for t in self._learnable() if t.requires_grad]
        bwd_graph, cts, grads = None, [], []
        if heads and wrt:
            cts = [torch.zeros_like(h) for h in heads]
            bwd_graph, got = self._capture(
                lambda: torch.autograd.grad(heads, wrt, cts,
                                            retain_graph=True,
                                            allow_unused=True),
                dev, sig, "backward")
            got = iter(got)
            grads = [next(got) if g else None for g in in_grad] + [
                next(got) if t.requires_grad else None
                for t in self._learnable()]
        self._captures += 1
        return _Slot(fwd_graph, bwd_graph, static_in, in_grad, outs, diff,
                     cts, grads, box[0], ctx, addr)

    def input_buffers(self, shapes_dtypes):
        """The static input buffers (NDArrays) of the predict graph of the
        signature of inputs of ``shapes_dtypes`` (``[(shape, dtype
        name)]``), or None while that signature has no graph (not called
        yet, or on the CPU).  A caller that writes its inputs there and
        passes those NDArrays saves the copy."""
        sig = self._key(tuple((tuple(s), str(d)) for s, d in shapes_dtypes),
                        autograd.is_training())
        entry = self._cache.get(sig)
        g = entry.predict if entry is not None else None
        if g is None:
            return None
        return _wrap(g.static_in, g.ctx)
