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

On CPU tensors an entry runs the block eagerly (torch's autograd records
it under ``record()``), as every kernel wrapper takes its plain version
there.  A hybridized block called inside another's entry runs inside it
and keys nothing (only the outermost hybridized block compiles).
"""
from __future__ import annotations

import warnings
import weakref
from typing import Any, Callable, Dict, List, Sequence

import torch

from . import _graphs, autograd
from . import random as _random
from .base import MXNetError, env
from .ndarray.ndarray import NDArray

__all__ = ["CachedOp"]


# ------------------------------------------------------------ output trees
def _flatten(x, leaves: List[NDArray]):
    """The structure of a forward's result with each NDArray replaced by
    its index in ``leaves``."""
    if isinstance(x, NDArray):
        leaves.append(x)
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

    def __init__(self, graph, static_in, outs, struct, ctx, addr):
        self.graph, self.static_in, self.outs = graph, static_in, outs
        self.struct, self.ctx, self.addr = struct, ctx, addr

    def __call__(self, inputs):
        with torch.no_grad():
            for s, x in zip(self.static_in, inputs):
                if x._data is not s:
                    s.copy_(x._data)
            self.graph.replay()
            outs = [NDArray(o.clone(), self.ctx) for o in self.outs]
        return _unflatten(self.struct, outs)


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
    def backward(ctx, *grads):
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
    def __init__(self, forward_fn: Callable, params: Sequence, flags=()):
        """``forward_fn(*nd_inputs)`` -> NDArray or a list of them, reading
        ``params`` (Gluon Parameters) itself.  ``flags`` (the reference's
        ``static_alloc``, ``static_shape``, ...) are kept and select
        nothing: an entry on the card is a graph whatever they say, as the
        JAX package compiles whatever they say."""
        self._fwd = forward_fn
        self._params = list(params)
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
        return self._key(tuple((x.shape, str(x.dtype)) for x in inputs),
                         training)

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
        if entry is None:
            self._misses += 1
            entry = self._cache[sig] = _Entry()
            self._maybe_warn_recompile_storm()
        else:
            self._hits += 1
        if not inputs or not inputs[0]._data.is_cuda:
            return _graphs.run_inside(lambda: self._fwd(*inputs))
        if autograd.is_recording():
            return self._record(entry, sig, inputs)
        return self._predict(entry, sig, inputs)

    # --------------------------------------------------------------- card
    def _reads(self) -> List[torch.Tensor]:
        """The parameter tensors a graph reads in place."""
        return [t for t in (p._tensor() for p in self._params)
                if t is not None]

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
        addr = _graphs.addresses(self._reads())
        g = entry.predict
        if g is not None and g.addr == addr and \
                g.static_in[0].device == inputs[0]._data.device:
            self._replays += 1
            return g(inputs)
        dev = inputs[0]._data.device
        out = _graphs.warm(lambda: self._fwd(*inputs), dev)
        ctx = inputs[0].context
        static_in = [x._data.detach().clone() for x in inputs]
        box = []

        def fwd():
            leaves: List[NDArray] = []
            box.append(_flatten(self._fwd(*[NDArray(s, ctx)
                                             for s in static_in]), leaves))
            return [a._data for a in leaves]
        graph, outs = self._capture(fwd, dev, sig, "forward")
        entry.predict = _Predict(graph, static_in, outs, box[0], ctx, addr)
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
            _graphs.warm(lambda: self._warm_record(inputs), dev)
            slot = self._capture_record(inputs, sig, in_grad, addr)
            entry.slots.append(slot)
        else:
            self._replays += 1
        if slot.bwd is None:
            leaves = slot.forward([x._data for x in inputs])
            slot.busy = False
        else:
            leaves = _Replay.apply(slot, *[x._data for x in inputs],
                                   *self._learnable())
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
        leaves: List[NDArray] = []
        _flatten(self._fwd(*inputs), leaves)
        heads = [a._data for a in leaves if a._data.requires_grad]
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
            leaves: List[NDArray] = []
            box.append(_flatten(self._fwd(*[NDArray(s, ctx)
                                             for s in static_in]), leaves))
            return [a._data for a in leaves]
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
        return [NDArray(s, g.ctx) for s in g.static_in]
