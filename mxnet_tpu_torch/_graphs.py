"""CUDA graphs: one captured signature, the port's counterpart of one
``jax.jit`` executable.

The JAX package compiles at three sites, and this module is what the port
has in their place:

* ``CachedOp`` (``mxnet_tpu/cached_op.py``): a hybridized block's three
  programs per signature, ``fwd``, ``fwd_res`` and ``bwd``
  (:mod:`~mxnet_tpu_torch.cached_op` captures them here);
* the ``Executor``'s ``_compiled(training)`` (``mxnet_tpu/symbol/
  symbol.py``), the jitted graph walk that ``jax.vjp`` runs through
  (:class:`~mxnet_tpu_torch.symbol.Executor` captures its forward and
  backward here);
* ``CompiledTrainStep`` (``mxnet_tpu/executor.py``), the jitted training
  step, which the port still runs eagerly.

A signature's first call runs its function eagerly on the device's side
stream (:func:`warm`): the first use of each kernel (its ``nvcc`` build and
module load), cuBLAS's handle and workspace for that stream and the
caching allocator's growth all happen there.  Then :func:`capture`
records the same function into a
``torch.cuda.CUDAGraph`` on that stream, in thread-local mode, from a
memory pool that the caller shares among its signatures.  A later call
copies its inputs into the graph's static buffers and :meth:`Graph.replay`
launches the recorded kernels in the recorded order at the recorded
addresses.  What a graph reads in place (parameters, moving statistics)
must therefore stay at its address: callers keep the addresses of those
tensors (:func:`addresses`) and capture again when one moved.

The hand-written kernels' wrappers count their launches in Python, which
a replay never runs.  A wrapper's module registers its counters
(:func:`count_launches`); a capture records how many launches each counter
took, takes them back (the capture launched nothing), and every replay
adds them.
"""
from __future__ import annotations

import threading
import weakref
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from .base import MXNetError

__all__ = ["Graph", "warm", "capture", "addresses", "inside", "run_inside",
           "count_launches", "new_pool"]

_tls = threading.local()
_side: Dict[int, "torch.cuda.Stream"] = {}
_side_lock = threading.Lock()
# (holder, counter names): the launch counters replays advance
_counters: List[Tuple[weakref.ref, Tuple[str, ...]]] = []


def count_launches(holder, *names: str) -> None:
    """Register ``holder.<name>`` (a module or an object, held weakly) as
    launch counters that a replay advances by what its capture counted."""
    _counters[:] = [c for c in _counters if c[0]() is not None]
    _counters.append((weakref.ref(holder), names))


def _counter_values() -> Dict[Tuple[int, str], Tuple[object, int]]:
    values = {}
    for ref, names in _counters:
        holder = ref()
        if holder is not None:
            for name in names:
                values[(id(holder), name)] = (holder, getattr(holder, name))
    return values


def inside() -> bool:
    """True while this thread runs a signature's function (its warm-up or
    its capture): a hybridized block called there runs inside it."""
    return getattr(_tls, "depth", 0) > 0


class _Inside:
    def __enter__(self):
        _tls.depth = getattr(_tls, "depth", 0) + 1

    def __exit__(self, *exc):
        _tls.depth -= 1


def run_inside(fn: Callable):
    """``fn()`` with :func:`inside` true (the eager path of an entry)."""
    with _Inside():
        return fn()


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    """The device's one side stream: warm-ups and captures run there, so
    the per-stream state they set up (cuBLAS's workspace) persists."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    with _side_lock:
        s = _side.get(idx)
        if s is None:
            s = _side[idx] = torch.cuda.Stream(device=idx)
    return s


def new_pool():
    """A memory pool for the graphs of one CachedOp or Executor."""
    return torch.cuda.graph_pool_handle()


def warm(fn: Callable, device: torch.device):
    """``fn()`` run eagerly on the device's side stream, ordered after the
    work already queued on the current stream and before what follows."""
    side = _side_stream(device)
    cur = torch.cuda.current_stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side), _Inside():
        out = fn()
    cur.wait_stream(side)
    return out


class Graph:
    """One captured CUDA graph; :meth:`replay` launches it on the current
    stream and advances the registered launch counters by what the
    capture counted."""

    __slots__ = ("_graph", "_launches")

    def __init__(self, graph, launches):
        self._graph = graph
        self._launches = launches    # [(holder, counter name, launches)]

    def replay(self) -> None:
        self._graph.replay()
        for holder, name, n in self._launches:
            setattr(holder, name, getattr(holder, name) + n)


def capture(fn: Callable, device: torch.device, pool,
            generators: Sequence[torch.Generator], what: str):
    """``(graph, result)``: ``fn()`` captured on the device's side stream
    (thread-local mode) from ``pool``, each generator in ``generators``
    registered so that a replay draws fresh numbers; ``result`` is what
    ``fn`` returned, tensors in the pool that every replay rewrites.  A
    capture that fails raises :class:`MXNetError` naming ``what``."""
    side = _side_stream(device)
    cur = torch.cuda.current_stream(device)
    # the memory the warm-up freed goes back to the device, where the
    # graph's pool can take it (as torch.cuda.graph does)
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    side.wait_stream(cur)
    g = torch.cuda.CUDAGraph()
    for gen in generators:
        g.register_generator_state(gen)
    before = _counter_values()
    try:
        with torch.cuda.stream(side), _Inside():
            g.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = fn()
            except BaseException:
                try:
                    g.capture_end()
                except Exception:  # noqa: BLE001 - the first error wins
                    pass
                raise
            g.capture_end()
    except Exception as e:
        _restore(before)
        raise MXNetError(f"{what}: CUDA graph capture failed: "
                         f"{type(e).__name__}: {e}") from e
    launches = [(holder, name, getattr(holder, name) - value)
                for (_, name), (holder, value) in before.items()
                if getattr(holder, name) != value]
    _restore(before)
    cur.wait_stream(side)
    return Graph(g, launches), out


def _restore(values) -> None:
    for (_, name), (holder, value) in values.items():
        setattr(holder, name, value)


def addresses(tensors) -> Tuple[int, ...]:
    """The storage addresses a graph reads ``tensors`` at."""
    return tuple(t.data_ptr() for t in tensors)

