"""Collectives over a device mesh and across processes (counterpart of
``mxnet_tpu/parallel/collectives.py``).

**Over a mesh, in one process.**  The JAX package runs a per-device body
under ``shard_map`` and moves data with ``lax`` collectives.  The port is
single-controller too: :func:`shard_map` splits each global input over
the mesh's positions as its :class:`~.mesh.PartitionSpec` says, runs the
body once over all positions in lockstep, and joins the outputs.  The
body receives, for each input, the list of the positions' shards (row-
major over the mesh axes the specs name) and returns such lists; each
collective (:func:`psum`, :func:`pmean`, :func:`pmax`,
:func:`all_gather`, :func:`reduce_scatter`, :func:`ppermute`,
:func:`all_to_all`) takes a list and the axis name and returns a list,
each position's result on that position's device.  Outside a body a list
is taken as the positions of the one named axis.  Everything here is
torch ops, so autograd differentiates through a body and its
collectives.  Each call adds one to its name's count
(:func:`collective_counts`), as the kernels count their launches; a CUDA
graph's replay adds what its capture counted.

The eager layer (:func:`allreduce_arrays`, :func:`allreduce`,
:func:`reduce_scatter_flat`, :func:`all_gather_flat`,
:func:`broadcast_value`, :func:`barrier`) works on per-worker values, as
the reference's ``Comm::Reduce``/``Broadcast`` did.

**Across processes.**  A key's replicas are summed pairwise
(:func:`pairwise_sum`, the reference's ``ElementwiseSum`` order); across
processes a value is summed with ``torch.distributed.all_reduce``
(:func:`cross_process_allreduce`) and rank 0's value is sent to every
rank with ``broadcast`` (:func:`broadcast_from`).  These two are the
collectives gloo also runs on CUDA tensors.  Every reduction here is
elementwise, so reducing a concatenation of keys equals concatenating
their reductions, bit for bit.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import _graphs, distributed
from .mesh import DeviceMesh, PartitionSpec, default_mesh

__all__ = ["psum", "pmean", "pmax", "all_gather", "reduce_scatter",
           "ppermute", "all_to_all", "axis_index", "shard_map",
           "allreduce", "allreduce_arrays", "allreduce_flat",
           "reduce_scatter_flat", "all_gather_flat", "broadcast_value",
           "barrier", "pairwise_sum", "cross_process_allreduce",
           "broadcast_from", "PendingReduce", "collective_counts",
           "reset_collective_counts"]

_NAMES = ("psum", "pmean", "pmax", "all_gather", "reduce_scatter",
          "ppermute", "all_to_all")


class _Counts:
    """One count per collective: calls over a mesh, each covering every
    position (a CUDA graph's replay advances them as its capture did)."""

    def __init__(self):
        for name in _NAMES:
            setattr(self, name, 0)


_counts = _Counts()
_graphs.count_launches(_counts, *_NAMES)


def collective_counts() -> Dict[str, int]:
    """How many times each collective ran since the last reset."""
    return {name: getattr(_counts, name) for name in _NAMES}


def reset_collective_counts() -> None:
    for name in _NAMES:
        setattr(_counts, name, 0)


def _bump(name: str) -> None:
    setattr(_counts, name, getattr(_counts, name) + 1)


# ------------------------------------------------------------ the body
_tls = threading.local()


class _Body:
    """The positions a :func:`shard_map` body runs over: the mesh axes it
    names, and each position's coordinates (row-major)."""

    def __init__(self, axes: Dict[str, int]):
        self.names = tuple(axes)
        self.sizes = tuple(axes.values())
        self.coords = (np.indices(self.sizes).reshape(len(self.sizes), -1).T
                       if self.sizes else np.zeros((1, 0), dtype=int))

    @property
    def count(self) -> int:
        return len(self.coords)

    def groups(self, axis_name) -> List[List[int]]:
        """The positions that a collective over ``axis_name`` (a name or a
        tuple of names) joins: those equal on every other axis, each group
        in row-major order over the named axes."""
        names = (axis_name,) if isinstance(axis_name, str) else \
            tuple(axis_name)
        for a in names:
            if a not in self.names:
                raise ValueError(f"collective over axis {a!r}, which this "
                                 f"body lacks (axes {self.names})")
        idx = np.arange(self.count).reshape(self.sizes or (1,))
        named = [self.names.index(a) for a in names]
        rest = [i for i in range(len(self.names)) if i not in named]
        moved = np.transpose(idx, rest + named) if self.names else idx
        n = int(np.prod([self.sizes[i] for i in named])) if named else 1
        return moved.reshape(-1, n).tolist()


def _body(xs, axis_name) -> _Body:
    body = getattr(_tls, "body", None)
    if body is not None:
        if len(xs) != body.count:
            raise ValueError(f"a collective inside shard_map takes one value "
                             f"per position ({body.count}), got {len(xs)}")
        return body
    if not isinstance(axis_name, str):
        raise ValueError("outside shard_map a collective runs over one axis")
    return _Body({axis_name: len(xs)})


def axis_index(xs: Sequence, axis_name: str) -> List[int]:
    """Each position's coordinate along ``axis_name`` (``lax.axis_index``)."""
    body = _body(xs, axis_name)
    return [int(c) for c in body.coords[:, body.names.index(axis_name)]]


def _group_reduce(xs, axis_name, name, reduce, mean=False):
    _bump(name)
    body = _body(xs, axis_name)
    out = [None] * len(xs)
    for g in body.groups(axis_name):
        dev = xs[g[0]].device
        total = reduce([xs[i].to(dev) for i in g])
        if mean:
            total = total / len(g)
        for i in g:
            out[i] = total.to(xs[i].device)
    return out


def psum(xs: Sequence[torch.Tensor], axis_name) -> List[torch.Tensor]:
    """The sum over ``axis_name`` at every position (pairwise, in the
    group's order)."""
    return _group_reduce(xs, axis_name, "psum", pairwise_sum)


def pmean(xs: Sequence[torch.Tensor], axis_name) -> List[torch.Tensor]:
    return _group_reduce(xs, axis_name, "pmean", pairwise_sum, mean=True)


def pmax(xs: Sequence[torch.Tensor], axis_name) -> List[torch.Tensor]:
    def reduce(vals):
        out = vals[0]
        for v in vals[1:]:
            out = torch.maximum(out, v)
        return out
    return _group_reduce(xs, axis_name, "pmax", reduce)


def all_gather(xs: Sequence[torch.Tensor], axis_name, axis: int = 0,
               tiled: bool = True) -> List[torch.Tensor]:
    """Every position gets the group's values joined along ``axis``
    (``tiled``) or stacked on a new ``axis``."""
    _bump("all_gather")
    body = _body(xs, axis_name)
    out = [None] * len(xs)
    for g in body.groups(axis_name):
        dev = xs[g[0]].device
        parts = [xs[i].to(dev) for i in g]
        joined = torch.cat(parts, dim=axis) if tiled else \
            torch.stack(parts, dim=axis)
        for i in g:
            out[i] = joined.to(xs[i].device)
    return out


def reduce_scatter(xs: Sequence[torch.Tensor], axis_name,
                   axis: int = 0) -> List[torch.Tensor]:
    """The group's sum split along ``axis``: position r keeps piece r
    (``lax.psum_scatter(tiled=True)``)."""
    _bump("reduce_scatter")
    body = _body(xs, axis_name)
    out = [None] * len(xs)
    for g in body.groups(axis_name):
        n = len(g)
        if xs[g[0]].shape[axis] % n:
            raise ValueError(f"reduce_scatter: dim {axis} of size "
                             f"{xs[g[0]].shape[axis]} does not split {n} ways")
        dev = xs[g[0]].device
        total = pairwise_sum([xs[i].to(dev) for i in g])
        for r, i in enumerate(g):
            out[i] = total.chunk(n, dim=axis)[r].to(xs[i].device)
    return out


def ppermute(xs: Sequence[torch.Tensor], axis_name,
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """Position ``dst`` of each group gets position ``src``'s value for
    every ``(src, dst)`` in ``perm`` (indices along the axis); a position
    no pair names gets zeros, as ``lax.ppermute``."""
    _bump("ppermute")
    body = _body(xs, axis_name)
    out = [None] * len(xs)
    for g in body.groups(axis_name):
        for src, dst in perm:
            out[g[dst]] = xs[g[src]].to(xs[g[dst]].device)
        for i in g:
            if out[i] is None:
                out[i] = torch.zeros_like(xs[i])
    return out


def all_to_all(xs: Sequence[torch.Tensor], axis_name, split_axis: int,
               concat_axis: int, tiled: bool = True) -> List[torch.Tensor]:
    """Each position splits its value into n pieces along ``split_axis``
    and sends piece j to position j; each joins what it receives along
    ``concat_axis`` in source order (``lax.all_to_all(tiled=True)``)."""
    if not tiled:
        raise NotImplementedError("all_to_all: only the tiled form")
    _bump("all_to_all")
    body = _body(xs, axis_name)
    out = [None] * len(xs)
    for g in body.groups(axis_name):
        n = len(g)
        if xs[g[0]].shape[split_axis] % n:
            raise ValueError(f"all_to_all: dim {split_axis} of size "
                             f"{xs[g[0]].shape[split_axis]} does not split "
                             f"{n} ways")
        pieces = [xs[i].chunk(n, dim=split_axis) for i in g]
        for j, i in enumerate(g):
            dev = xs[i].device
            out[i] = torch.cat([pieces[s][j].to(dev) for s in range(n)],
                               dim=concat_axis)
    return out


# ------------------------------------------------------------ shard_map
def _spec_axes(spec) -> List[str]:
    names = []
    for entry in (spec or ()):
        if entry is None:
            continue
        names.extend((entry,) if isinstance(entry, str) else entry)
    return names


def _split(arg, spec, body: _Body, devices) -> list:
    """One global input as its shard at every position of ``body``."""
    if not isinstance(arg, torch.Tensor):
        return [arg] * body.count
    out = []
    for p in range(body.count):
        t = arg
        for dim, entry in enumerate(spec or ()):
            if entry is None:
                continue
            names = (entry,) if isinstance(entry, str) else tuple(entry)
            block, count = 0, 1
            for a in names:
                k = body.names.index(a)
                block = block * body.sizes[k] + int(body.coords[p, k])
                count *= body.sizes[k]
            size = t.shape[dim]
            if size % count:
                raise ValueError(f"shard_map: dim {dim} of size {size} does "
                                 f"not split over {names} ({count} ways)")
            t = t.narrow(dim, block * (size // count), size // count)
        # meta tensors (symbol shape inference) carry shapes only
        out.append(t if t.device.type == "meta" else t.to(devices[p]))
    return out


def _join(shards: list, spec, body: _Body, device):
    """The positions' shards of one output as one tensor on ``device``:
    joined along the dims ``spec`` shards, the positions that differ on
    an axis the spec does not name taken to hold the same value."""
    spec = tuple(spec or ())
    named = set(_spec_axes(spec))
    blocks = {}
    dims = [d for d, e in enumerate(spec) if e is not None]
    for p in range(body.count):
        if any(body.coords[p, k] for k, a in enumerate(body.names)
               if a not in named):
            continue
        key = []
        for d in dims:
            e = spec[d]
            names = (e,) if isinstance(e, str) else tuple(e)
            block = 0
            for a in names:
                k = body.names.index(a)
                block = block * body.sizes[k] + int(body.coords[p, k])
            key.append(block)
        blocks[tuple(key)] = shards[p]

    def level(prefix):
        if len(prefix) == len(dims):
            return blocks[prefix].to(device)
        e = spec[dims[len(prefix)]]
        names = (e,) if isinstance(e, str) else tuple(e)
        count = int(np.prod([body.sizes[body.names.index(a)]
                             for a in names]))
        return torch.cat([level(prefix + (i,)) for i in range(count)],
                         dim=dims[len(prefix)])

    return level(())


@contextlib.contextmanager
def _entered(body: _Body):
    prev = getattr(_tls, "body", None)
    _tls.body = body
    try:
        yield
    finally:
        _tls.body = prev


def shard_map(fn: Callable, mesh: DeviceMesh, in_specs, out_specs):
    """``fn`` over the positions of ``mesh`` in lockstep (see the module
    docstring).  ``in_specs``: one :class:`PartitionSpec` for every input,
    or one per input; ``out_specs``: one spec (``fn`` returns one list)
    or a tuple of specs (``fn`` returns a tuple of lists).  The body runs
    over the mesh axes the specs name; an input is replicated over the
    others and an output taken from their first position.  The outputs
    land on the first input tensor's device (the caller's)."""
    single = isinstance(out_specs, PartitionSpec)
    outs_spec = (out_specs,) if single else tuple(out_specs)

    def run(*args):
        ins = ([in_specs] * len(args) if isinstance(in_specs, PartitionSpec)
               else list(in_specs))
        if len(ins) != len(args):
            raise ValueError(f"shard_map: {len(args)} inputs, {len(ins)} "
                             f"in_specs")
        named = set()
        for s in list(ins) + list(outs_spec):
            named.update(_spec_axes(s))
        unknown = named - set(mesh.axis_names)
        if unknown:
            raise ValueError(f"shard_map: specs name axes {sorted(unknown)} "
                             f"that {mesh!r} lacks")
        body = _Body({a: s for a, s in mesh.axes.items() if a in named})
        grid = mesh.device_grid()
        devices = []
        for p in range(body.count):
            at = tuple(int(body.coords[p, body.names.index(a)])
                       if a in body.names else 0 for a in mesh.axis_names)
            devices.append(grid[at] if at else grid.item())
        caller = next((a.device for a in args
                       if isinstance(a, torch.Tensor)), devices[0])
        devices = [caller if caller.type == "meta" else d for d in devices]
        local = [_split(a, s, body, devices) for a, s in zip(args, ins)]
        with _entered(body):
            res = fn(*local)
        res = (res,) if single else tuple(res)
        joined = [_join(list(r), s, body, caller)
                  for r, s in zip(res, outs_spec)]
        return joined[0] if single else tuple(joined)

    return run


# ------------------------------------------------------------ eager layer
def allreduce_arrays(values: Sequence[torch.Tensor],
                     mesh: Optional[DeviceMesh] = None, axis: str = "dp",
                     average: bool = False) -> List[torch.Tensor]:
    """N same-shaped values (one per worker) to N reduced copies: a
    collective over ``axis`` when its size is N, else a pairwise sum."""
    n = len(values)
    if n == 1:
        return list(values)
    mesh = mesh or default_mesh()
    if mesh.axis_size(axis) == n:
        return (pmean if average else psum)(list(values), axis)
    total = pairwise_sum([torch.as_tensor(v) for v in values])
    if average:
        total = total / n
    return [total] * n


def allreduce_flat(flats: Sequence[torch.Tensor]) -> torch.Tensor:
    """One process: the per-replica flat buffers of a bucket summed
    pairwise into one (the first buffer itself when there is one)."""
    return flats[0] if len(flats) == 1 else pairwise_sum(flats)


def reduce_scatter_flat(flats: Sequence[torch.Tensor],
                        mesh: Optional[DeviceMesh] = None,
                        axis: str = "dp") -> List[torch.Tensor]:
    """N per-slot flat buffers to their sum laid out over ``axis``: the
    list of its shards, shard r at rank r.  N equal to the axis size runs
    one :func:`reduce_scatter`; one buffer (already the sum) or any other
    N is summed pairwise and split where it is.  The length must be a
    multiple of the axis size."""
    mesh = mesh or default_mesh()
    size = mesh.axis_size(axis)
    n = len(flats)
    if n > 1 and size == n:
        return reduce_scatter(list(flats), axis)
    flat = flats[0] if n == 1 else pairwise_sum(list(flats))
    if flat.shape[0] % size:
        raise ValueError(f"reduce_scatter_flat: length {flat.shape[0]} does "
                         f"not split over {axis} ({size} ways)")
    return list(flat.chunk(size))


def all_gather_flat(shards: Sequence[torch.Tensor],
                    mesh: Optional[DeviceMesh] = None,
                    axis: str = "dp") -> torch.Tensor:
    """The inverse of :func:`reduce_scatter_flat`: the shards of ``axis``
    joined into the whole buffer (one :func:`all_gather`), on the first
    shard's device."""
    del mesh
    if len(shards) == 1:
        return shards[0]
    return all_gather(list(shards), axis, axis=0)[0]


def pairwise_sum(raws: Sequence[torch.Tensor]) -> torch.Tensor:
    """Tree-shaped sum of same-shaped tensors, pairs first (reference
    ElementwiseSum, ``src/ndarray/ndarray.cc:1298``)."""
    vals = list(raws)
    while len(vals) > 1:
        nxt = [vals[i] + vals[i + 1] for i in range(0, len(vals) - 1, 2)]
        if len(vals) % 2:
            nxt.append(vals[-1])
        vals = nxt
    return vals[0]


def allreduce(nd_list, average: bool = False,
              mesh: Optional[DeviceMesh] = None):
    """Allreduce over a list of NDArrays, in place (reference Comm
    semantics)."""
    raw = allreduce_arrays([x._data for x in nd_list], mesh=mesh,
                           average=average)
    for x, r in zip(nd_list, raw):
        x._set_data(r)
    return nd_list


def broadcast_value(value, n: int) -> List:
    return [value] * n


def barrier(mesh: Optional[DeviceMesh] = None) -> None:
    """Wait for the work queued on every card of the mesh.  One controller
    drives every position in lockstep, so this is the whole of a
    barrier, as in the JAX package."""
    mesh = mesh or default_mesh()
    for dev in dict.fromkeys(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


# ------------------------------------------------------------ processes
class PendingReduce:
    """An all-reduce in flight; :meth:`wait` returns its result."""

    def __init__(self, out: torch.Tensor, work, divisor: int = 0):
        self._out, self._work, self._divisor = out, work, divisor

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
        if self._divisor:
            self._out.div_(self._divisor)
            self._divisor = 0
        return self._out


def cross_process_allreduce(x: torch.Tensor, average: bool = False,
                            async_op: bool = False):
    """``x`` summed (or averaged) over every process of the job, in a new
    tensor (``x`` is left as it was); ``x`` itself in one process.  With
    ``async_op`` the reduction is issued and a :class:`PendingReduce`
    comes back.  A failed collective raises: nothing here carries on
    past it."""
    n = distributed.process_count()
    if n <= 1:
        return PendingReduce(x, None) if async_op else x
    out = x.detach().clone(memory_format=torch.contiguous_format)
    work = dist.all_reduce(out, op=dist.ReduceOp.SUM, async_op=async_op)
    pending = PendingReduce(out, work, n if average else 0)
    return pending if async_op else pending.wait()


def broadcast_from(x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank, in a new tensor (bit for bit,
    where a masked sum would turn -0.0 into 0.0); ``x`` in one process."""
    if distributed.process_count() <= 1:
        return x
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.broadcast(out, src=src)
    return out
