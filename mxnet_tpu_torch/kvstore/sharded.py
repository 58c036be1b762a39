"""ZeRO-style sharded optimizer update over the kvstore bucket machinery
(counterpart of ``mxnet_tpu/kvstore/sharded.py``).

The replicated data-parallel step keeps every parameter and every
optimizer slot at every position.  ZeRO stage 1/2 (Rajbhandari et al.,
2020) restructures the same schedule around the same flat buckets:

* each bucket's gradient is **reduce-scattered** over the ``dp`` axis —
  position r receives only shard r of the summed gradient;
* the optimizer update runs **only on the position's shard**: the
  Adam/SGD slots are flat buffers, zero-padded to a multiple of ``dp``
  and split in ``dp`` shards, each its own tensor on its position's
  device, so the slots a position holds are 1/N of the replicated ones;
* the updated parameter shards are **all-gathered** back into the
  replicated parameters.

The parity contract: training is bit for bit the replicated path's.  The
flat update calls the same in-place update functions the per-key updater
calls (``ops/optimizer_ops.py``), which are elementwise, so an element
updated in a slice of a flat buffer comes out as it does in its own
parameter; concatenation, padding and splitting change no value (padding
is zeros, whose updates are zero and are sliced away).  A reduce-scatter
of one buffer (the sum already taken, as in the compiled step's global
view) is a slice of that sum, never a second sum in another order.

:class:`ShardedOptimizerEngine` is the eager engine the device and dist
kvstores drive from ``_push_group`` when ``MXNET_KVSTORE_SHARD`` /
``Trainer(optimizer_state_sharding=True)`` is set;
:class:`FlatShardedState` holds the slots of
``CompiledTrainStep(shard_optimizer_state=True)`` and runs the same
update inside its step (and its CUDA graph).

On one card every position's shard lives in the same memory: the mesh
shows the partition, the accounting (:meth:`~ShardedOptimizerEngine.
state_bytes`) and the mix of collectives, not memory saved on the card.
"""
from __future__ import annotations

import time as _time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..base import MXNetError
from ..observability import metrics as _metrics
from ..ops.optimizer_ops import (adam_update, adamw_update, sgd_mom_update,
                                 sgd_update)

__all__ = ["ShardedOptimizerEngine", "FlatShardedState", "apply_flat_update",
           "corrected_lr", "per_key_hyper", "supports_optimizer",
           "sharded_push_supported", "live_accounting", "axis_devices"]

_M_SHARD_BYTES = _metrics.registry().gauge(
    "mxnet_tpu_kvstore_shard_bytes_per_rank",
    "Per-rank optimizer-state bytes held by the sharded (ZeRO) kvstore "
    "engines: one dp shard of every materialized flat slot buffer.")
_M_SCATTER_SECONDS = _metrics.registry().histogram(
    "mxnet_tpu_kvstore_shard_scatter_seconds",
    "Host wall time to dispatch one bucket's gradient reduce-scatter "
    "(async dispatch: execution overlaps later staging).")
_M_GATHER_SECONDS = _metrics.registry().histogram(
    "mxnet_tpu_kvstore_shard_gather_seconds",
    "Host wall time to dispatch one bucket's updated-parameter all-gather "
    "(async dispatch: execution overlaps later buckets' updates).")

#: optimizers with a flat-bucket update (the update below calls the same
#: in-place functions their per-key ``update()`` calls)
_FLAT_UPDATE_KINDS = ("SGD", "Adam", "AdamW")


def supports_optimizer(opt) -> bool:
    """True when ``opt`` has a flat-shard update that reproduces its
    per-key math bit for bit.  Exact-type match: subclasses (NAG, ...)
    override ``update()`` with math the flat update does not render."""
    return (type(opt).__name__ in _FLAT_UPDATE_KINDS
            and not getattr(opt, "multi_precision", False))


def corrected_lr(opt, lr, t):
    """Adam-family bias-corrected lr, the literal expression of
    ``Adam._step_size``, so the eager engine (Python floats) and the
    compiled step (0-dim fp32 tensors) reproduce it bit for bit."""
    if type(opt).__name__ in ("Adam", "AdamW"):
        return lr * (1.0 - opt.beta2 ** t) ** 0.5 / (1.0 - opt.beta1 ** t)
    return lr


def apply_flat_update(opt, weight: torch.Tensor, grad: torch.Tensor, state,
                      lr, wd) -> None:
    """One optimizer step on a flat (slice of a) bucket buffer, in place:
    ``sgd_update``/``sgd_mom_update``/``adam_update``/``adamw_update``,
    the functions the per-key path calls.  ``lr`` arrives Adam-corrected
    (:func:`corrected_lr`); ``lr``/``wd`` are the keys' own (a run of
    keys that share them, :func:`per_key_hyper`)."""
    kind = type(opt).__name__
    kw = dict(lr=lr, wd=wd, rescale_grad=opt.rescale_grad,
              clip_gradient=opt.clip_gradient)
    if kind == "SGD":
        if state is None:
            sgd_update(weight, grad, **kw)
        else:
            sgd_mom_update(weight, grad, state, momentum=opt.momentum, **kw)
    elif kind in ("Adam", "AdamW"):
        mean, var = state
        (adam_update if kind == "Adam" else adamw_update)(
            weight, grad, mean, var, beta1=opt.beta1, beta2=opt.beta2,
            epsilon=opt.epsilon, **kw)
    else:  # supports_optimizer() gates callers; reaching here is a bug
        raise MXNetError(f"no flat-shard update for optimizer {kind}")


def _same(a, b) -> bool:
    """Equal hyperparameters: the same object (a training step's device
    scalar, made once per multiplier), or equal Python numbers."""
    if a is b:
        return True
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return False
    return a == b


def per_key_hyper(values: Sequence, sizes: Sequence[int],
                  n_pad: int) -> List[Tuple[int, int, object]]:
    """The bucket's per-key hyperparameters as runs ``(start, stop,
    value)`` over its flat layout: one run when every key shares the
    value (the common case), else one per stretch of keys that share it.
    The last run covers the padding (zero elements, zero updates).  Where
    the JAX package renders differing values as a per-element vector, the
    port updates each run with its key's scalar, which is what the per-key
    path computes."""
    runs: List[list] = []
    off = 0
    for v, s in zip(values, sizes):
        if runs and all(_same(a, b) for a, b in zip(runs[-1][2], v)):
            runs[-1][1] = off + s
        else:
            runs.append([off, off + s, v])
        off += s
    runs[-1][1] = max(n_pad, off)
    return [tuple(r) for r in runs]


def _slice_state(state, a: int, b: int):
    if state is None:
        return None
    if isinstance(state, torch.Tensor):
        return state[a:b]
    return tuple(_slice_state(s, a, b) for s in state)


def _state_leaves(state):
    if state is None:
        return
    if isinstance(state, torch.Tensor):
        yield state
        return
    for s in state:
        yield from _state_leaves(s)


def update_shards(opt, w_shards, g_shards, states, runs, shard_len) -> None:
    """Each position's update on its shard: position r holds elements
    ``[r·shard_len, (r+1)·shard_len)`` of the bucket, updated run by run
    (:func:`per_key_hyper`) with its own state shard."""
    for r, (w, g, st) in enumerate(zip(w_shards, g_shards, states)):
        lo = r * shard_len
        for a, b, (lr, wd) in runs:
            a, b = max(a, lo) - lo, min(b, lo + shard_len) - lo
            if a < b:
                apply_flat_update(opt, w[a:b], g[a:b], _slice_state(st, a, b),
                                  lr, wd)


def axis_devices(mesh, axis: str = "dp") -> List[torch.device]:
    """The device of each position along ``axis`` (the other axes at
    their first position): where each shard lives."""
    if mesh is None or axis not in mesh.axis_names:
        return [mesh.devices[0] if mesh is not None else torch.device("cpu")]
    grid = mesh.device_grid()
    at = tuple(slice(None) if a == axis else 0 for a in mesh.axis_names)
    return list(grid[at])


def _hyper(opt, index):
    """``(lr, wd)`` of one key as its per-key update computes them: Adam's
    lr bias-corrected (inside a training step once per lr multiplier)."""
    kind = type(opt).__name__
    if kind in ("Adam", "AdamW"):
        lr = opt._per_step("adam", index, lambda: corrected_lr(
            opt, opt._get_lr(index), opt._t(index)))
    else:
        lr = opt._get_lr(index)
    return lr, opt._get_wd(index)


def sharded_push_supported(store) -> Optional[str]:
    """None when the store can run the sharded push; else the reason it
    cannot (the store warns once and takes the replicated push)."""
    from .. import distributed
    if store._updater is None or store._optimizer is None:
        return ("no optimizer on the kvstore — sharding runs the update on "
                "the scattered gradient shard (update_on_kvstore mode)")
    if not supports_optimizer(store._optimizer):
        return (f"optimizer {type(store._optimizer).__name__} has no "
                f"flat-shard update (supported: {'/'.join(_FLAT_UPDATE_KINDS)}"
                ", single precision)")
    if distributed.process_count() > 1:
        return "multi-process job (cross-process reduce-scatter not wired)"
    return None


_ENGINES: "weakref.WeakSet" = weakref.WeakSet()


def live_accounting() -> Dict[str, object]:
    """Per-position and replicated-equivalent byte accounting over every
    live kvstore engine."""
    out = {"engines": 0, "dp": None, "param_bytes": 0,
           "grad_bytes_per_step": 0, "state_bytes_replicated": 0,
           "state_bytes_per_rank": 0}
    for eng in list(_ENGINES):
        rep, shard = eng.state_bytes()
        out["engines"] += 1
        out["dp"] = eng.dp
        out["param_bytes"] += eng.param_bytes
        out["grad_bytes_per_step"] += eng.grad_bytes
        out["state_bytes_replicated"] += rep
        out["state_bytes_per_rank"] += shard
    return out


def _register_ledger() -> None:
    # the memory ledger's ZeRO component (the callback walks the weakset,
    # so no engine is pinned by it)
    from ..observability import memory as _memory
    _memory.ledger().register(
        "kvstore:optimizer_shards",
        lambda: float(live_accounting()["state_bytes_per_rank"]))


def _shard_bytes(states) -> Tuple[int, int]:
    """(every position's bytes, position 0's) of a list of position
    trees."""
    total = sum(t.numel() * t.element_size()
                for st in states for t in _state_leaves(st))
    first = sum(t.numel() * t.element_size()
                for t in _state_leaves(states[0])) if states else 0
    return total, first


def _flat(tensors, n_pad: int) -> torch.Tensor:
    """The tensors' flat concatenation, zero-padded to ``n_pad``."""
    parts = [t.detach().reshape(-1) for t in tensors]
    n = sum(p.numel() for p in parts)
    if n_pad > n:
        parts.append(parts[0].new_zeros(n_pad - n))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def _placed(shards, devices) -> List[torch.Tensor]:
    """Shard r on position r's device (on one card, the shard itself)."""
    return [t.to(d) for t, d in zip(shards, devices)]


@torch.no_grad()
def _write_back(tensors, full: torch.Tensor) -> None:
    """Split the gathered flat buffer back into ``tensors``, in place."""
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(full[off:off + n].view_as(t))
        off += n


def _make_shards(opt, index, dtype, shard_len, devices):
    """One zeroed state tree per position, each on its device."""
    return [opt.create_state_multi_precision(
        index, torch.zeros(shard_len, dtype=dtype, device=d))
        for d in devices]


class FlatShardedState:
    """The dp-sharded optimizer slots of a training step: per bucket of
    ``params`` (lists of indices), one flat buffer per slot, zero-padded to
    a multiple of ``dp`` and held as ``dp`` shards, shard r on the device
    of position r of ``axis``.  :meth:`step` runs one update from the
    whole gradients: the bucket's gradient reduce-scattered (a slice of
    the one sum), each position's update on its shard, the shards
    all-gathered back into the parameters in place (a CUDA graph reads
    them at fixed addresses)."""

    def __init__(self, opt, params: Sequence[torch.Tensor],
                 buckets: List[List[int]], mesh, axis: str = "dp"):
        self.buckets = [list(b) for b in buckets]
        self.mesh, self.axis = mesh, axis
        self.dp = mesh.axis_size(axis)
        self.devices = axis_devices(mesh, axis)
        self.sizes = [[params[i].numel() for i in b] for b in self.buckets]
        self.shard_len = []
        self.states = []
        for b, sizes in zip(self.buckets, self.sizes):
            n = sum(sizes)
            s = (n + (-n) % self.dp) // self.dp
            self.shard_len.append(s)
            self.states.append(_make_shards(opt, b[0], params[b[0]].dtype, s,
                                            self.devices))

    def state_bytes(self) -> Tuple[int, int]:
        """(every position's slot bytes — the replicated-equivalent,
        padding included — and position 0's)."""
        rep = shard = 0
        for st in self.states:
            a, b = _shard_bytes(st)
            rep, shard = rep + a, shard + b
        return rep, shard

    @torch.no_grad()
    def step(self, opt, params, grads) -> None:
        from ..parallel import collectives as C
        for b, idxs in enumerate(self.buckets):
            n_pad = self.shard_len[b] * self.dp
            g_shards = _placed(C.reduce_scatter_flat(
                [_flat([grads[i] for i in idxs], n_pad)], self.mesh,
                self.axis), self.devices)
            w_shards = _placed(_flat([params[i] for i in idxs], n_pad)
                               .chunk(self.dp), self.devices)
            runs = per_key_hyper([_hyper(opt, i) for i in idxs],
                                 self.sizes[b], n_pad)
            update_shards(opt, w_shards, g_shards, self.states[b], runs,
                          self.shard_len[b])
            _write_back([params[i] for i in idxs], C.all_gather_flat(
                w_shards, self.mesh, self.axis))

    # ------------------------------------------------------------ layout
    def gather(self, params) -> list:
        """Every parameter's state at its global shape, new tensors (what
        a checkpoint stores: a restore onto another ``dp`` re-slices)."""
        out = [None] * len(params)
        for b, idxs in enumerate(self.buckets):
            def join(*shards):
                flat = torch.cat([t.to(shards[0].device) for t in shards])
                per, off = [], 0
                for i, n in zip(idxs, self.sizes[b]):
                    per.append(flat[off:off + n].view(params[i].shape)
                               .clone())
                    off += n
                return per
            joined = _tree_map(join, *self.states[b])
            for k, i in enumerate(idxs):
                out[i] = _tree_map(lambda per, k=k: per[k], joined)
        return out

    @torch.no_grad()
    def scatter(self, states) -> None:
        """Copy per-parameter states at their global shapes into the
        shards, in place (the inverse of :meth:`gather`)."""
        for b, idxs in enumerate(self.buckets):
            s = self.shard_len[b]

            def fill(*leaves):
                live, per = leaves[:self.dp], leaves[self.dp:]
                flat = torch.cat([t.reshape(-1).to(live[0].device)
                                  for t in per])
                pad = s * self.dp - flat.numel()
                if pad:
                    flat = torch.cat([flat, flat.new_zeros(pad)])
                for r, t in enumerate(live):
                    t.copy_(flat[r * s:(r + 1) * s])
            _tree_map(fill, *self.states[b], *[states[i] for i in idxs])


def _tree_map(fn, *trees):
    """``fn`` over the matching leaves of state trees (None, a tensor, a
    tuple of them; a list leaf is taken as a leaf)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return tuple(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


class ShardedOptimizerEngine:
    """Eager scatter→update→gather engine for one kvstore.

    Owns the dp-sharded flat optimizer slots, keyed by bucket layout
    signature (the same keys in the same order: the same signature, so the
    slots carry across steps as per-key slots would).  The owning store
    routes dense ``_push_group`` keys here when its
    ``optimizer_state_sharding`` is on."""

    def __init__(self, store):
        self._store = store
        # bucket signature -> list over dp positions of that position's
        # state tree (flat shards), made at first touch
        self._states: Dict[tuple, Optional[list]] = {}
        self._mesh = None
        self.param_bytes = 0
        self.grad_bytes = 0
        _ENGINES.add(self)
        _register_ledger()

    @property
    def dp(self) -> int:
        return self._mesh.axis_size("dp") if self._mesh is not None else 1

    # ------------------------------------------------------------- step
    def step(self, entries) -> None:
        """One training step: ``entries`` is ``[(key, sk, vals,
        priority)]`` for the dense initialized keys of a batched push, in
        the caller's key order (the bucket layout's determinant)."""
        from ..parallel.mesh import default_mesh
        from .bucketing import GradientBucketer
        store = self._store
        self._mesh = default_mesh()
        comp = store._compression
        compress = None
        if comp is not None:
            def compress(sig, shards):
                # the elementwise quantizer on each scattered shard is the
                # replicated bucket round trip, sliced; the residuals are
                # per shard and keyed apart from the replicated path's
                return [comp.roundtrip(("shard", r) + sig, s)
                        for r, s in enumerate(shards)]
        bucketer = GradientBucketer(self._reduce_scatter, compress_fn=compress)
        self.param_bytes = 0
        self.grad_bytes = 0
        for key, sk, vals, prio in entries:
            bucketer.stage(key, sk, store._bucket_stage_raws(vals), prio)
            stored = store._store[sk]._data
            self.param_bytes += stored.numel() * stored.element_size()
        for bucket in bucketer.flush_buckets():
            self._update_bucket(bucket)
        _M_SHARD_BYTES.set(live_accounting()["state_bytes_per_rank"])

    # ------------------------------------------------------------- scatter
    def _reduce_scatter(self, flats, desc):
        """Bucket reduce hook: zero-pad each slot's flat buffer to a
        multiple of ``dp``, then reduce-scatter under the store's
        collective guard.  Returns the positions' shards, each on its
        position's device."""
        from ..observability import goodput as _goodput
        from ..parallel.collectives import reduce_scatter_flat
        n = int(flats[0].numel())
        pad = (-n) % max(self.dp, 1)
        if pad:
            flats = [torch.cat([f, f.new_zeros(pad)]) for f in flats]
        self.grad_bytes += n * flats[0].element_size()
        t0 = _time.perf_counter()
        with _goodput.train().timed("collective"):
            out = self._store._shard_collective(
                f"reduce_scatter({desc})",
                lambda: reduce_scatter_flat(flats, mesh=self._mesh))
        _M_SCATTER_SECONDS.observe(_time.perf_counter() - t0)
        return _placed(out, axis_devices(self._mesh))

    # ------------------------------------------------------------- update
    def _update_bucket(self, bucket) -> None:
        from ..observability import goodput as _goodput
        from ..parallel.collectives import all_gather_flat
        store = self._store
        opt = store._optimizer
        entries = bucket.entries
        g_shards = bucket.result
        s = int(g_shards[0].numel())
        n_pad = s * len(g_shards)
        devices = axis_devices(self._mesh)
        stored = [store._store[e.sk]._data for e in entries]
        # the parameters' flat buffer rebuilt from the store each step: the
        # stored values are the source of truth; laying it out over the
        # positions is a local slice each
        w_shards = _placed(_flat(stored, n_pad).chunk(len(g_shards)),
                           devices)
        # per-key counts advanced in staging order, each key's lr and wd
        # computed as its per-key update computes them
        hyper = []
        for e in entries:
            opt._update_count(e.key)
            hyper.append(_hyper(opt, e.key))
        runs = per_key_hyper(hyper, [e.size for e in entries], n_pad)
        sig = bucket.signature()
        if sig not in self._states:
            # lazy per-position slots: each position's shard made on its
            # device, so state memory is 1/N a position from the start
            self._states[sig] = _make_shards(opt, entries[0].key,
                                             stored[0].dtype, s, devices)
        update_shards(opt, w_shards, g_shards, self._states[sig], runs, s)
        t0 = _time.perf_counter()
        with _goodput.train().timed("collective"):
            full = store._shard_collective(
                f"all_gather(bucket={len(entries)}keys/{bucket.nbytes}B/"
                f"{bucket.group[0]})",
                lambda: all_gather_flat(w_shards, mesh=self._mesh))
        _M_GATHER_SECONDS.observe(_time.perf_counter() - t0)
        # back into the stored values, in place and on their device
        _write_back(stored, full)

    # ------------------------------------------------------------- telemetry
    def state_bytes(self) -> Tuple[int, int]:
        """(replicated-equivalent, per-position) optimizer-state bytes
        across every materialized slot buffer."""
        rep = shard = 0
        for st in self._states.values():
            if st is not None:
                a, b = _shard_bytes(st)
                rep, shard = rep + a, shard + b
        return rep, shard
