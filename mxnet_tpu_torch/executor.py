"""The training step (counterpart of ``mxnet_tpu/executor.py``).

:class:`CompiledTrainStep` keeps the JAX package's name and contract:
forward in training mode (``net(*x)`` for a tuple ``x``),
``loss_fn(out, y).mean()``, the gradients of that mean
(``torch.autograd.grad``; a parameter the loss does not reach gets a zero
gradient and is still updated, as under ``jax.value_and_grad``), then one
optimizer update per learnable parameter in ``parameters()`` order (the
JAX package's ``collect_params`` order).  For the updates the optimizer's
``lr`` and ``_step`` are two 0-dim fp32 tensors on the parameters' device,
its ``lr_scheduler`` is ``None``, its ``rescale_grad`` 1.0 (the mean
already averages) and each per-step scalar is made once per lr multiplier
(``_step_sizes``); all are restored after.  The host writes the
tensors before each step: the optimizer's ``_lr_at_step(count + 1)`` (its
scheduler's rate, times LBSGD's warmup), indexed by the step's own 1-based
count as the JAX ``_lr_at`` is, and that count for the bias corrections.
Tensors an optimizer keeps across steps besides its states (Nadam's
running schedule, ``_step_state``) are made at the first step and read in
place.  BN moving statistics are written in place by the forward.

The JAX package jits the step into one XLA program.  On the card the port
records it as one CUDA graph per signature (each input's shape and dtype,
and the addresses of the parameters, buffers, optimizer states and the
two scalars), with :mod:`~mxnet_tpu_torch._graphs`:

* a signature's first call runs the step eagerly (:func:`_graphs.warm`)
  and is the step; the capture follows, from one memory pool per step
  object, with the device's stream and every CUDA generator a module of
  the net holds registered, so each replay draws fresh dropout masks;
* a later call copies its inputs into the graph's static inputs, writes
  the learning rate and step count (``fill_``: no host copy, no sync),
  replays, advances the optimizer's counts as the eager step does, and
  returns a clone of the graph's loss;
* an address that moved (a ``cast``) captures again, and a capture that
  fails raises :class:`MXNetError`: nothing on the card falls back to the
  eager step.

Everything that lives across steps (parameters, moving statistics,
optimizer states, fp32 master copies, the scalars, the static inputs) is
allocated outside the graph's pool; only the step's temporaries and its
loss live in it.  On CPU tensors the step runs eagerly with the same
scalars.

A capture is the ``compile`` site and a replay the ``execute`` site of
:func:`~mxnet_tpu_torch.resilience.backend_call` (spans
``trainstep.compile`` / ``trainstep.execute``); a step object accounts its
parameters and optimizer states in the memory ledger as
``trainstep:<net class>``.

``health`` arms the numerics watchpoints of
:mod:`~mxnet_tpu_torch.observability.health` (None defers to
``MXNET_TPU_HEALTH``): the step computes per-parameter statistics after
its updates, inside the graph, from a clone of the parameters taken
before them (one more set of parameters in the graph's pool), and its
:class:`~mxnet_tpu_torch.observability.health.HealthMonitor` reads them
at its cadence.  With health armed, the modules' patched forwards and
forward hooks (:func:`~mxnet_tpu_torch.observability.health.hook_fingerprint`)
join the graph signature.  Under ``action="skip"`` each call first takes
a device copy of the parameters, the net's other tensors and the
optimizer states; a dropped call copies it back in place and rewinds the
step count and the optimizer's counts.

Each call is one record of the train goodput ledger: ``dispatch`` (input
unwrapping, scalars, staging), ``compile`` (a signature's eager first
call and capture), ``device_compute`` (the replay or the eager step);
``mxnet_tpu_executor_steps_total`` and ``mxnet_tpu_executor_step_seconds``
count the steps and their host time past any capture.  A replay returns
once its work is queued, so the device's time lands in whatever waits
for it next: the health fetch, the next call's staging, or the caller.

``mesh`` (a :class:`~mxnet_tpu_torch.parallel.DeviceMesh`) runs the step
over the mesh, single-controller as the JAX package's program is: the
net runs once in global view with the mesh entered, so the ops that have
per-position bodies shard themselves over it (the ring and Ulysses ops
the sequence over ``sp``, the MoE op the experts over ``ep`` and its
tokens over ``dp`` x ``ep``, the fused conv-BN op its rows over ``dp``)
and move data between positions through the collectives; the per-sample
loss is split over ``data_axis`` (the batch dim, or the flattened
batch-major tokens) and each position's mean joins the step's loss
through :func:`~mxnet_tpu_torch.parallel.pmean`, so autograd carries the
gradients back through that mean-reduction.  ``param_spec_fn(name,
tensor)`` (default :func:`~mxnet_tpu_torch.parallel.auto_param_spec_fn`,
the rule table) gives each parameter's spec (``param_specs``), which the
sharded ops read (:func:`~mxnet_tpu_torch.parallel.mesh.layout_of`);
positions that share a device share its tensors.  With every position on
one card the whole step, every position's work included, is one CUDA
graph; a mesh whose positions span several cards steps eagerly.
``fuse_grad_buckets`` defaults to on with a mesh, as in the JAX package.

Deliberate differences from the JAX package: the optimizer's per-index
counts and ``num_update`` advance once per step (MXNet's count; the JAX
step counts once per trace), so the skip rewinds them too; every
optimizer's step computes what its eager updates compute (the JAX step
cannot trace LARS's host norms or SGLD's ``math.sqrt(lr)``, and freezes
Nadam's count and schedule and LBSGD's warmup at the trace); ``donate``
has no effect (the graph updates in place already); a signature's first
call is eager; the returned loss is a clone.

``shard_optimizer_state`` (None defers to ``MXNET_KVSTORE_SHARD``; no
effect without a mesh, or on a mesh whose ``data_axis`` has one position)
is ZeRO inside the step (:class:`~mxnet_tpu_torch.kvstore.sharded.
FlatShardedState`): the optimizer states are flat buffers per gradient
bucket, each split in ``data_axis`` shards on their positions' devices;
each step slices the bucket's whole gradient (the global view's gradient
is the sum already: the "reduce-scatter" is a slice of it, never a second
sum), updates each position's shard with its slots through the per-key
update functions, and all-gathers the shards back into the parameters in
place.  Bit for bit the replicated step.  The JAX package pins each
parameter's slots dp-sharded in its program and lets the partitioner
schedule the same moves; an optimizer without a flat update (anything
but SGD, Adam and AdamW in single precision) warns once and keeps its
states replicated, where the JAX partitioner shards any slot.
:class:`MultiStepTrainStep` replays the sharded one-step graph K times,
so its states stay sharded inside the K window (the JAX variant holds
them replicated there and re-shards at the call's end).
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, List, Optional, Sequence, Tuple

import torch

from . import _graphs
from .base import MXNetError, env
from .cached_op import generators_of
from .contrib.amp import amp as _amp
from .observability import (goodput as _goodput, health as _health,
                            memory as _memory, metrics as _metrics,
                            tracing as _tracing)
from .resilience import backend_call

__all__ = ["CompiledTrainStep", "MultiStepTrainStep", "compile_train_step",
           "compile_forward", "stack_batches"]


_M_STEPS = _metrics.registry().counter(
    "mxnet_tpu_executor_steps_total",
    "CompiledTrainStep steps taken (a MultiStepTrainStep call counts K).")
_M_STEP_SECONDS = _metrics.registry().histogram(
    "mxnet_tpu_executor_step_seconds",
    "Host wall time of one training-step call past any capture (on the "
    "card a replay returns once queued).")


def _fuse_grad_buckets(grads, buckets):
    """Concatenate each bucket's gradients into one flat buffer and split
    it back (the JAX package's in-trace fusion): an identity on values."""
    out = list(grads)
    for idxs in buckets:
        if len(idxs) < 2:
            continue
        flat = torch.cat([out[i].reshape(-1) for i in idxs])
        off = 0
        for i in idxs:
            n = out[i].numel()
            out[i] = flat[off:off + n].view(out[i].shape)
            off += n
    return out


def _leaves(state) -> List[torch.Tensor]:
    """The tensors of an optimizer state (None, a tensor or a tuple)."""
    if state is None:
        return []
    if isinstance(state, torch.Tensor):
        return [state]
    return [t for s in state for t in _leaves(s)]


def _unwrap(v):
    """``(tensors, context)``: NDArrays (a Gluon iterator's batches) give
    their tensors and their context, tuples stay tuples."""
    from .ndarray.ndarray import NDArray
    if isinstance(v, (tuple, list)):
        parts = [_unwrap(a) for a in v]
        ctx = next((c for _, c in parts if c is not None), None)
        return tuple(t for t, _ in parts), ctx
    if isinstance(v, NDArray):
        return v._data, v.context
    return v, None


def _remat_contexts(gens: Sequence[torch.Generator],
                    buffers: Sequence[torch.Tensor]):
    """``checkpoint``'s context pair for ``remat``: the forward notes each
    generator's state, and the recomputation draws from it again (the
    forward's dropout masks) and leaves the buffers as it found them (the
    moving statistics move once per step, as under ``jax.checkpoint``)."""
    saved: List[torch.Tensor] = []

    @contextlib.contextmanager
    def forward():
        saved[:] = [g.get_state() for g in gens]
        yield

    @contextlib.contextmanager
    def recompute():
        now = [g.get_state() for g in gens]
        kept = [b.clone() for b in buffers]
        for g, s in zip(gens, saved):
            g.set_state(s)
        try:
            yield
        finally:
            for g, s in zip(gens, now):
                g.set_state(s)
            with torch.no_grad():
                for b, k in zip(buffers, kept):
                    b.copy_(k)

    return forward(), recompute()


class _StepGraph:
    """One signature's captured step (``stats``: the watchpoints' outputs,
    None with health off)."""

    __slots__ = ("graph", "static_in", "loss", "stats", "addr")

    def __init__(self, graph, static_in, loss, stats, addr):
        self.graph, self.static_in = graph, static_in
        self.loss, self.stats, self.addr = loss, stats, addr


class CompiledTrainStep:
    """One training step over ``net`` + ``loss_fn`` + ``optimizer`` (an
    :class:`~mxnet_tpu_torch.optimizer.Optimizer`); on the card one CUDA
    graph per signature (see the module docstring).

    ``batch_size`` is informational: gradients are those of the mean
    loss.  ``donate`` is accepted and has no effect: the graph and the
    eager step update every tensor in place.  ``remat`` wraps the forward
    in ``torch.utils.checkpoint`` (the forward runs again in the
    backward, drawing the same masks).  ``fuse_grad_buckets`` (default
    off, as the JAX package without a mesh) concatenates the gradients
    into ``MXNET_KVSTORE_BUCKET_KB`` buckets and splits them back, which
    changes no value.  ``health`` (True, a dict, a
    :class:`~mxnet_tpu_torch.observability.health.HealthConfig`; None
    defers to ``MXNET_TPU_HEALTH``) arms the watchpoints.  ``mesh``,
    ``data_axis`` and ``param_spec_fn`` run the step over a device mesh
    (see the module docstring), ``shard_optimizer_state`` shards the
    optimizer states over ``data_axis`` (ZeRO, the module docstring)."""

    def __init__(self, net, loss_fn, optimizer, batch_size: Optional[int] = None,
                 mesh=None, data_axis: str = "dp", param_spec_fn=None,
                 donate: bool = True, remat: bool = False,
                 fuse_grad_buckets: Optional[bool] = None,
                 shard_optimizer_state: Optional[bool] = None, health=None):
        if shard_optimizer_state is None:
            shard_optimizer_state = mesh is not None and \
                bool(env.MXNET_KVSTORE_SHARD)
        self.shard_optimizer_state = bool(shard_optimizer_state) and \
            mesh is not None
        from .parallel.mesh import DeviceMesh
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise MXNetError(f"CompiledTrainStep: mesh must be a "
                             f"parallel.DeviceMesh, got {type(mesh).__name__}")
        self._mesh = mesh
        self._data_axis = data_axis
        if fuse_grad_buckets is None:
            fuse_grad_buckets = mesh is not None
        if health is None:
            health = bool(env.MXNET_TPU_HEALTH)
        cfg = _health.HealthConfig.coerce(health)
        self._hmon = (_health.HealthMonitor(cfg)
                      if cfg is not None and cfg.watchpoints else None)
        self._health = self._hmon is not None
        # a MultiStepTrainStep's stats carry a leading K axis
        self._stats_stacked = False
        self._net = net
        self._loss_fn = loss_fn
        self._opt = optimizer
        self.batch_size = batch_size
        self._remat = remat
        self._learnable = [p for p in net.parameters() if p.requires_grad]
        self._grad_buckets: Optional[List[List[int]]] = None
        cap = max(int(env.MXNET_KVSTORE_BUCKET_KB), 0) * 1024
        from .kvstore.bucketing import partition_bucket_indices

        def buckets():
            return partition_bucket_indices(
                [p.numel() * p.element_size() for p in self._learnable],
                [str(p.dtype) for p in self._learnable], cap)
        if fuse_grad_buckets and cap > 0 and len(self._learnable) > 1:
            self._grad_buckets = buckets()
        self.grad_bucket_count = (len(self._grad_buckets)
                                  if self._grad_buckets
                                  else len(self._learnable))
        # ZeRO: the states as dp shards of flat bucket buffers
        self._zero = None
        if self.shard_optimizer_state and \
                mesh.axis_size(data_axis) > 1 and self._learnable:
            from .kvstore.sharded import FlatShardedState, supports_optimizer
            if supports_optimizer(optimizer):
                self._zero = FlatShardedState(
                    optimizer, self._learnable,
                    self._grad_buckets or buckets(), mesh, data_axis)
                self.grad_bucket_count = len(self._zero.buckets)
            else:
                import warnings
                warnings.warn(
                    "mxnet_tpu: shard_optimizer_state requested but "
                    f"{type(optimizer).__name__} has no flat-shard update "
                    "(SGD/Adam/AdamW, single precision): its states stay "
                    "replicated")
        self._states = (self._zero.states if self._zero is not None else
                        [optimizer.create_state_multi_precision(i, p)
                         for i, p in enumerate(self._learnable)])
        self._names = _health.param_names(net, self._learnable)
        self.param_specs = {}
        self._layouts = {}
        if mesh is not None:
            from .parallel.rules import auto_param_spec_fn
            spec_fn = param_spec_fn or auto_param_spec_fn(mesh)
            for name, p in net.named_parameters():
                if p.requires_grad:
                    spec = spec_fn(name, p)
                    self.param_specs[name] = spec
                    self._layouts[id(p)] = spec
        # positions on several cards cannot share one CUDA graph
        self._eager_only = mesh is not None and len(
            {d for d in mesh.devices if d.type == "cuda"}) > 1
        self._num_update = 0
        self._compile_seconds = 0.0
        self._trace_id: Optional[int] = None
        # lr and the 1-based step count, 0-dim fp32 on the parameters'
        # device: what the optimizer reads inside a step
        self._scalars: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        # the optimizer's tensors that live across steps besides its
        # states (Nadam's running schedule)
        self._opt_tensors: List[torch.Tensor] = []
        self._graphs = {}
        self._pool = None
        self._misses = self._captures = self._replays = 0
        _memory.ledger().register_object(
            f"trainstep:{type(net).__name__}", self,
            lambda step: float(step.live_bytes()))

    @property
    def _aux(self) -> List[torch.Tensor]:
        """The net's tensors without a gradient, in ``compile_forward``'s
        order: the frozen parameters, then the buffers (BatchNorm's
        moving statistics).  What a checkpoint's ``aux`` holds."""
        return ([p for p in self._net.parameters() if not p.requires_grad]
                + list(self._net.buffers()))

    def live_bytes(self) -> int:
        """Bytes of the parameters, buffers and optimizer states the step
        holds, every position's shard included (the memory ledger's
        ``trainstep:`` component)."""
        return sum(t.numel() * t.element_size() for t in (
            list(self._net.parameters()) + list(self._net.buffers())
            + [t for s in self._states for t in _leaves(s)]))

    def optimizer_state_bytes(self) -> Tuple[int, int]:
        """(replicated-equivalent, one position's) optimizer-state bytes:
        with sharded states the second is 1/N of the first (padding
        included in both); replicated, the two are equal."""
        if self._zero is not None:
            return self._zero.state_bytes()
        n = sum(t.numel() * t.element_size()
                for s in self._states for t in _leaves(s))
        return n, n

    def optimizer_states(self) -> list:
        """Each learnable parameter's optimizer state at the parameter's
        shape: the live tensors, or with sharded states new tensors
        gathered from the shards (what a checkpoint stores)."""
        if self._zero is not None:
            return self._zero.gather(self._learnable)
        return list(self._states)

    def load_optimizer_states(self, states) -> None:
        """Write per-parameter states (:meth:`optimizer_states`' layout)
        into the live ones in place; sharded states re-slice them for this
        step's mesh."""
        if self._zero is not None:
            self._zero.scatter(states)
            return
        from .checkpoint import _copy_into
        for i, (live, st) in enumerate(zip(self._states, states)):
            _copy_into(live, st, f"opt_state/p{i}")

    # ------------------------------------------------------------ scalars
    def _lr_at(self, i: int) -> float:
        # the schedule is indexed by the step being taken, 1-based: eager
        # _update_count advances num_update before _get_lr reads it
        return self._opt._lr_at_step(self._num_update + 1 + i)

    def _write_scalars(self) -> None:
        """This step's lr and count into the scalars (made on the
        parameters' device at the first step, with the optimizer's own
        step tensors)."""
        if self._scalars is None:
            device = self._learnable[0].device
            self._scalars = (
                torch.zeros((), dtype=torch.float32, device=device),
                torch.zeros((), dtype=torch.float32, device=device))
            self._opt_tensors = self._opt._step_state(device)
        lr, t = self._scalars
        lr.fill_(self._lr_at(0))
        t.fill_(self._num_update + 1)

    # -------------------------------------------------------------- step
    def _mean_over_mesh(self, out, y) -> torch.Tensor:
        """The mean loss, each ``data_axis`` position's mean of its share
        of the per-sample losses joined by a pmean (a plain mean when the
        mesh lacks the axis or the samples do not split over it)."""
        from .parallel import collectives
        per = self._loss_fn(out, y)
        dp = self._mesh.axis_size(self._data_axis)
        if dp < 2 or per.dim() == 0 or per.shape[0] % dp:
            return per.mean()
        return collectives.pmean([c.mean() for c in per.chunk(dp)],
                                 self._data_axis)[0]

    def _loss(self, xs, y):
        def fwd(*a):
            if self._mesh is None:
                return self._loss_fn(self._net(*a), y).mean()
            from .parallel.mesh import param_layouts
            with self._mesh, param_layouts(self._layouts):
                return self._mean_over_mesh(self._net(*a), y)
        if not self._remat:
            return fwd(*xs)
        from torch.utils.checkpoint import checkpoint
        gens = generators_of(self._net, xs[0].device)
        buffers = list(self._net.buffers())
        return checkpoint(fwd, *xs, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=lambda: _remat_contexts(gens, buffers))

    def _run(self, xs, y):
        """Forward, gradients and every update, the optimizer reading the
        scalars; returns the detached mean loss and, with health armed,
        the watchpoints' statistics (else None).  What the graph
        records."""
        net, opt = self._net, self._opt
        was_training = net.training
        net.train()
        try:
            with (_health.capture_taps() if self._health
                  else contextlib.nullcontext({})) as taps:
                loss = self._loss(xs, y)
            grads = torch.autograd.grad(loss, self._learnable,
                                        allow_unused=True)
        finally:
            net.train(was_training)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self._learnable, grads)]
        if self._grad_buckets is not None and self._zero is None:
            grads = _fuse_grad_buckets(grads, self._grad_buckets)
        # the update's delta needs the parameters it started from, which
        # the updates overwrite in place
        old = ([p.detach().clone() for p in self._learnable]
               if self._health else None)
        lr, t = self._scalars
        names = ("lr", "lr_scheduler", "rescale_grad", "_step", "_step_sizes")
        saved = [getattr(opt, n, None) for n in names]
        for n, v in zip(names, (lr, None, 1.0, t, {})):
            setattr(opt, n, v)
        try:
            if self._zero is not None:
                for i in range(len(self._learnable)):
                    opt._update_count(i)
                self._zero.step(opt, self._learnable, grads)
            else:
                for i, (p, g, state) in enumerate(zip(
                        self._learnable, grads, self._states)):
                    opt.update_multi_precision(i, p.data, g, state)
        finally:
            for n, v in zip(names, saved):
                setattr(opt, n, v)
        loss = loss.detach()
        if not self._health:
            return loss, None
        return loss, _health.graph_stats(grads, old, self._learnable, loss,
                                         taps)

    def _reads(self) -> List[torch.Tensor]:
        """The tensors a graph reads or writes in place."""
        return (list(self._net.parameters()) + list(self._net.buffers())
                + [t for s in self._states for t in _leaves(s)]
                + list(self._scalars) + self._opt_tensors)

    def _signature(self, xs: tuple, y):
        """``(signature, flat inputs)``: each input's shape, dtype and
        device; with health armed, the net's hooks and patched forwards
        too (a fault plan entered after a capture takes a new graph)."""
        flat = list(xs) + (list(y) if isinstance(y, tuple) else [y])
        # the AMP policy's casts are part of what a capture records
        sig = (len(xs), isinstance(y, tuple),
               tuple((tuple(t.shape), t.dtype, t.device) for t in flat),
               _amp.snapshot())
        if self._health:
            sig += (_health.hook_fingerprint(self._net),)
        return sig, flat

    def _step(self, xs: tuple, y):
        """One step on tensors: ``(loss, stats)``, the loss 0-dim and not
        synchronised, the stats None with health off (on the card a
        replay's stats are the graph's outputs, valid until the next
        replay)."""
        ledger = _goodput.train()
        if xs[0].device.type != "cuda" or self._eager_only:
            with _tracing.span("trainstep.execute",
                               attrs={"step": self._num_update + 1}) as sp, \
                    ledger.timed("device_compute"):
                self._trace_id = sp.trace_id
                return backend_call("execute",
                                    lambda: self._eager_stats(xs, y))
        with ledger.timed("dispatch"):
            self._write_scalars()
            sig, flat = self._signature(xs, y)
            entry = self._graphs.get(sig)
            live = entry is not None and \
                entry.addr == _graphs.addresses(self._reads())
        if live:
            def replay():
                for s, t in zip(entry.static_in, flat):
                    s.copy_(t)
                entry.graph.replay()
            with _tracing.span("trainstep.execute",
                               attrs={"step": self._num_update + 1}) as sp, \
                    ledger.timed("device_compute"):
                self._trace_id = sp.trace_id
                backend_call("execute", replay)
                self._replays += 1
                for i in range(len(self._learnable)):
                    self._opt._update_count(i)
                self._num_update += 1
                return entry.loss.clone(), entry.stats
        if entry is None:
            self._misses += 1
        else:
            # a tensor moved: the stale graph's memory goes back to the
            # pool before the new capture takes its own
            del self._graphs[sig], entry
        dev = xs[0].device

        def compile_step():
            out = _graphs.warm(lambda: self._eager_stats(xs, y), dev)
            self._graphs[sig] = self._capture(sig, flat, dev)
            return out
        t0 = time.perf_counter()
        with _tracing.span("trainstep.compile",
                           attrs={"net": type(self._net).__name__}) as sp, \
                ledger.timed("compile"):
            self._trace_id = sp.trace_id
            out = backend_call("compile", compile_step)
        self._compile_seconds += time.perf_counter() - t0
        return out

    def _eager_stats(self, xs: tuple, y):
        """One step run eagerly: ``(loss, stats)``."""
        self._write_scalars()
        out = self._run(xs, y)
        self._num_update += 1
        return out

    def _eager(self, xs: tuple, y) -> torch.Tensor:
        """One step run eagerly, its loss: the CPU's path, a signature's
        first call on the card, and the eager twin ``chip_smoke.py``
        holds the graph against."""
        return self._eager_stats(xs, y)[0]

    def _capture(self, sig, flat, dev) -> _StepGraph:
        """The step recorded on static copies of ``flat``; the optimizer's
        counts are put back (the capture updates nothing)."""
        static_in = [t.detach().clone() for t in flat]
        n_x, y_tuple = sig[0], sig[1]
        xs = tuple(static_in[:n_x])
        y = tuple(static_in[n_x:]) if y_tuple else static_in[n_x]
        opt = self._opt
        counts = (dict(opt._index_update_count), opt.num_update)
        if self._pool is None:
            self._pool = _graphs.new_pool()
        try:
            graph, (loss, stats) = _graphs.capture(
                lambda: self._run(xs, y), dev, self._pool,
                generators_of(self._net, dev),
                f"CompiledTrainStep {type(self._net).__name__}, inputs "
                f"{[(s, str(d)) for s, d, _ in sig[2]]}")
        finally:
            opt._index_update_count, opt.num_update = counts
        self._captures += 1
        return _StepGraph(graph, static_in, loss, stats,
                          _graphs.addresses(self._reads()))

    # ------------------------------------------------------------- calls
    def _steps_in(self, xs: tuple) -> int:
        return 1

    def _steps(self, xs: tuple, y):
        return self._step(xs, y)

    def _world(self) -> List[torch.Tensor]:
        """Every tensor a step changes in place: the learnable parameters,
        the net's other tensors, the optimizer states and step tensors."""
        return (list(self._learnable) + list(self._aux)
                + [t for s in self._states for t in _leaves(s)]
                + self._opt_tensors)

    @torch.no_grad()
    def _world_copy(self) -> dict:
        """A device copy of :meth:`_world` and the step's and the
        optimizer's counts (the ``skip`` action's and
        ``FaultTolerantStep``'s snapshot)."""
        return {"tensors": [t.detach().clone() for t in self._world()],
                "num_update": self._num_update,
                "opt": (self._opt.num_update,
                        dict(self._opt._index_update_count))}

    def _restore_world(self, snap) -> None:
        """Copy a :meth:`_world_copy` back into the live tensors in place
        (no tensor moves: the graphs replay without a new capture) and
        rewind the step's and the optimizer's counts."""
        with torch.no_grad():
            for t, c in zip(self._world(), snap["tensors"]):
                t.copy_(c)
        self._num_update = snap["num_update"]
        opt = self._opt
        opt.num_update = snap["opt"][0]
        # in place: other holders may alias the dict
        opt._index_update_count.clear()
        opt._index_update_count.update(snap["opt"][1])

    def __call__(self, x, y):
        """Run one step on a batch (``x`` a tensor or a tuple of the net's
        inputs, ``y`` a tensor or a tuple); updates parameters, optimizer
        state and BN statistics in place and returns the mean loss (a
        0-dim tensor on the net's device, not synchronised).  NDArray
        inputs (a Gluon iterator's batches) run on their tensors and give
        an NDArray loss."""
        from .ndarray.ndarray import NDArray
        ledger = _goodput.train()
        with ledger.step() as info:
            with ledger.timed("dispatch"):
                (x, cx), (y, cy) = _unwrap(x), _unwrap(y)
                xs = x if isinstance(x, tuple) else (x,)
            k = self._steps_in(xs)
            info["steps"] = k
            t0 = time.perf_counter()
            compiled = self._compile_seconds
            pre = (self._hmon.snapshot_for_skip(self)
                   if self._hmon is not None else None)
            prev = self._num_update
            self._trace_id = None
            loss, stats = self._steps(xs, y)
            info["trace_id"] = self._trace_id
            if self._hmon is not None:
                verdict = self._hmon.after_call(self, stats, k, prev, xs, y,
                                                loss, pre_snap=pre)
                if verdict == "skip":
                    self._restore_world(pre)
            _M_STEPS.inc(k)
            hist = (time.perf_counter() - t0
                    - (self._compile_seconds - compiled))
            _M_STEP_SECONDS.observe(
                hist, exemplar=(None if self._trace_id is None
                                else {"trace_id": self._trace_id}))
            info["hist_seconds"] = hist
        ctx = cx or cy
        return NDArray(loss, ctx) if ctx is not None else loss


class MultiStepTrainStep(CompiledTrainStep):
    """K training steps per call, from a super-batch whose every leaf has
    a leading K axis (:func:`stack_batches`); returns the K losses (a
    tensor of K, an NDArray for NDArray inputs).  On the card the K steps
    are K replays of the one-step graph, each staging its slice and
    writing its own learning rate and step count; a shorter tail K
    replays fewer times.  The results equal K :class:`CompiledTrainStep`
    calls bit for bit.  With health armed, each step's statistics are
    copied into a K-row device buffer after it (a replay overwrites the
    graph's outputs), which the monitor reads as K rows.
    ``steps_per_call`` defaults to ``MXNET_TPU_STEPS_PER_CALL``
    (informational, as in the JAX package: K is the super-batch's)."""

    def __init__(self, net, loss_fn, optimizer, batch_size: Optional[int] = None,
                 steps_per_call: Optional[int] = None, **kwargs):
        super().__init__(net, loss_fn, optimizer, batch_size, **kwargs)
        if steps_per_call is None:
            steps_per_call = int(env.MXNET_TPU_STEPS_PER_CALL)
        self.steps_per_call = max(int(steps_per_call), 1)
        self._stats_stacked = True

    def _steps_in(self, xs: tuple) -> int:
        return int(xs[0].shape[0])

    def _steps(self, xs: tuple, y):
        k = self._steps_in(xs)

        def at(v, i):
            return tuple(a[i] for a in v) if isinstance(v, tuple) else v[i]
        losses, rows = [], None
        for i in range(k):
            loss, stats = self._step(at(xs, i), at(y, i))
            losses.append(loss)
            if stats is None:
                continue
            if rows is None:
                rows = {key: torch.empty((k,) + tuple(v.shape),
                                         dtype=v.dtype, device=v.device)
                        for key, v in stats.items() if key != "taps"}
                rows["taps"] = {n: torch.empty((k,) + tuple(v.shape),
                                               dtype=v.dtype,
                                               device=v.device)
                                for n, v in stats["taps"].items()}
            with torch.no_grad():
                for key, v in stats.items():
                    if key != "taps":
                        rows[key][i].copy_(v)
                for n, v in stats["taps"].items():
                    rows["taps"][n][i].copy_(v)
        return torch.stack(losses), rows


def stack_batches(batches: Sequence[Tuple[Any, Any]]):
    """Stack K ``(x, y)`` batches into the super-batch
    :class:`MultiStepTrainStep` takes: every leaf gains a leading K axis.
    ``x``/``y`` may each be a tuple (multi-input nets); NDArray leaves
    give NDArrays, others tensors."""
    from .ndarray.ndarray import NDArray

    def stack(items):
        if isinstance(items[0], (tuple, list)):
            return tuple(stack([it[i] for it in items])
                         for i in range(len(items[0])))
        if isinstance(items[0], NDArray):
            return NDArray(torch.stack([it._data for it in items]),
                           items[0].context)
        return torch.stack([torch.as_tensor(it) for it in items])

    return stack([b[0] for b in batches]), stack([b[1] for b in batches])


def compile_train_step(net, loss_fn, optimizer, batch_size,
                       **kwargs) -> CompiledTrainStep:
    return CompiledTrainStep(net, loss_fn, optimizer, batch_size, **kwargs)


def compile_forward(net, training: bool = False):
    """``(pure, learnable, aux)``: ``pure(learn, aux, x, key)`` is the
    forward of ``net`` over the given tensors (``torch.func.functional_call``)
    in ``learnable``'s and ``aux``'s order (the parameters with a gradient;
    the others, then the buffers), in training mode when ``training``.
    ``key`` is a ``torch.Generator`` every dropout layer draws from during
    the call (None: each layer's own, or the device's stream).  In training
    the moving statistics given in ``aux`` are updated in place."""
    from . import random as _random
    named = list(net.named_parameters())
    learn_names = [n for n, p in named if p.requires_grad]
    aux_names = ([n for n, p in named if not p.requires_grad]
                 + [n for n, _ in net.named_buffers()])
    tensors = dict(named)
    tensors.update(net.named_buffers())
    learnable = [tensors[n] for n in learn_names]
    aux = [tensors[n] for n in aux_names]

    def pure(learn, aux_arrays, x, key=None):
        xs = x if isinstance(x, tuple) else (x,)
        bound = dict(zip(learn_names, learn))
        bound.update(zip(aux_names, aux_arrays))
        layers = [m for m in net.modules() if hasattr(m, "generator")]
        held = [m.generator for m in layers]
        if training:
            gen = key if key is not None else \
                _random.device_generator(xs[0].device)
            for m in layers:
                if key is not None or m.generator is None:
                    m.generator = gen
        was_training = net.training
        net.train(training)
        try:
            return torch.func.functional_call(net, bound, xs)
        finally:
            net.train(was_training)
            for m, g in zip(layers, held):
                m.generator = g

    return pure, learnable, aux


def __getattr__(name):
    # mx.executor.Executor, as in the reference: the class lives with
    # Symbol (bind makes it)
    if name == "Executor":
        from .symbol.symbol import Executor
        return Executor
    raise AttributeError(name)
