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
already averages) and Adam computes its step size once per lr multiplier
(``_step_sizes``); all are restored after.  The host writes the
tensors before each step: ``lr_scheduler(count + 1)`` (or ``lr``), indexed
by the step's own 1-based count as the JAX ``_lr_at`` is, and that count
for Adam's bias correction.  BN moving statistics are written in place by
the forward.

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

Deliberate differences from the JAX package: the optimizer's per-index
counts and ``num_update`` advance once per step (MXNet's count; the JAX
step counts once per trace); ``donate`` has no effect (the graph updates
in place already); a signature's first call is eager; the returned loss
is a clone.  ``mesh``, ``param_spec_fn`` and ``shard_optimizer_state``
raise :class:`MXNetError` (ROADMAP A11), as does ``health`` (A12).
"""
from __future__ import annotations

import contextlib
from typing import Any, List, Optional, Sequence, Tuple

import torch

from . import _graphs
from .base import MXNetError, env
from .cached_op import generators_of

__all__ = ["CompiledTrainStep", "MultiStepTrainStep", "compile_train_step",
           "compile_forward", "stack_batches"]


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
    """One signature's captured step."""

    __slots__ = ("graph", "static_in", "loss", "addr")

    def __init__(self, graph, static_in, loss, addr):
        self.graph, self.static_in = graph, static_in
        self.loss, self.addr = loss, addr


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
    changes no value.  ``mesh``, ``param_spec_fn``,
    ``shard_optimizer_state`` and ``health`` are not ported."""

    def __init__(self, net, loss_fn, optimizer, batch_size: Optional[int] = None,
                 mesh=None, data_axis: str = "dp", param_spec_fn=None,
                 donate: bool = True, remat: bool = False,
                 fuse_grad_buckets: Optional[bool] = None,
                 shard_optimizer_state: Optional[bool] = None, health=None):
        if mesh is not None or param_spec_fn is not None or \
                shard_optimizer_state:
            raise MXNetError(
                "CompiledTrainStep: mesh, param_spec_fn and "
                "shard_optimizer_state are not ported yet (ROADMAP A11)")
        if health not in (None, False):
            raise MXNetError("CompiledTrainStep: health watchpoints are not "
                             "ported yet (ROADMAP A12)")
        self._net = net
        self._loss_fn = loss_fn
        self._opt = optimizer
        self.batch_size = batch_size
        self._remat = remat
        self._learnable = [p for p in net.parameters() if p.requires_grad]
        self._states = [optimizer.create_state_multi_precision(i, p)
                        for i, p in enumerate(self._learnable)]
        self._grad_buckets: Optional[List[List[int]]] = None
        cap = max(int(env.MXNET_KVSTORE_BUCKET_KB), 0) * 1024
        if fuse_grad_buckets and cap > 0 and len(self._learnable) > 1:
            from .kvstore.bucketing import partition_bucket_indices
            self._grad_buckets = partition_bucket_indices(
                [p.numel() * p.element_size() for p in self._learnable],
                [str(p.dtype) for p in self._learnable], cap)
        self.grad_bucket_count = (len(self._grad_buckets)
                                  if self._grad_buckets
                                  else len(self._learnable))
        self._num_update = 0
        # lr and the 1-based step count, 0-dim fp32 on the parameters'
        # device: what the optimizer reads inside a step
        self._scalars: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._graphs = {}
        self._pool = None
        self._misses = self._captures = self._replays = 0

    # ------------------------------------------------------------ scalars
    def _lr_at(self, i: int) -> float:
        # the schedule is indexed by the step being taken, 1-based: eager
        # _update_count advances num_update before _get_lr reads it
        opt = self._opt
        if getattr(opt, "lr_scheduler", None) is not None:
            return float(opt.lr_scheduler(self._num_update + 1 + i))
        return float(opt.lr)

    def _write_scalars(self) -> None:
        """This step's lr and count into the scalars (made on the
        parameters' device at the first step)."""
        if self._scalars is None:
            device = self._learnable[0].device
            self._scalars = (
                torch.zeros((), dtype=torch.float32, device=device),
                torch.zeros((), dtype=torch.float32, device=device))
        lr, t = self._scalars
        lr.fill_(self._lr_at(0))
        t.fill_(self._num_update + 1)

    # -------------------------------------------------------------- step
    def _loss(self, xs, y):
        def fwd(*a):
            return self._loss_fn(self._net(*a), y).mean()
        if not self._remat:
            return fwd(*xs)
        from torch.utils.checkpoint import checkpoint
        gens = generators_of(self._net, xs[0].device)
        buffers = list(self._net.buffers())
        return checkpoint(fwd, *xs, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=lambda: _remat_contexts(gens, buffers))

    def _run(self, xs, y) -> torch.Tensor:
        """Forward, gradients and every update, the optimizer reading the
        scalars; returns the detached mean loss.  What the graph records."""
        net, opt = self._net, self._opt
        was_training = net.training
        net.train()
        try:
            loss = self._loss(xs, y)
            grads = torch.autograd.grad(loss, self._learnable,
                                        allow_unused=True)
        finally:
            net.train(was_training)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self._learnable, grads)]
        if self._grad_buckets is not None:
            grads = _fuse_grad_buckets(grads, self._grad_buckets)
        lr, t = self._scalars
        names = ("lr", "lr_scheduler", "rescale_grad", "_step", "_step_sizes")
        saved = [getattr(opt, n, None) for n in names]
        for n, v in zip(names, (lr, None, 1.0, t, {})):
            setattr(opt, n, v)
        try:
            for i, (p, g, state) in enumerate(zip(self._learnable, grads,
                                                  self._states)):
                opt.update_multi_precision(i, p.data, g, state)
        finally:
            for n, v in zip(names, saved):
                setattr(opt, n, v)
        return loss.detach()

    def _reads(self) -> List[torch.Tensor]:
        """The tensors a graph reads or writes in place."""
        return (list(self._net.parameters()) + list(self._net.buffers())
                + [t for s in self._states for t in _leaves(s)]
                + list(self._scalars))

    def _step(self, xs: tuple, y) -> torch.Tensor:
        """One step on tensors; the loss (0-dim, not synchronised)."""
        if xs[0].device.type != "cuda":
            return self._eager(xs, y)
        self._write_scalars()
        flat = list(xs) + (list(y) if isinstance(y, tuple) else [y])
        sig = (len(xs), isinstance(y, tuple),
               tuple((tuple(t.shape), t.dtype, t.device) for t in flat))
        entry = self._graphs.get(sig)
        if entry is not None and entry.addr == _graphs.addresses(self._reads()):
            for s, t in zip(entry.static_in, flat):
                s.copy_(t)
            entry.graph.replay()
            self._replays += 1
            for i in range(len(self._learnable)):
                self._opt._update_count(i)
            self._num_update += 1
            return entry.loss.clone()
        if entry is None:
            self._misses += 1
        else:
            # a tensor moved: the stale graph's memory goes back to the
            # pool before the new capture takes its own
            del self._graphs[sig], entry
        dev = xs[0].device
        loss = _graphs.warm(lambda: self._eager(xs, y), dev)
        self._graphs[sig] = self._capture(sig, flat, dev)
        return loss

    def _eager(self, xs: tuple, y) -> torch.Tensor:
        """One step run eagerly: the CPU's path, a signature's first call
        on the card, and the eager twin ``chip_smoke.py`` holds the graph
        against."""
        self._write_scalars()
        loss = self._run(xs, y)
        self._num_update += 1
        return loss

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
            graph, loss = _graphs.capture(
                lambda: self._run(xs, y), dev, self._pool,
                generators_of(self._net, dev),
                f"CompiledTrainStep {type(self._net).__name__}, inputs "
                f"{[(s, str(d)) for s, d, _ in sig[2]]}")
        finally:
            opt._index_update_count, opt.num_update = counts
        self._captures += 1
        return _StepGraph(graph, static_in, loss,
                          _graphs.addresses(self._reads()))

    def __call__(self, x, y):
        """Run one step on a batch (``x`` a tensor or a tuple of the net's
        inputs, ``y`` a tensor or a tuple); updates parameters, optimizer
        state and BN statistics in place and returns the mean loss (a
        0-dim tensor on the net's device, not synchronised).  NDArray
        inputs (a Gluon iterator's batches) run on their tensors and give
        an NDArray loss."""
        from .ndarray.ndarray import NDArray
        (x, cx), (y, cy) = _unwrap(x), _unwrap(y)
        loss = self._step(x if isinstance(x, tuple) else (x,), y)
        ctx = cx or cy
        return NDArray(loss, ctx) if ctx is not None else loss


class MultiStepTrainStep(CompiledTrainStep):
    """K training steps per call, from a super-batch whose every leaf has
    a leading K axis (:func:`stack_batches`); returns the K losses (a
    tensor of K, an NDArray for NDArray inputs).  On the card the K steps
    are K replays of the one-step graph, each staging its slice and
    writing its own learning rate and step count; a shorter tail K
    replays fewer times.  The results equal K :class:`CompiledTrainStep`
    calls bit for bit.  ``steps_per_call`` defaults to
    ``MXNET_TPU_STEPS_PER_CALL`` (informational, as in the JAX package:
    K is the super-batch's)."""

    def __init__(self, net, loss_fn, optimizer, batch_size: Optional[int] = None,
                 steps_per_call: Optional[int] = None, **kwargs):
        super().__init__(net, loss_fn, optimizer, batch_size, **kwargs)
        if steps_per_call is None:
            steps_per_call = int(env.MXNET_TPU_STEPS_PER_CALL)
        self.steps_per_call = max(int(steps_per_call), 1)

    def __call__(self, x, y):
        from .ndarray.ndarray import NDArray
        (x, cx), (y, cy) = _unwrap(x), _unwrap(y)
        xs = x if isinstance(x, tuple) else (x,)
        k = int(xs[0].shape[0])

        def at(v, i):
            return tuple(a[i] for a in v) if isinstance(v, tuple) else v[i]
        losses = torch.stack([self._step(at(xs, i), at(y, i))
                              for i in range(k)])
        ctx = cx or cy
        return NDArray(losses, ctx) if ctx is not None else losses


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
