"""Snapshot-replay fault tolerance for training (counterpart of
``mxnet_tpu/resilience/training.py``).

A step-time fault is only survivable if the pre-fault state can be
restored *exactly*: a partially applied update (the eager
``Trainer.update`` loop changes parameters one at a time; a fault between
two leaves the model half-stepped) silently corrupts training if the step
is simply re-run.  Bit-for-bit recovery also needs the random streams and
the optimizer's counts, which are captured alongside.

The JAX package's arrays are immutable, so its snapshots are references.
The port's tensors are updated in place (on the card by CUDA graphs that
read them at fixed addresses), so here a snapshot is a **device copy** of
each tensor, and a restore copies it back **in place**: no tensor moves,
and a step's graph replays after a restore with no new capture.  The
price is one copy of the step's state per call (on BERT-base, the
parameters and two Adam slots: about 1.3 GB of device memory and a
device-to-device copy per step).

* :class:`TrainerSnapshot` — a :class:`~mxnet_tpu_torch.gluon.Trainer`'s
  world: parameters, gradients, the updater's states (states created by a
  failed step are dropped), the optimizer's counts, the random streams
  (every device's, and the generator every live ``Dropout`` holds of its
  own), the kvstore's stored values and its updater's states.
* :class:`FaultTolerantStep` — wraps a
  :class:`~mxnet_tpu_torch.executor.CompiledTrainStep`: a copy before each
  call, and on a retryable fault (a transient error, or
  :class:`BackendUnavailableError` from an exhausted inner retry ladder)
  a restore and a replay; the random streams are those the step's graphs
  register (the device's, and any a module of the net holds).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .policy import BackendUnavailableError, is_transient

__all__ = ["TrainerSnapshot", "FaultTolerantStep", "step_retryable"]


def step_retryable(exc: BaseException) -> bool:
    """Replay classification: ordinary transient errors plus an exhausted
    inner retry ladder (BackendUnavailableError) — the outer replay runs on
    a longer clock than the inner attempts did."""
    return is_transient(exc) or isinstance(exc, BackendUnavailableError)


def _clone(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone()


def _snap_state(state):
    """An optimizer state (None, a tensor, a tuple of them) as device
    copies of the same structure."""
    if state is None:
        return None
    if isinstance(state, torch.Tensor):
        return _clone(state)
    return tuple(_snap_state(s) for s in state)


@torch.no_grad()
def _restore_state(state, snap) -> None:
    if state is None:
        return
    if isinstance(state, torch.Tensor):
        state.copy_(snap)
        return
    for s, r in zip(state, snap):
        _restore_state(s, r)


def _snap_rng(gens: Sequence[torch.Generator]) -> List[Tuple]:
    return [(g, g.get_state()) for g in gens]


def _restore_rng(snap) -> None:
    for g, state in snap:
        g.set_state(state)


def _snap_optimizer(opt) -> Tuple:
    return (opt.num_update, dict(opt._index_update_count))


def _restore_optimizer(opt, snap) -> None:
    opt.num_update = snap[0]
    # in place: other holders may alias the dict
    opt._index_update_count.clear()
    opt._index_update_count.update(snap[1])


def _snap_updater(updater) -> Tuple:
    return (updater, dict(updater.states),
            {k: _snap_state(v) for k, v in updater.states.items()})


def _restore_updater(snap) -> None:
    updater, templates, states = snap
    updater.states = dict(templates)
    updater.states_synced = {k: v for k, v in updater.states_synced.items()
                             if k in templates}
    for k, st in updater.states.items():
        _restore_state(st, states[k])


class TrainerSnapshot:
    """Device-copy snapshot of a Trainer's mutable training state; see the
    module docstring.  ``restore()`` rewinds all of it in place; a
    replayed batch then reproduces the fault-free trajectory bit for
    bit."""

    def __init__(self, trainer, include_rng: bool = True):
        from .. import random as _random
        self._trainer = trainer
        self._params: List[Tuple] = []
        for p in trainer._params:
            if not p._allocated():
                continue
            g = p._grad
            grad_snap = (_clone(g._data) if g is not None
                         and g._data.numel() else None)
            self._params.append((p, _clone(p.data()._data), grad_snap))
        self._updater = _snap_updater(trainer._updaters[0])
        self._opt_counters = _snap_optimizer(trainer._optimizer)
        self._rng = (_snap_rng(_random._all_streams())
                     if include_rng else None)
        # the store's replicas (update_on_kvstore pulls FROM the store, so a
        # half-applied store update must rewind too); the objects are kept,
        # since a failed push may have replaced a store entry
        kv = trainer._kvstore
        self._kv_store_vals = ({k: (v, _clone(v._data))
                                for k, v in kv._store.items()}
                               if kv is not None else None)
        self._kv_updater = None
        if kv is not None and kv._updater is not None \
                and kv._updater is not trainer._updaters[0]:
            self._kv_updater = _snap_updater(kv._updater)

    @torch.no_grad()
    def restore(self) -> None:
        from .. import resilience
        for p, data_snap, grad_snap in self._params:
            p.data()._data.copy_(data_snap)
            g = p._grad
            if grad_snap is not None and g is not None:
                if g._data.shape == grad_snap.shape:
                    g._data.copy_(grad_snap)
                else:
                    g._data = grad_snap.clone()
        _restore_updater(self._updater)
        _restore_optimizer(self._trainer._optimizer, self._opt_counters)
        if self._rng is not None:
            _restore_rng(self._rng)
        kv = self._trainer._kvstore
        if kv is not None and self._kv_store_vals is not None:
            kv._store.clear()
            for sk, (obj, snap) in self._kv_store_vals.items():
                if obj._data.shape == snap.shape:
                    obj._data.copy_(snap)
                else:
                    obj._data = snap.clone()
                kv._store[sk] = obj
        if self._kv_updater is not None:
            _restore_updater(self._kv_updater)
        resilience.counters.replays += 1


class FaultTolerantStep:
    """``resume_on_fault`` for the compiled path: wraps a
    :class:`~mxnet_tpu_torch.executor.CompiledTrainStep`; every call copies
    the step's state (parameters, the net's other tensors, optimizer
    states, the step's and the optimizer's counts, the random streams its
    graphs register), and a retryable step-time fault restores the copy in
    place and replays — recovering to the pre-fault step with bit-for-bit
    identical parameters and no new capture.

    ``max_replays`` bounds outer recovery attempts *per step*, on top of
    the inner :func:`~mxnet_tpu_torch.resilience.backend_call` retry
    ladder."""

    def __init__(self, step, max_replays: int = 2,
                 retryable: Callable[[BaseException], bool] = step_retryable):
        self._step = step
        self._max_replays = max(0, int(max_replays))
        self._retryable = retryable

    def _generators(self) -> List[torch.Generator]:
        from ..cached_op import generators_of
        s = self._step
        return generators_of(s._net, s._learnable[0].device)

    def _capture(self) -> Dict:
        snap = self._step._world_copy()
        snap["rng"] = _snap_rng(self._generators())
        return snap

    def _restore(self, snap) -> None:
        from .. import resilience
        self._step._restore_world(snap)
        _restore_rng(snap["rng"])
        resilience.counters.replays += 1

    def __call__(self, x, y):
        snap = self._capture()
        last: Optional[BaseException] = None
        for attempt in range(self._max_replays + 1):
            try:
                return self._step(x, y)
            except Exception as e:  # noqa: BLE001 - the classifier decides
                if not self._retryable(e) or attempt == self._max_replays:
                    raise
                last = e
                self._restore(snap)
        raise last  # pragma: no cover

    def __getattr__(self, name):
        return getattr(self._step, name)
