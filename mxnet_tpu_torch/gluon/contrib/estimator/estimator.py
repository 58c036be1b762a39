"""``Estimator``: the batteries-included ``fit()`` loop (counterpart of
``mxnet_tpu/gluon/contrib/estimator/estimator.py``).

Two drivers run an epoch.  The eager loop is the Gluon triple per batch:
``autograd.record()`` over the net and the loss, ``backward()``,
``trainer.step(batch_size)``.  The fused driver runs the net, the loss's
mean, its gradients and every update as one
:class:`~mxnet_tpu_torch.executor.MultiStepTrainStep` call per group of K
batches (``steps_per_call=K``, 1 included); on the card it is a CUDA
graph replayed per step.  As in the JAX package the fused step shares the
Trainer's ``Optimizer`` (its learning rate and schedule) but keeps its
own optimizer states (momentum, Adam's moments), which start at zero when
the step is built and live in the step, not in the Trainer's updater.

``fit`` bounds the run by ``epochs`` or ``batches``, calls the event
handlers (a ``StoppingHandler``, a ``MetricHandler``, a
``ValidationHandler`` when there is ``val_data`` and a ``LoggingHandler``
are added when absent), and records the run's goodput window
(``goodput.train().window('fit')``) in ``last_goodput``.  Options:
``resume_on_fault`` (replay a step after a retryable fault: the eager
loop restores ``trainer.snapshot()``, the fused driver runs under
:class:`~mxnet_tpu_torch.resilience.training.FaultTolerantStep`),
``prefetch_to_device`` (a
:class:`~mxnet_tpu_torch.io.DevicePrefetchIter` onto the Estimator's
``context``, the card by default), ``health`` (in-graph watchpoints on
the fused driver, a :class:`.event_handler.TrainingHealthHandler` on the
eager loop), ``elastic`` (True, a dict or an
:class:`~mxnet_tpu_torch.resilience.ElasticConfig`: the fused driver,
forced even at K = 1, runs under
:class:`~mxnet_tpu_torch.resilience.ElasticTrainStep`, so a rank loss
reforms the ``dp`` mesh on the survivors and the fit goes on; a
``DevicePrefetchIter`` input follows the reformed mesh through
``on_reform``).  The fused driver takes a mesh, resolved once per fit:
the ``DevicePrefetchIter``'s, else the one entered, else with
``elastic`` every visible device on ``dp``; the mesh keys the cache of
fused steps, so a multi-epoch fit reuses its driver.

Deliberate difference from the JAX package: the fused driver runs
whenever ``steps_per_call`` is given, 1 included, or
``MXNET_TPU_STEPS_PER_CALL`` is above 1 (the JAX package runs it for K > 1
only; its K = 1 compiled step is the eager loop's compile).
"""
from __future__ import annotations

import logging
from typing import List, Optional

from .... import autograd
from .... import metric as metric_mod
from ....base import env
from ...loss import Loss
from ...trainer import Trainer
from .event_handler import (BatchBegin, BatchEnd, EpochBegin, EpochEnd,
                            LoggingHandler, MetricHandler, StoppingHandler,
                            TrainBegin, TrainEnd, TrainingHealthHandler,
                            ValidationHandler)

__all__ = ["Estimator"]


def _leaf(pair):
    """The first array of a ``(data, label)`` pair."""
    v = pair[0]
    while isinstance(v, (tuple, list)):
        v = v[0]
    return v


class Estimator:
    """Trains ``net`` on ``loss`` with ``trainer`` (default Adam, lr
    1e-3), updating ``train_metrics`` and evaluating ``val_metrics`` and
    ``val_loss`` (default ``loss``).  The parameters not yet initialized
    are initialized with ``initializer`` on ``context`` (the current
    context when None)."""

    def __init__(self, net, loss: Loss, train_metrics=None, val_metrics=None,
                 initializer=None, trainer: Optional[Trainer] = None,
                 context=None, val_loss: Optional[Loss] = None):
        self.net = net
        self.loss = loss
        self.val_loss = val_loss or loss
        self.train_metrics = self._as_metrics(train_metrics)
        self.val_metrics = self._as_metrics(val_metrics)
        self.context = context
        self.logger = logging.getLogger("mxnet_tpu_torch.estimator")
        params = net.collect_params()
        params.initialize(initializer, ctx=context, force_reinit=False)
        self.trainer = trainer or Trainer(params, "adam",
                                          {"learning_rate": 1e-3})
        self.train_loss_metric = metric_mod.Loss(name="loss")
        self.val_loss_metric = metric_mod.Loss(name="validation loss")
        self._fused_steps = {}
        self._fused_ft = None
        self._health_cfg = None
        self.last_goodput = None

    @staticmethod
    def _as_metrics(m) -> List:
        if m is None:
            return []
        return list(m) if isinstance(m, (list, tuple)) else [m]

    # ------------------------------------------------------------- batches
    def _batch_fn(self, batch):
        """``(data, label)`` of a batch: a pair, or a ``DataBatch`` (its
        first data and label arrays, less the ``pad`` rows a wrapped
        epoch tail repeats)."""
        if hasattr(batch, "data") and hasattr(batch, "label"):
            def aslist(v):
                return list(v) if isinstance(v, (list, tuple)) else [v]
            labels = aslist(batch.label) if batch.label is not None else []
            if not labels:
                raise ValueError(
                    "Estimator needs (data, label) pairs; got a DataBatch "
                    "without labels. Use a gluon DataLoader or an iterator "
                    "with label arrays.")
            data, label = aslist(batch.data)[0], labels[0]
            pad = int(getattr(batch, "pad", 0) or 0)
            if pad:
                data = data[:data.shape[0] - pad]
                label = label[:label.shape[0] - pad]
            return data, label
        return batch[0], batch[1]

    @staticmethod
    def _fresh_epoch(data):
        """A ``DataIter`` is single-pass: rewind it before each epoch."""
        if hasattr(data, "reset"):
            data.reset()

    def evaluate(self, val_data):
        """The validation metrics and loss over ``val_data``, reset first."""
        for m in self.val_metrics:
            m.reset()
        self.val_loss_metric.reset()
        self._fresh_epoch(val_data)
        for batch in val_data:
            data, label = self._batch_fn(batch)
            pred = self.net(data)
            self.val_loss_metric.update(None, self.val_loss(pred, label))
            for m in self.val_metrics:
                m.update(label, pred)

    # ---------------------------------------------------------- eager loop
    def _run_batch(self, data, label, batch_size, resume_on_fault: int):
        """Forward, backward and ``trainer.step``; with
        ``resume_on_fault``, a retryable fault in the step restores the
        trainer's snapshot, taken after the backward, and replays the
        step (the forward and backward change no state)."""
        with autograd.record():
            pred = self.net(data)
            loss = self.loss(pred, label)
        loss.backward()
        if not resume_on_fault:
            self.trainer.step(batch_size)
            return pred, loss
        from ....resilience.training import step_retryable
        if not self.trainer._kv_initialized:
            self.trainer._init_kvstore()
        snap = self.trainer.snapshot()
        for attempt in range(resume_on_fault + 1):
            try:
                self.trainer.step(batch_size)
                return pred, loss
            except Exception as e:  # noqa: BLE001 - the classifier decides
                if attempt == resume_on_fault or not step_retryable(e):
                    raise
                self.logger.warning(
                    "transient fault during training step (%s); restoring "
                    "pre-step snapshot and replaying (attempt %d/%d)",
                    e, attempt + 1, resume_on_fault)
                snap.restore()

    # -------------------------------------------------------- fused driver
    def _fused_step(self, steps_per_call: int, mesh=None, elastic_cfg=None):
        """The step of the fused driver for K = ``steps_per_call``, built
        once per K, mesh, elastic mode and health setting (watchpoints
        change the graph); a cached step takes the fit's other health knobs
        in place, keeping its optimizer states.  With ``elastic_cfg`` it is
        an :class:`~mxnet_tpu_torch.resilience.ElasticTrainStep` whose
        ``build(mesh)`` makes the step for each world."""
        health_cfg = self._health_cfg
        armed = (health_cfg.watchpoints if health_cfg is not None
                 else bool(env.MXNET_TPU_HEALTH))
        key = (steps_per_call, armed)
        if mesh is not None:
            key += (id(mesh),)
        if elastic_cfg is not None:
            key += ("elastic",)
        step = self._fused_steps.get(key)
        if step is not None:
            if step._hmon is not None:
                from ....observability.health import HealthConfig
                step._hmon.reconfigure(health_cfg if health_cfg is not None
                                       else HealthConfig())
            return step
        if self._fused_steps:
            self.logger.warning(
                "building a second fused train step (steps_per_call=%d) "
                "for this Estimator: its optimizer states start from zero "
                "on the current parameters", steps_per_call)
        from ....executor import MultiStepTrainStep

        def build(m):
            return MultiStepTrainStep(self.net, self.loss,
                                      self.trainer.optimizer,
                                      steps_per_call=steps_per_call, mesh=m,
                                      health=health_cfg)
        if elastic_cfg is not None:
            from ....resilience import ElasticTrainStep
            step = ElasticTrainStep(build, mesh=mesh, config=elastic_cfg)
        else:
            step = build(mesh)
        self._fused_steps[key] = step
        return step

    def _run_fused_group(self, group, steps_per_call, resume_on_fault,
                         mesh=None, elastic_cfg=None, train_data=None):
        """One fused call over the ``(data, label)`` pairs of ``group``;
        the per-step losses (an array of ``len(group)``)."""
        if any(not p._allocated() for p in
               self.net.collect_params().values()):
            # the step takes the net's tensors: let a forward allocate
            # the deferred ones first
            self.net(group[0][0])
        step = self._fused_step(steps_per_call, mesh, elastic_cfg)
        if elastic_cfg is not None:
            from ....io import DevicePrefetchIter
            # a reformed mesh retargets the input pipeline too
            step.on_reform = ([train_data.reshard]
                              if isinstance(train_data, DevicePrefetchIter)
                              else [])
        if resume_on_fault:
            ft = self._fused_ft
            if ft is None or ft._step is not step or \
                    ft._max_replays != resume_on_fault:
                from ....resilience.training import FaultTolerantStep
                ft = self._fused_ft = FaultTolerantStep(
                    step, max_replays=resume_on_fault)
            step = ft
        from ....executor import stack_batches
        return step(*stack_batches(group))

    def _epoch_fused(self, train_data, phase, stopping, steps_per_call,
                     resume_on_fault, mesh=None, elastic_cfg=None):
        """One epoch of the fused driver: K batches a group, ``batch_end``
        once per group with its losses; a batch whose shape differs from
        the open group's (an epoch's short tail) closes the group first,
        and no group runs past a ``batches`` budget."""
        def flush(group, batch):
            losses = self._run_fused_group(group, steps_per_call,
                                           resume_on_fault, mesh,
                                           elastic_cfg, train_data)
            samples = sum(int(_leaf(p).shape[0]) for p in group)
            phase(BatchEnd, "batch_end", batch=batch, pred=None, label=None,
                  loss=losses, num_batches=len(group), num_samples=samples)

        def group_cap():
            if stopping.max_batch is None:
                return steps_per_call
            return min(steps_per_call,
                       max(stopping.max_batch - stopping.current_batch, 1))

        group, raw = [], []
        for batch in train_data:
            phase(BatchBegin, "batch_begin", batch=batch)
            pair = self._batch_fn(batch)
            if group and _leaf(pair).shape != _leaf(group[0]).shape:
                flush(group, raw[-1])
                group, raw = [], []
                if stopping.stop_training:
                    return
            group.append(pair)
            raw.append(batch)
            if len(group) >= group_cap():
                flush(group, raw[-1])
                group, raw = [], []
            if stopping.stop_training:
                return
        if group:
            flush(group, raw[-1])

    # ----------------------------------------------------------------- fit
    def fit(self, train_data, val_data=None, epochs: Optional[int] = None,
            event_handlers=None, batches: Optional[int] = None,
            resume_on_fault: int = 0, prefetch_to_device: bool = False,
            steps_per_call: Optional[int] = None, elastic=None,
            health=None):
        """Train for ``epochs`` (default 1) or ``batches``; see the module
        docstring for the drivers and the options.  Returns the
        Estimator."""
        elastic_cfg = None
        if elastic:
            from ....resilience import ElasticConfig
            elastic_cfg = ElasticConfig.coerce(elastic)
        resume_on_fault = 2 if resume_on_fault is True \
            else int(resume_on_fault)
        fused = steps_per_call is not None or elastic_cfg is not None or \
            int(env.MXNET_TPU_STEPS_PER_CALL) > 1
        if steps_per_call is None:
            steps_per_call = int(env.MXNET_TPU_STEPS_PER_CALL)
        steps_per_call = max(int(steps_per_call), 1)
        self._health_cfg = None
        if health:
            from ....observability.health import HealthConfig
            self._health_cfg = HealthConfig.coerce(health)
            # the fused driver's watchpoints watch the loss; the handler
            # serves the eager loop (never both: one response per anomaly)
            if not (fused and self._health_cfg.watchpoints):
                event_handlers = list(event_handlers or []) + [
                    TrainingHealthHandler(self._health_cfg)]
        own_prefetch = None
        if prefetch_to_device:
            from ....io import DevicePrefetchIter
            if not isinstance(train_data, DevicePrefetchIter):
                train_data = own_prefetch = DevicePrefetchIter(
                    train_data, ctx=self.context)
        try:
            from ....observability import goodput as _goodput
            with _goodput.train().window("fit") as report:
                out = self._fit_loop(train_data, val_data, epochs, batches,
                                     event_handlers, resume_on_fault,
                                     steps_per_call if fused else None,
                                     elastic_cfg)
            self.last_goodput = report
            return out
        finally:
            if own_prefetch is not None:
                own_prefetch.close()

    def _fit_loop(self, train_data, val_data, epochs, batches,
                  event_handlers, resume_on_fault, steps_per_call,
                  elastic_cfg=None):
        """The epochs; ``steps_per_call`` None runs the eager loop."""
        if epochs is None and batches is None:
            epochs = 1
        handlers = list(event_handlers or [])
        stopping = next((h for h in handlers
                         if isinstance(h, StoppingHandler)), None)
        if stopping is None:
            stopping = StoppingHandler(max_epoch=epochs, max_batch=batches)
            handlers.append(stopping)
        if not any(isinstance(h, MetricHandler) for h in handlers):
            handlers.append(MetricHandler(
                [self.train_loss_metric] + self.train_metrics))
        if val_data is not None and not any(
                isinstance(h, ValidationHandler) for h in handlers):
            handlers.append(ValidationHandler(val_data, self.evaluate))
        if not any(isinstance(h, LoggingHandler) for h in handlers):
            handlers.append(LoggingHandler(
                metrics=[self.train_loss_metric] + self.train_metrics))

        def phase(cls, method, *args, **kw):
            for h in handlers:
                if isinstance(h, cls):
                    getattr(h, method)(self, *args, **kw)

        fused_mesh = None
        if steps_per_call is not None:
            # resolved once per fit: the mesh keys the fused-step cache,
            # and a new mesh each epoch would restart the optimizer states
            from ....io import DevicePrefetchIter
            if isinstance(train_data, DevicePrefetchIter):
                fused_mesh = train_data.mesh
            if fused_mesh is None:
                from ....parallel import current_mesh
                fused_mesh = current_mesh()
            if fused_mesh is None and elastic_cfg is not None:
                # reformation is a dp-axis operation: elastic mode always
                # runs on a mesh (every visible device on dp by default)
                from ....parallel import make_mesh
                fused_mesh = make_mesh()

        phase(TrainBegin, "train_begin")
        while not stopping.stop_training:
            phase(EpochBegin, "epoch_begin")
            self._fresh_epoch(train_data)
            if steps_per_call is not None:
                self._epoch_fused(train_data, phase, stopping,
                                  steps_per_call, resume_on_fault,
                                  fused_mesh, elastic_cfg)
            else:
                for batch in train_data:
                    phase(BatchBegin, "batch_begin", batch=batch)
                    data, label = self._batch_fn(batch)
                    pred, loss = self._run_batch(data, label, len(data),
                                                 resume_on_fault)
                    phase(BatchEnd, "batch_end", batch=batch, pred=pred,
                          label=label, loss=loss)
                    if stopping.stop_training:
                        break
            phase(EpochEnd, "epoch_end")
        phase(TrainEnd, "train_end")
        return self
