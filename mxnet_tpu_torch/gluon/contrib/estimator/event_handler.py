"""The Estimator's event handlers (counterpart of
``mxnet_tpu/gluon/contrib/estimator/event_handler.py``).

A handler subclasses the phase markers it cares about (``TrainBegin``,
``EpochEnd``, ``BatchEnd``...); the Estimator calls every handler at each
phase.  The fused driver fires ``batch_end`` once per group of
``num_batches`` batches (``num_samples`` samples), with the group's loss
vector and no predictions; the counting handlers count batches, not
events.  Handlers run on the host between steps: they read only what the
step already returned (the loss), so that they sync the card at most once
per event.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np

__all__ = ["EventHandler", "GradientUpdateHandler", "TrainBegin", "TrainEnd",
           "EpochBegin", "EpochEnd", "BatchBegin", "BatchEnd",
           "StoppingHandler", "MetricHandler", "ValidationHandler",
           "LoggingHandler", "CheckpointHandler", "EarlyStoppingHandler",
           "TrainingHealthHandler"]

_LOG = "mxnet_tpu_torch.estimator"


class EventHandler:
    pass


class TrainBegin(EventHandler):
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd(EventHandler):
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin(EventHandler):
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd(EventHandler):
    def epoch_end(self, estimator, *args, **kwargs):
        pass


class BatchBegin(EventHandler):
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd(EventHandler):
    def batch_end(self, estimator, *args, **kwargs):
        pass


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stop after ``max_epoch`` epochs or ``max_batch`` batches."""

    def __init__(self, max_epoch: Optional[int] = None,
                 max_batch: Optional[int] = None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch
        self.current_batch = 0
        self.current_epoch = 0
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += int(kwargs.get("num_batches", 1))
        if self.max_batch is not None and \
                self.current_batch >= self.max_batch:
            self.stop_training = True

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.max_epoch is not None and \
                self.current_epoch >= self.max_epoch:
            self.stop_training = True


class MetricHandler(EpochBegin, BatchEnd):
    """Reset the metrics at each epoch's start and update them after each
    batch: a metric named ``loss`` from the loss, the others from the
    predictions and labels."""

    def __init__(self, metrics):
        self.metrics = list(metrics)

    def epoch_begin(self, estimator, *args, **kwargs):
        for m in self.metrics:
            m.reset()

    def batch_end(self, estimator, *args, pred=None, label=None, loss=None,
                  **kwargs):
        for m in self.metrics:
            if getattr(m, "name", "") == "loss" and loss is not None:
                m.update(None, loss)
            elif pred is not None and label is not None:
                m.update(label, pred)


class ValidationHandler(TrainBegin, BatchEnd, EpochEnd):
    """Run ``eval_fn(val_data)`` every ``epoch_period`` epochs and, with
    ``batch_period``, whenever a batch event crosses a multiple of it."""

    def __init__(self, val_data, eval_fn, epoch_period: int = 1,
                 batch_period: Optional[int] = None):
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.current_batch = 0
        self.current_epoch = 0

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        before = self.current_batch
        self.current_batch += int(kwargs.get("num_batches", 1))
        if self.batch_period and (self.current_batch // self.batch_period
                                  > before // self.batch_period):
            self.eval_fn(self.val_data)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            self.eval_fn(self.val_data)


def _metric_text(metrics):
    out = []
    for m in metrics:
        name, val = m.get()
        out.append(f"{name}={val:.6f}" if isinstance(val, float)
                   else f"{name}={val}")
    return out


class LoggingHandler(TrainBegin, TrainEnd, EpochBegin, EpochEnd, BatchBegin,
                     BatchEnd):
    """Log samples per second and the metrics every ``log_interval``
    batches and at each epoch's end."""

    def __init__(self, log_interval: int = 50, metrics=None,
                 logger: Optional[logging.Logger] = None):
        self.log_interval = log_interval
        self.metrics = list(metrics or [])
        self.logger = logger or logging.getLogger(_LOG)
        self.batch_index = 0
        self.current_epoch = 0
        self._epoch_start = 0.0
        self._interval_start = 0.0
        self._interval_samples = 0

    def train_begin(self, estimator, *args, **kwargs):
        self.logger.info("Training begin")

    def train_end(self, estimator, *args, **kwargs):
        self.logger.info("Training end")

    def epoch_begin(self, estimator, *args, **kwargs):
        self._epoch_start = self._interval_start = time.time()
        self._interval_samples = 0
        self.batch_index = 0

    def batch_end(self, estimator, *args, batch=None, **kwargs):
        before = self.batch_index
        self.batch_index += int(kwargs.get("num_batches", 1))
        num_samples = kwargs.get("num_samples")
        if num_samples is None and batch is not None:
            num_samples = _batch_len(batch)
        self._interval_samples += int(num_samples or 0)
        if self.log_interval and (self.batch_index // self.log_interval
                                  > before // self.log_interval):
            dt = max(time.time() - self._interval_start, 1e-9)
            self.logger.info(" ".join(
                [f"epoch[{self.current_epoch}] batch[{self.batch_index}]",
                 f"{self._interval_samples / dt:.1f} samples/sec"]
                + _metric_text(self.metrics)))
            self._interval_start = time.time()
            self._interval_samples = 0

    def epoch_end(self, estimator, *args, **kwargs):
        dt = time.time() - self._epoch_start
        self.logger.info(" ".join(
            [f"epoch[{self.current_epoch}] done in {dt:.2f}s"]
            + _metric_text(self.metrics)))
        self.current_epoch += 1


def _batch_len(batch) -> int:
    """The samples of a ``(data, label)`` batch or a ``DataBatch``."""
    data = getattr(batch, "data", None)
    if data is None:
        data = batch[0]
    if isinstance(data, (list, tuple)):
        data = data[0]
    return int(data.shape[0]) if hasattr(data, "shape") else 0


def _mode(mode, monitor):
    """``'max'`` for an accuracy or F1 monitor under ``'auto'``, else
    ``'min'``."""
    if mode != "auto":
        return mode
    name = monitor.get()[0] if hasattr(monitor, "get") else str(monitor)
    return "max" if ("acc" in name or "f1" in name) else "min"


class CheckpointHandler(TrainBegin, BatchEnd, EpochEnd):
    """Save ``{model_prefix}-epoch{N}.params`` (``save_parameters``) and
    the trainer's ``.states`` every ``epoch_period`` epochs, keeping the
    last ``max_checkpoints``; with ``save_best``, also
    ``{model_prefix}-best.params`` whenever ``monitor`` improves."""

    def __init__(self, model_dir: str, model_prefix: str = "model",
                 monitor=None, save_best: bool = False, mode: str = "auto",
                 epoch_period: int = 1, max_checkpoints: int = 5,
                 resume_from_checkpoint: bool = False):
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.monitor = monitor
        self.save_best = save_best
        self.epoch_period = epoch_period
        self.max_checkpoints = max_checkpoints
        self.current_epoch = 0
        self.saved = []
        mode = _mode(mode, monitor) if monitor is not None else mode
        self._better = np.greater if mode == "max" else np.less
        self.best = -np.inf if mode == "max" else np.inf

    def train_begin(self, estimator, *args, **kwargs):
        os.makedirs(self.model_dir, exist_ok=True)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            self._save(estimator, f"epoch{self.current_epoch}")
        if self.save_best and self.monitor is not None:
            _, val = self.monitor.get()
            if isinstance(val, float) and self._better(val, self.best):
                self.best = val
                estimator.net.save_parameters(os.path.join(
                    self.model_dir, f"{self.model_prefix}-best.params"))

    def _save(self, estimator, tag):
        path = os.path.join(self.model_dir,
                            f"{self.model_prefix}-{tag}.params")
        estimator.net.save_parameters(path)
        if estimator.trainer is not None:
            estimator.trainer.save_states(path.replace(".params", ".states"))
        self.saved.append(path)
        while len(self.saved) > self.max_checkpoints:
            old = self.saved.pop(0)
            for p in (old, old + ".npz", old.replace(".params", ".states")):
                if os.path.exists(p):
                    os.remove(p)


class EarlyStoppingHandler(TrainBegin, EpochEnd, TrainEnd):
    """Stop when ``monitor`` has not improved by ``min_delta`` for
    ``patience`` epochs."""

    def __init__(self, monitor, min_delta: float = 0.0, patience: int = 0,
                 mode: str = "auto", baseline: Optional[float] = None):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.baseline = baseline
        self.wait = 0
        self.stopped_epoch = 0
        self.current_epoch = 0
        self.stop_training = False
        if _mode(mode, monitor) == "max":
            self._better = lambda a, b: np.greater(a - self.min_delta, b)
            self.best = -np.inf
        else:
            self._better = lambda a, b: np.less(a + self.min_delta, b)
            self.best = np.inf
        if baseline is not None:
            self.best = baseline

    def train_begin(self, estimator, *args, **kwargs):
        self.wait = 0
        self.stop_training = False

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        _, val = self.monitor.get()
        if not isinstance(val, float):
            return
        if self._better(val, self.best):
            self.best = val
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = self.current_epoch
                self.stop_training = True

    def train_end(self, estimator, *args, **kwargs):
        if self.stopped_epoch:
            logging.getLogger(_LOG).info(
                "early stopping at epoch %d (best %s=%.6f)",
                self.stopped_epoch, self.monitor.get()[0], self.best)


class GradientUpdateHandler(BatchEnd):
    """``trainer.step`` at batch end, for a loop that leaves the update to
    a handler (``priority`` orders it against the other batch-end
    handlers); the batch size is the loss's length."""

    def __init__(self, priority=-2000):
        self.priority = priority

    def batch_end(self, estimator, *args, **kwargs):
        loss = kwargs.get("loss", [])
        if not isinstance(loss, (list, tuple)):
            loss = [loss]
        batch_size = sum(l.shape[0] if getattr(l, "ndim", 0) else 1
                         for l in loss)
        estimator.trainer.step(batch_size or 1)


class TrainingHealthHandler(TrainBegin, BatchEnd):
    """The loss sentinel of the eager loop: one trip per batch whose loss
    has a non-finite sample, and the rolling z-score spike detector on the
    batch's mean loss, each answered by the config's ``action`` (``log``,
    ``dump`` or ``raise``; ``skip`` is the compiled step's and logs here).
    ``Estimator.fit(health=...)`` installs it on the eager loop only: the
    fused driver's in-graph watchpoints watch the loss there."""

    def __init__(self, config=None, priority: int = 1000):
        from ....observability import health as _health
        self._health = _health
        self.config = (_health.HealthConfig.coerce(config)
                       or _health.HealthConfig())
        self.loss_detector = _health.SpikeDetector(self.config.window,
                                                   self.config.zscore)
        self.priority = priority
        self._batch = 0

    def train_begin(self, estimator, *args, **kwargs):
        self._batch = 0

    def batch_end(self, estimator, *args, loss=None, **kwargs):
        if loss is None:
            return
        h = self._health
        act = self.config.action if self.config.action != "skip" else "log"
        vals = np.asarray(loss.asnumpy() if hasattr(loss, "asnumpy")
                          else loss).ravel()
        if vals.size == 0:
            return
        self._batch += 1
        bad = int(vals.size - np.isfinite(vals).sum())
        if bad:
            h._M_NONFINITE.labels(where="loss").inc()
            rec = {"kind": "nonfinite", "step": self._batch,
                   "nonfinite_loss": bad, "t_unix": time.time(),
                   "source": "estimator"}
            h.ledger().record_trip(rec)
            h._respond(act, rec, f"non-finite loss ({bad} of {vals.size} "
                                 f"samples) at batch {self._batch}")
            return
        v = float(vals.mean())
        if self.loss_detector.update(v):
            h._M_SPIKES.labels(signal="loss").inc()
            rec = {"kind": "spike", "signal": "loss", "value": v,
                   "step": self._batch, "t_unix": time.time(),
                   "source": "estimator"}
            h.ledger().record_spike(rec)
            h._respond(act, rec, f"loss spike at batch {self._batch}: "
                                 f"{v:.6g} beyond the rolling "
                                 f"z={self.config.zscore:g} band",
                       where="loss")
