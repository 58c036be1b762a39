"""Training callbacks (counterpart of ``mxnet_tpu/callback.py``;
reference ``python/mxnet/callback.py``).  Batch-end callbacks take a
:class:`~mxnet_tpu_torch.model.BatchEndParam`; epoch-end callbacks take
``(epoch, symbol, arg_params, aux_params)``."""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "do_checkpoint", "module_checkpoint",
           "log_train_metric", "LogValidationMetricsCallback", "ProgressBar"]


def do_checkpoint(prefix: str, period: int = 1):
    """Epoch-end callback saving the checkpoint ``prefix``, epoch
    ``iter_no + 1``, every ``period`` epochs."""
    from .model import save_checkpoint
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def module_checkpoint(mod, prefix: str, period: int = 1,
                      save_optimizer_states: bool = False):
    """Epoch-end callback checkpointing ``mod`` (reference
    ``callback.py:27``)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


def log_train_metric(period: int, auto_reset: bool = False):
    """Batch-end callback logging the training metric every ``period``
    batches."""
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset_local()
    return _callback


class Speedometer:
    """Logs samples per second (host clock) and the metric every
    ``frequent`` batches; the first call of an epoch starts the clock."""

    def __init__(self, batch_size: int, frequent: int = 50,
                 auto_reset: bool = True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0.0
        self.last_count = 0

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if not self.init:
            self.init = True
            self.tic = time.time()
            return
        if count % self.frequent:
            return
        speed = self.frequent * self.batch_size / (time.time() - self.tic)
        if param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            if self.auto_reset:
                param.eval_metric.reset_local()
            logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\t%s",
                         param.epoch, count, speed,
                         "\t".join(f"{n}={v:f}" for n, v in name_value))
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, count, speed)
        self.tic = time.time()


class LogValidationMetricsCallback:
    def __call__(self, param):
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name,
                         value)


class ProgressBar:
    def __init__(self, total: int, length: int = 80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = int(round(100.0 * count / float(self.total)))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")
