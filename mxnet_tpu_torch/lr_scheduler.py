"""Learning-rate schedulers (counterpart of
``mxnet_tpu/lr_scheduler.py``, reference ``python/mxnet/lr_scheduler.py``).

A scheduler maps the optimizer's update count to a learning rate; an
optimizer given ``lr_scheduler=`` sets the scheduler's ``base_lr`` to its own
``learning_rate``."""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler", "PolyScheduler",
           "CosineScheduler"]


class LRScheduler:
    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0.0,
                 warmup_mode="linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        assert num_update < self.warmup_steps
        if self.warmup_mode == "linear":
            inc = (self.warmup_final_lr - self.warmup_begin_lr) * num_update / self.warmup_steps
            return self.warmup_begin_lr + inc
        return self.warmup_begin_lr  # constant

    def __call__(self, num_update) -> float:
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8, base_lr=0.01, **kw):
        super().__init__(base_lr, **kw)
        if step < 1:
            raise ValueError("step must be >= 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        if self.warmup_steps and num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    def __init__(self, step, factor=1.0, base_lr=0.01, **kw):
        super().__init__(base_lr, **kw)
        if not all(step[i] < step[i + 1] for i in range(len(step) - 1)):
            raise ValueError("steps must be increasing")
        self.step = list(step)
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        if self.warmup_steps and num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
            else:
                return self.base_lr
        return self.base_lr


class PolyScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0.0, **kw):
        super().__init__(base_lr, **kw)
        self.power = pwr
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update):
        if self.warmup_steps and num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            return self.final_lr + (self.base_lr_orig - self.final_lr) * \
                pow(1 - (num_update - self.warmup_steps) / self.max_steps, self.power)
        return self.final_lr


class CosineScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, final_lr=0.0, **kw):
        super().__init__(base_lr, **kw)
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update):
        if self.warmup_steps and num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            return self.final_lr + (self.base_lr_orig - self.final_lr) * \
                (1 + math.cos(math.pi * (num_update - self.warmup_steps) / self.max_steps)) / 2
        return self.final_lr
