"""Learning-rate schedulers (reference: python/mxnet/lr_scheduler.py).

Counterpart of ``geomx_tpu/lr_scheduler.py``, the same pure Python, so
a JAX-package optimizer pickled with a scheduler unpickles onto this
module's classes (``kvstore/server.py`` ``_SysModulesUnpickler``).

A scheduler maps ``num_update`` — the max number of optimizer updates
applied to any single key (reference: lr_scheduler.py:71-80) — to a
learning rate. Attach one to an optimizer via
``Optimizer(lr_scheduler=...)``; the optimizer calls it each step.

All schedulers support the reference's warmup contract
(lr_scheduler.py:22-63): ``warmup_steps`` of 'linear' ramp from
``warmup_begin_lr`` up to ``base_lr``, or 'constant' at
``warmup_begin_lr``. Plain attributes only, so schedulers pickle and
travel to the global server inside the shipped optimizer.
"""

from __future__ import annotations

import logging
import math
from typing import List, Sequence, Union

log = logging.getLogger("geomx.lr_scheduler")

__all__ = [
    "LRScheduler", "FactorScheduler", "MultiFactorScheduler",
    "PolyScheduler", "CosineScheduler", "create",
]


class LRScheduler:
    """Base scheduler: warmup handling + ``__call__(num_update)``."""

    def __init__(self, base_lr: float = 0.01, warmup_steps: int = 0,
                 warmup_begin_lr: float = 0.0,
                 warmup_mode: str = "linear"):
        self.base_lr = base_lr
        if not isinstance(warmup_steps, int) or warmup_steps < 0:
            raise ValueError("warmup_steps must be a non-negative int")
        if warmup_begin_lr > base_lr:
            raise ValueError("base_lr must be >= warmup_begin_lr")
        if warmup_mode not in ("linear", "constant"):
            raise ValueError("warmup_mode must be 'linear' or 'constant'")
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update: int) -> float:
        assert num_update < self.warmup_steps
        if self.warmup_mode == "linear":
            return self.warmup_begin_lr + (
                (self.warmup_final_lr - self.warmup_begin_lr)
                * num_update / self.warmup_steps)
        return self.warmup_begin_lr

    def __call__(self, num_update: int) -> float:
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """``base_lr * factor^(num_update // step)``, floored at
    ``stop_factor_lr`` (reference: lr_scheduler.py:86-130)."""

    def __init__(self, step: int, factor: float = 1.0,
                 stop_factor_lr: float = 1e-8, base_lr: float = 0.01,
                 **kw):
        super().__init__(base_lr, **kw)
        if step < 1:
            raise ValueError("step must be >= 1")
        if factor > 1.0:
            raise ValueError("factor must be <= 1 so lr decays")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        # while, not if: resumed training may jump num_update forward
        # (reference: lr_scheduler.py:119)
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
                log.info("Update[%d]: lr floored at %.5e", num_update,
                         self.base_lr)
            else:
                log.info("Update[%d]: lr changed to %.5e", num_update,
                         self.base_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """Decay by ``factor`` at each milestone in ``step``
    (reference: lr_scheduler.py:131-189)."""

    def __init__(self, step: Sequence[int], factor: float = 1.0,
                 base_lr: float = 0.01, **kw):
        super().__init__(base_lr, **kw)
        steps: List[int] = list(step)
        if len(steps) < 1:
            raise ValueError("need at least one milestone")
        for i, s in enumerate(steps):
            if i and steps[i] <= steps[i - 1]:
                raise ValueError("milestones must be increasing")
            if s < 1:
                raise ValueError("milestones must be >= 1")
        if factor > 1.0:
            raise ValueError("factor must be <= 1 so lr decays")
        self.step = steps
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while (self.cur_step_ind <= len(self.step) - 1
               and num_update > self.step[self.cur_step_ind]):
            self.count = self.step[self.cur_step_ind]
            self.cur_step_ind += 1
            self.base_lr *= self.factor
            log.info("Update[%d]: lr changed to %.5e", num_update,
                     self.base_lr)
        return self.base_lr


class PolyScheduler(LRScheduler):
    """``final + (base-final) * (1 - nup/max)^pwr``
    (reference: lr_scheduler.py:190-237)."""

    def __init__(self, max_update: int, base_lr: float = 0.01,
                 pwr: int = 2, final_lr: float = 0.0, **kw):
        super().__init__(base_lr, **kw)
        if max_update < 1:
            raise ValueError("max_update must be >= 1")
        self.power = pwr
        self.base_lr_orig = self.base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            self.base_lr = self.final_lr + (
                (self.base_lr_orig - self.final_lr)
                * (1 - (num_update - self.warmup_steps)
                   / self.max_steps) ** self.power)
        return self.base_lr


class CosineScheduler(LRScheduler):
    """``final + (base-final) * (1 + cos(pi*nup/max)) / 2``
    (reference: lr_scheduler.py:238-289)."""

    def __init__(self, max_update: int, base_lr: float = 0.01,
                 final_lr: float = 0.0, **kw):
        super().__init__(base_lr, **kw)
        if max_update < 1:
            raise ValueError("max_update must be >= 1")
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            self.base_lr = self.final_lr + (
                (self.base_lr_orig - self.final_lr)
                * (1 + math.cos(
                    math.pi * (num_update - self.warmup_steps)
                    / self.max_steps)) / 2)
        return self.base_lr


_REGISTRY = {
    "factor": FactorScheduler,
    "multifactor": MultiFactorScheduler,
    "poly": PolyScheduler,
    "cosine": CosineScheduler,
}


def create(name: Union[str, LRScheduler], **kwargs) -> LRScheduler:
    """Scheduler factory by name."""
    if isinstance(name, LRScheduler):
        return name
    if name.lower() not in _REGISTRY:
        raise ValueError(f"unknown scheduler {name!r}; "
                         f"known: {sorted(_REGISTRY)}")
    return _REGISTRY[name.lower()](**kwargs)
