"""Learning-rate schedulers (``mxnet_tpu/lr_scheduler.py``): cumulative
update count -> learning rate.

The port's own copy of the JAX package's module, which imports no JAX:
the reference's decay boundaries (``python/mxnet/lr_scheduler.py``: the
rate drops once ``num_update`` strictly exceeds a boundary), each rate a
pure function of ``num_update``, so it may be queried in any order.
"""
from __future__ import annotations

import bisect
import logging


class LRScheduler:
    """Base: ``scheduler(num_update) -> lr``.

    Subclasses implement ``_decays(num_update)`` (how many decay
    boundaries have been crossed) and optionally ``_floor()``.
    ``base_lr`` is assigned by the Optimizer that owns the scheduler.
    """

    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr
        self._logged_decays = 0     # logging watermark only, not lr state

    def _decays(self, num_update):
        raise NotImplementedError

    def _floor(self):
        return 0.0

    def __call__(self, num_update):
        k = self._decays(num_update)
        lr = max(self.base_lr * self.factor ** k, self._floor())
        if k > self._logged_decays:
            self._logged_decays = k
            logging.info("Update[%d]: Change learning rate to %0.5e",
                         num_update, lr)
        return lr


class FactorScheduler(LRScheduler):
    """Geometric decay every ``step`` updates
    (reference ``lr_scheduler.py:36``): boundary ``i`` sits at
    ``i * step`` and applies once ``num_update`` passes it."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8):
        super().__init__()
        if int(step) < 1:
            raise ValueError("step must be >= 1 update")
        if factor > 1.0:
            raise ValueError("factor must be <= 1 so the lr decays")
        self.step = int(step)
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def _decays(self, num_update):
        return max(0, (int(num_update) - 1) // self.step)

    def _floor(self):
        return self.stop_factor_lr


class MultiFactorScheduler(LRScheduler):
    """Decay at explicit milestones (reference ``lr_scheduler.py:77``)."""

    def __init__(self, step, factor=1):
        super().__init__()
        if not isinstance(step, list) or not step:
            raise ValueError("step must be a non-empty list of milestones")
        if any(s < 1 for s in step) or sorted(set(step)) != list(step):
            raise ValueError("step must be strictly increasing, each >= 1")
        if factor > 1.0:
            raise ValueError("factor must be <= 1 so the lr decays")
        self.step = step
        self.factor = factor

    def _decays(self, num_update):
        # milestones strictly below num_update have been crossed
        return bisect.bisect_left(self.step, int(num_update))


class PolyScheduler(LRScheduler):
    """Polynomial decay to zero over ``max_update`` steps (used by
    ResNet training recipes)."""

    def __init__(self, max_update, power=2):
        super().__init__()
        self.max_update = max_update
        self.power = power

    def __call__(self, num_update):
        remain = max(0.0, 1.0 - num_update / self.max_update)
        return self.base_lr * remain ** self.power
