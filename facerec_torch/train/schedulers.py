"""Epoch-stepped LR schedulers (a copy of ``facerec_tpu/train/schedulers.py``,
pure Python). Each epoch they produce a scalar LR that the trainer sets as
the optimizer's ``learning_rate`` hyperparameter. Semantics mirror
``torch.optim.lr_scheduler`` stepped once per epoch, as the reference does.
"""

from __future__ import annotations

import math
from typing import Protocol

from facerec_torch.config import SchedulerConfig


class Scheduler(Protocol):
    def step(self, metric: float | None = None) -> float: ...
    @property
    def lr(self) -> float: ...


class _Base:
    def __init__(self, base_lr: float):
        self.base_lr = base_lr
        self._lr = base_lr
        self.epoch = -1

    @property
    def lr(self) -> float:
        return self._lr

    def step(self, metric: float | None = None) -> float:
        self.epoch += 1
        self._lr = self._compute(self.epoch, metric)
        return self._lr

    def _compute(self, epoch: int, metric: float | None) -> float:
        raise NotImplementedError

    def state_dict(self) -> dict:
        return dict(self.__dict__)

    def load_state_dict(self, d: dict) -> None:
        self.__dict__.update(d)


class ConstantLR(_Base):
    def _compute(self, epoch, metric):
        return self.base_lr


class StepLR(_Base):
    def __init__(self, base_lr: float, step_size: int = 10, gamma: float = 0.1):
        super().__init__(base_lr)
        self.step_size, self.gamma = step_size, gamma

    def _compute(self, epoch, metric):
        return self.base_lr * self.gamma ** (epoch // self.step_size)


class ExponentialLR(_Base):
    def __init__(self, base_lr: float, gamma: float = 0.95):
        super().__init__(base_lr)
        self.gamma = gamma

    def _compute(self, epoch, metric):
        return self.base_lr * self.gamma**epoch


class CosineAnnealingLR(_Base):
    def __init__(self, base_lr: float, t_max: int, min_lr: float = 1e-6):
        super().__init__(base_lr)
        self.t_max, self.min_lr = max(t_max, 1), min_lr

    def _compute(self, epoch, metric):
        t = min(epoch, self.t_max)
        return self.min_lr + 0.5 * (self.base_lr - self.min_lr) * (1 + math.cos(math.pi * t / self.t_max))


class WarmupCosineLR(_Base):
    """Linear warmup then cosine decay (reference get_warmup_scheduler
    training.py:158-180 — used for ArcFace)."""

    def __init__(self, base_lr: float, warmup_epochs: int, total_epochs: int, min_lr: float = 1e-6):
        super().__init__(base_lr)
        self.warmup_epochs = max(warmup_epochs, 1)
        self.total_epochs = max(total_epochs, self.warmup_epochs + 1)
        self.min_lr = min_lr

    def _compute(self, epoch, metric):
        if epoch < self.warmup_epochs:
            return self.base_lr * (epoch + 1) / self.warmup_epochs
        t = (epoch - self.warmup_epochs) / max(self.total_epochs - self.warmup_epochs, 1)
        return self.min_lr + 0.5 * (self.base_lr - self.min_lr) * (1 + math.cos(math.pi * min(t, 1.0)))


class ReduceLROnPlateau(_Base):
    """Reduce on stagnating val loss (torch semantics, min mode)."""

    def __init__(self, base_lr: float, factor: float = 0.5, patience: int = 5, min_lr: float = 1e-6):
        super().__init__(base_lr)
        self.factor, self.patience, self.min_lr = factor, patience, min_lr
        self.best = math.inf
        self.bad_epochs = 0

    def _compute(self, epoch, metric):
        if metric is None:
            return self._lr
        if metric < self.best - 1e-12:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.bad_epochs = 0
                return max(self._lr * self.factor, self.min_lr)
        return self._lr


class OneCycleLR(_Base):
    """One-cycle policy stepped per epoch (30% ramp-up, cosine down)."""

    def __init__(self, base_lr: float, max_lr: float | None, total_epochs: int, min_lr: float = 1e-6):
        super().__init__(base_lr)
        self.max_lr = max_lr or base_lr * 10
        self.total = max(total_epochs, 2)
        self.up = max(int(0.3 * self.total), 1)
        self.min_lr = min_lr

    def _compute(self, epoch, metric):
        e = min(epoch, self.total - 1)
        if e < self.up:
            return self.base_lr + (self.max_lr - self.base_lr) * (e + 1) / self.up
        t = (e - self.up) / max(self.total - self.up, 1)
        return self.min_lr + 0.5 * (self.max_lr - self.min_lr) * (1 + math.cos(math.pi * t))


def get_scheduler(config: SchedulerConfig, base_lr: float, total_epochs: int) -> _Base:
    """Factory (reference training_utils.py:83-148 get_scheduler)."""
    name = config.name.lower()
    if name in ("constant", "none"):
        return ConstantLR(base_lr)
    if name == "step":
        return StepLR(base_lr, config.step_size, config.gamma)
    if name == "exponential":
        return ExponentialLR(base_lr, config.gamma if config.gamma < 1 else 0.95)
    if name == "cosine":
        return CosineAnnealingLR(base_lr, total_epochs, config.min_lr)
    if name in ("warmup_cosine", "warmup"):
        return WarmupCosineLR(base_lr, config.warmup_epochs or max(total_epochs // 10, 1),
                              total_epochs, config.min_lr)
    if name in ("plateau", "reduce_lr"):
        return ReduceLROnPlateau(base_lr, config.plateau_factor, config.plateau_patience, config.min_lr)
    if name == "one_cycle":
        return OneCycleLR(base_lr, config.one_cycle_max_lr, total_epochs, config.min_lr)
    raise ValueError(f"Unknown scheduler: {config.name}")
