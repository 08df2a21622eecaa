"""Learning-rate control: linear warm-up, ReduceLROnPlateau, early stopping.

Port of ``volpick_tpu/train/schedules.py`` (a copy: plain Python, the same
sequences).

The reference warms the LR linearly over the first 500 optimizer steps
(`volpick/model/models.py:177-185`) and optionally applies torch's
ReduceLROnPlateau per epoch on a monitored loss (`models.py:187-219`,
configs use factor 0.5 / patience 20 / min_lr 1e-6). Both are host-side
scalar controllers here; the trainer sets base_lr × warmup × plateau_scale
for every step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


def warmup_scale(step: int, warmup_steps: int = 500) -> float:
    if warmup_steps <= 0:
        return 1.0
    return min(1.0, float(step + 1) / float(warmup_steps))


@dataclass
class PlateauScheduler:
    """torch.optim.lr_scheduler.ReduceLROnPlateau semantics (mode='min')."""

    factor: float = 0.5
    patience: int = 20
    min_lr: float = 1e-6
    threshold: float = 1e-4
    threshold_mode: str = "rel"
    cooldown: int = 0
    base_lr: float = 1e-3

    best: float = math.inf
    num_bad_epochs: int = 0
    cooldown_counter: int = 0
    lr: float = field(default=0.0)

    def __post_init__(self):
        if not self.lr:
            self.lr = self.base_lr

    def _is_better(self, metric: float) -> bool:
        if self.threshold_mode == "rel":
            return metric < self.best * (1.0 - self.threshold)
        return metric < self.best - self.threshold

    def step(self, metric: float) -> float:
        """Call once per epoch with the monitored loss; returns current lr."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.cooldown_counter = self.cooldown
                self.num_bad_epochs = 0
        return self.lr


@dataclass
class EarlyStopper:
    """EarlyStopping(monitor, patience, mode='min') (`train.py:177-180`)."""

    patience: int = 100
    min_delta: float = 0.0
    best: float = math.inf
    bad_epochs: int = 0

    def step(self, metric: float) -> bool:
        """Returns True when training should stop."""
        if metric < self.best - self.min_delta:
            self.best = metric
            self.bad_epochs = 0
            return False
        self.bad_epochs += 1
        return self.bad_epochs > self.patience
