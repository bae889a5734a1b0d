"""Learning-rate schedule reproducing the reference's exact LR sequence
(a copy of ``sunet_tf_tpu/train/schedule.py``).

The reference composes GradualWarmupScheduler(multiplier=1, total_epoch=3)
around CosineAnnealingLR(T_max=EPOCHS-3, eta_min=LR_MIN) and calls
scheduler.step() once at startup (train.py:135) plus once per epoch
(train.py:718). Unrolling torch's stepping semantics
(warmup_scheduler/scheduler.py:25-37 + torch _LRScheduler init-step):

  epoch e (1-indexed) runs at
    e <= warmup:            base * e / warmup           (linear ramp, NOT
                                                         starting at 0 — the
                                                         startup step shifts
                                                         the ramp by one)
    e == warmup + 1:        base                        (cosine step 0)
    e >  warmup + 1:        eta_min + (base - eta_min)
                            * (1 + cos(pi * (e - warmup - 1) / T_max)) / 2

so with EPOCHS=500: epoch 500 runs at cosine step 496 of T_max=497 — the
schedule never quite reaches eta_min, exactly like the reference (SURVEY
defect #7, reproduced deliberately).

Resume replays steps (reference train.py:143-144) — with a closed form this
is just evaluating at the resumed epoch.
"""

from __future__ import annotations

import math


def reference_lr_schedule(
    epoch: int,
    base_lr: float,
    lr_min: float,
    total_epochs: int,
    warmup_epochs: int = 3,
) -> float:
    """LR used *during* 1-indexed ``epoch`` under the reference recipe."""
    if epoch <= warmup_epochs:
        return base_lr * epoch / warmup_epochs
    t_max = max(total_epochs - warmup_epochs, 1)
    step = epoch - warmup_epochs - 1  # cosine step 0 at epoch warmup+1
    return lr_min + (base_lr - lr_min) * (1.0 + math.cos(math.pi * step / t_max)) / 2.0


def lr_for_step(
    global_step: int,
    steps_per_epoch: int,
    base_lr: float,
    lr_min: float,
    total_epochs: int,
    warmup_epochs: int = 3,
) -> float:
    """Per-step wrapper: LR is constant within an epoch (reference steps the
    scheduler per epoch, not per batch)."""
    epoch = global_step // max(steps_per_epoch, 1) + 1
    return reference_lr_schedule(epoch, base_lr, lr_min, total_epochs, warmup_epochs)


# ---------------------------------------------------------------------------
# Generic scheduler objects — full parity with the reference class beyond
# the recipe composite: arbitrary multiplier >= 1
# (reference warmup_scheduler/scheduler.py:30-37) and the ReduceLROnPlateau
# after-scheduler branch (reference warmup_scheduler/scheduler.py:39-51).
# The LR is plain host-side float state consumed once per epoch.
# ---------------------------------------------------------------------------


class CosineAnnealing:
    """Closed-form CosineAnnealingLR after-scheduler (torch semantics when
    stepped sequentially from construction). ``base_lr`` is installed by
    GradualWarmupScheduler (scaled by its multiplier, mirroring reference
    warmup_scheduler/scheduler.py:29-31)."""

    def __init__(self, t_max: int, eta_min: float = 0.0):
        self.t_max = max(int(t_max), 1)
        self.eta_min = eta_min
        self.last_epoch = 0
        self.base_lr: float = 0.0

    def current_lr(self) -> float:
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1.0 + math.cos(math.pi * self.last_epoch / self.t_max)) / 2.0

    def step(self) -> None:
        self.last_epoch += 1


class ReduceLROnPlateau:
    """Metric-driven LR reduction, torch.optim.lr_scheduler semantics:
    best-so-far tracking with rel/abs threshold, patience in bad epochs,
    cooldown after each reduction, floor at min_lr. Owns the current lr
    (installed by the warmup wrapper or set directly via ``lr``)."""

    def __init__(self, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4,
                 threshold_mode: str = "rel", cooldown: int = 0,
                 min_lr: float = 0.0):
        assert mode in ("min", "max") and threshold_mode in ("rel", "abs")
        assert factor < 1.0
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.lr: float = 0.0
        self.best = math.inf if mode == "min" else -math.inf
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def _is_better(self, a: float) -> bool:
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return a < self.best * (1.0 - self.threshold)
            return a < self.best - self.threshold
        if self.threshold_mode == "rel":
            return a > self.best * (1.0 + self.threshold)
        return a > self.best + self.threshold

    def step(self, metric: float) -> float:
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr


class GradualWarmupScheduler:
    """Full-semantics port of the reference wrapper
    (warmup_scheduler/scheduler.py:5-65), torch-oracle-tested:

    - construction performs torch _LRScheduler's implicit init step;
    - multiplier == 1: lr ramps base * last_epoch/total_epoch
      (scheduler.py:34-35); multiplier > 1: base * ((m-1)*e/total + 1)
      (scheduler.py:36-37);
    - past total_epoch the after-scheduler takes over with base_lrs
      scaled by the multiplier (scheduler.py:27-31), or the lr holds at
      base*multiplier with no after-scheduler (scheduler.py:32);
    - a ReduceLROnPlateau after-scheduler routes through the
      step_ReduceLROnPlateau branch (scheduler.py:39-51), including its
      quirks: the init step lands on last_epoch=1 (the ``epoch != 0``
      special case) and warmup always uses the multiplier>1 formula.

    Call ``step()`` once per epoch (``step(metrics=...)`` for plateau);
    read ``.lr``.
    """

    def __init__(self, base_lr: float, multiplier: float, total_epoch: int,
                 after_scheduler=None):
        if multiplier < 1.0:
            raise ValueError("multiplier should be >= 1 (reference "
                             "warmup_scheduler/scheduler.py:18-19)")
        self.base_lr = base_lr
        self.multiplier = multiplier
        self.total_epoch = total_epoch
        self.after_scheduler = after_scheduler
        self.finished = False
        self.last_epoch = -1
        self.lr = 0.0
        self.step()  # torch _LRScheduler.__init__ implicit step

    def _warmup_lr(self, plateau_branch: bool) -> float:
        if self.multiplier == 1.0 and not plateau_branch:
            return self.base_lr * float(self.last_epoch) / self.total_epoch
        return self.base_lr * ((self.multiplier - 1.0) * self.last_epoch
                               / self.total_epoch + 1.0)

    def step(self, metrics: float = None) -> float:
        if isinstance(self.after_scheduler, ReduceLROnPlateau):
            epoch = self.last_epoch + 1
            self.last_epoch = epoch if epoch != 0 else 1
            if self.last_epoch <= self.total_epoch:
                self.lr = self._warmup_lr(plateau_branch=True)
                self.after_scheduler.lr = self.lr
            else:
                self.lr = self.after_scheduler.step(metrics)
            return self.lr

        if self.finished and self.after_scheduler is not None:
            self.after_scheduler.step()
            self.lr = self.after_scheduler.current_lr()
            return self.lr
        self.last_epoch += 1
        if self.last_epoch > self.total_epoch:
            if self.after_scheduler is not None:
                if not self.finished:
                    self.after_scheduler.base_lr = (
                        self.base_lr * self.multiplier)
                    self.finished = True
                self.lr = self.after_scheduler.current_lr()
            else:
                self.lr = self.base_lr * self.multiplier
        else:
            self.lr = self._warmup_lr(plateau_branch=False)
        return self.lr
