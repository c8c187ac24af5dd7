"""Host-side epoch LR schedulers.

Port of ``nequip_tpu/train/lr_scheduler.py``: the nine schedulers of the
``lr_scheduler: {scheduler, monitor, interval: epoch, frequency}`` config
block, each a small stateful object whose ``step(metric)`` returns a
multiplicative factor on the base learning rate (torch's ``get_last_lr() /
base_lr``) once per epoch; the trainer sets each parameter group's rate to
its base rate times that factor rounded to float32, as the JAX trainer
passes the factor to its step.  Nested configs (a ``schedulers`` list, for
``SequentialLR`` and ``ChainedScheduler``) are built by
:func:`build_scheduler`.  State is a plain dict for checkpoints.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence


class LRScheduler:
    """Base: ``step(metric) -> scale`` once per epoch (or per ``frequency``)."""

    def __init__(self):
        self.last_epoch = -1
        self._scale = 1.0

    # -- torch-like API ------------------------------------------------
    def step(self, metric: Optional[float] = None) -> float:
        self.last_epoch += 1
        self._scale = self._compute_scale(metric)
        return self._scale

    @property
    def scale(self) -> float:
        return self._scale

    def _compute_scale(self, metric: Optional[float]) -> float:
        raise NotImplementedError

    # -- persistence ----------------------------------------------------
    def state_dict(self) -> dict:
        return {
            k: v for k, v in self.__dict__.items() if not k.startswith("_sub")
        }

    def load_state_dict(self, sd: dict) -> None:
        self.__dict__.update(sd)


class ConstantLR(LRScheduler):
    """Scale ``factor`` for the first ``total_iters`` epochs, then 1."""

    def __init__(self, factor: float = 1.0 / 3, total_iters: int = 5):
        super().__init__()
        self.factor = float(factor)
        self.total_iters = int(total_iters)

    def _compute_scale(self, metric):
        return self.factor if self.last_epoch < self.total_iters else 1.0


class StepLR(LRScheduler):
    def __init__(self, step_size: int, gamma: float = 0.1):
        super().__init__()
        self.step_size = int(step_size)
        self.gamma = float(gamma)

    def _compute_scale(self, metric):
        return self.gamma ** (self.last_epoch // self.step_size)


class MultiStepLR(LRScheduler):
    def __init__(self, milestones: Sequence[int], gamma: float = 0.1):
        super().__init__()
        self.milestones = sorted(int(m) for m in milestones)
        self.gamma = float(gamma)

    def _compute_scale(self, metric):
        n = sum(1 for m in self.milestones if m <= self.last_epoch)
        return self.gamma**n


class ExponentialLR(LRScheduler):
    def __init__(self, gamma: float):
        super().__init__()
        self.gamma = float(gamma)

    def _compute_scale(self, metric):
        return self.gamma**self.last_epoch


class LinearLR(LRScheduler):
    """Linear ramp ``start_factor -> end_factor`` over ``total_iters`` epochs."""

    def __init__(
        self,
        start_factor: float = 1.0 / 3,
        end_factor: float = 1.0,
        total_iters: int = 5,
    ):
        super().__init__()
        self.start_factor = float(start_factor)
        self.end_factor = float(end_factor)
        self.total_iters = int(total_iters)

    def _compute_scale(self, metric):
        t = min(max(self.last_epoch, 0), self.total_iters) / self.total_iters
        return self.start_factor + (self.end_factor - self.start_factor) * t


class CosineAnnealingLR(LRScheduler):
    """Cosine from 1 down to ``eta_min_factor`` over ``T_max`` epochs.

    Note: torch's ``eta_min`` is an absolute LR; here it is a factor of the
    base LR (this module is LR-relative throughout).
    """

    def __init__(self, T_max: int, eta_min_factor: float = 0.0):
        super().__init__()
        self.T_max = int(T_max)
        self.eta_min_factor = float(eta_min_factor)

    def _compute_scale(self, metric):
        cos = (1 + math.cos(math.pi * (self.last_epoch % (2 * self.T_max)) / self.T_max)) / 2
        return self.eta_min_factor + (1.0 - self.eta_min_factor) * cos


class ReduceLROnPlateau(LRScheduler):
    """Multiply the scale by ``factor`` when the monitored metric stops
    improving (``torch.optim.lr_scheduler.ReduceLROnPlateau`` on a factor)."""

    def __init__(
        self,
        mode: str = "min",
        factor: float = 0.1,
        patience: int = 10,
        threshold: float = 1e-4,
        threshold_mode: str = "rel",
        cooldown: int = 0,
        min_lr_factor: float = 0.0,
    ):
        super().__init__()
        if mode not in ("min", "max") or threshold_mode not in ("rel", "abs"):
            raise ValueError(f"mode {mode!r} / threshold_mode {threshold_mode!r}")
        self.mode = mode
        self.factor = float(factor)
        self.patience = int(patience)
        self.threshold = float(threshold)
        self.threshold_mode = threshold_mode
        self.cooldown = int(cooldown)
        self.min_lr_factor = float(min_lr_factor)
        self.best: Optional[float] = None
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.threshold_mode == "rel":
            delta = abs(self.best) * self.threshold
        else:
            delta = self.threshold
        if self.mode == "min":
            return metric < self.best - delta
        return metric > self.best + delta

    def _compute_scale(self, metric):
        if metric is None:
            return self._scale  # no monitored value this epoch: hold
        metric = float(metric)
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        scale = self._scale
        if self.num_bad_epochs > self.patience:
            scale = max(scale * self.factor, self.min_lr_factor)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return scale


class SequentialLR(LRScheduler):
    """Run ``schedulers[i]`` between ``milestones[i-1]`` and ``milestones[i]``
    (``torch.optim.lr_scheduler.SequentialLR``)."""

    def __init__(self, schedulers: Sequence[LRScheduler], milestones: Sequence[int]):
        super().__init__()
        if len(milestones) != len(schedulers) - 1:
            raise ValueError("SequentialLR needs one milestone fewer than schedulers")
        self.schedulers = list(schedulers)
        self.milestones = [int(m) for m in milestones]

    def _compute_scale(self, metric):
        idx = sum(1 for m in self.milestones if m <= self.last_epoch)
        return self.schedulers[idx].step(metric)

    def state_dict(self):
        return {
            "last_epoch": self.last_epoch,
            "milestones": self.milestones,
            "schedulers": [s.state_dict() for s in self.schedulers],
        }

    def load_state_dict(self, sd):
        self.last_epoch = sd["last_epoch"]
        self.milestones = sd["milestones"]
        for s, ssd in zip(self.schedulers, sd["schedulers"]):
            s.load_state_dict(ssd)


class ChainedScheduler(LRScheduler):
    """Product of the component schedulers' scales each epoch
    (``torch.optim.lr_scheduler.ChainedScheduler``)."""

    def __init__(self, schedulers: Sequence[LRScheduler]):
        super().__init__()
        self.schedulers = list(schedulers)

    def _compute_scale(self, metric):
        scale = 1.0
        for s in self.schedulers:
            scale *= s.step(metric)
        return scale

    def state_dict(self):
        return {
            "last_epoch": self.last_epoch,
            "schedulers": [s.state_dict() for s in self.schedulers],
        }

    def load_state_dict(self, sd):
        self.last_epoch = sd["last_epoch"]
        for s, ssd in zip(self.schedulers, sd["schedulers"]):
            s.load_state_dict(ssd)


def build_scheduler(cfg) -> LRScheduler:
    """Instantiate a scheduler config; ``SequentialLR`` and
    ``ChainedScheduler`` configs carry a ``schedulers`` list of inner
    configs, built first."""
    from ..utils.config import instantiate

    if isinstance(cfg, LRScheduler):
        return cfg
    cfg = dict(cfg)
    inner = cfg.pop("schedulers", None)
    if inner is not None:
        cfg["schedulers"] = [build_scheduler(c) for c in inner]
        return instantiate(cfg, _recursive_=False)
    return instantiate(cfg)
