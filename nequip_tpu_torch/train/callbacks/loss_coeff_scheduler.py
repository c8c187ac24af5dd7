"""Loss-coefficient schedulers: a step schedule (coefficients set at given
epochs) and a linear interpolation between two epochs, applied through the
trainer's loss-coefficient vector.

Port of ``nequip_tpu/train/callbacks/loss_coeff_scheduler.py``.
"""

from __future__ import annotations

from typing import Dict

from .base import Callback


class LossCoefficientScheduler(Callback):
    """``schedule``: {epoch: {loss_name: coeff, ...}, ...}."""

    def __init__(self, schedule: Dict[int, Dict[str, float]]):
        self.schedule = {int(k): dict(v) for k, v in schedule.items()}

    def on_train_epoch_start(self, trainer, module, epoch: int) -> None:
        if epoch in self.schedule:
            trainer.set_loss_coeffs(self.schedule[epoch])


class LinearLossCoefficientScheduler(Callback):
    """Linearly interpolate coefficients between two epochs."""

    def __init__(
        self,
        initial_coeffs: Dict[str, float],
        final_coeffs: Dict[str, float],
        start_epoch: int,
        end_epoch: int,
    ):
        if set(initial_coeffs) != set(final_coeffs):
            raise ValueError("initial_coeffs and final_coeffs must name the same losses")
        if end_epoch <= start_epoch:
            raise ValueError("end_epoch must come after start_epoch")
        self.initial = dict(initial_coeffs)
        self.final = dict(final_coeffs)
        self.start_epoch = int(start_epoch)
        self.end_epoch = int(end_epoch)

    def on_train_epoch_start(self, trainer, module, epoch: int) -> None:
        if epoch < self.start_epoch:
            coeffs = self.initial
        elif epoch >= self.end_epoch:
            coeffs = self.final
        else:
            t = (epoch - self.start_epoch) / (self.end_epoch - self.start_epoch)
            coeffs = {
                k: (1 - t) * self.initial[k] + t * self.final[k] for k in self.initial
            }
        trainer.set_loss_coeffs(coeffs)
