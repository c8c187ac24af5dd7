"""Log the current loss coefficients each epoch (``loss_coeffs/<name>``).

Port of ``nequip_tpu/train/callbacks/loss_coeff_monitor.py``.
"""

from __future__ import annotations

from .base import Callback


class LossCoefficientMonitor(Callback):
    def on_train_epoch_end(self, trainer, module, epoch: int, metrics) -> None:
        for name, value in trainer.current_loss_coeffs().items():
            trainer.log_scalar(f"loss_coeffs/{name}", float(value))
