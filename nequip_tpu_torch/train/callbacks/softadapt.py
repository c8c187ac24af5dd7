"""SoftAdapt adaptive loss-coefficient weighting.

Port of ``nequip_tpu/train/callbacks/softadapt.py``: coefficients move
toward loss components whose values are increasing, averaged over an
update cycle of ``frequency`` batches or epochs, rescaled by the loss
manager's current coefficients and renormalised.
"""

from __future__ import annotations

from math import exp, sqrt
from typing import Dict, List, Optional

from .base import Callback


class SoftAdapt(Callback):
    def __init__(self, beta: float, interval: str, frequency: int, eps: float = 1e-8):
        if interval not in ("batch", "epoch"):
            raise ValueError(f"interval must be 'batch' or 'epoch', got {interval!r}")
        if frequency < 1:
            raise ValueError("frequency must be >= 1")
        self.beta = float(beta)
        self.interval = interval
        self.frequency = int(frequency)
        self.eps = float(eps)
        self.prev_losses: Optional[Dict[str, float]] = None
        self.cached_coeffs: List[Dict[str, float]] = []

    def _update(self, new_losses: Dict[str, float], step: int, trainer, module) -> None:
        base_coeffs = {
            name: c for name, c in module.loss.coeffs.items() if c is not None
        }
        if not set(base_coeffs) <= set(new_losses):
            raise ValueError("all loss components must have coefficients for SoftAdapt")
        new_losses = {k: float(new_losses[k]) for k in base_coeffs}

        if step % self.frequency == 0:
            self.cached_coeffs = []

        if self.prev_losses is None:
            self.prev_losses = new_losses
            return

        changes = {k: new_losses[k] - self.prev_losses[k] for k in new_losses}
        ss = sum(v * v for v in changes.values())
        factor = self.beta / max(sqrt(ss), self.eps)
        exps = {k: exp(factor * v) for k, v in changes.items()}
        denom = sum(exps.values()) + self.eps
        coeffs = {k: (e / denom) * base_coeffs[k] for k, e in exps.items()}
        total = sum(coeffs.values())
        coeffs = {k: v / total for k, v in coeffs.items()}
        self.cached_coeffs.append(coeffs)
        self.prev_losses = new_losses

        if step % self.frequency == 1:
            n = len(self.cached_coeffs)
            avg = {
                k: sum(c[k] for c in self.cached_coeffs) / n for k in coeffs
            }
            trainer.set_loss_coeffs(avg)

    def on_train_batch_end(self, trainer, module, logs, step: int) -> None:
        if self.interval != "batch" or step == 0:
            return
        losses = {
            k.split("/", 1)[1]: v
            for k, v in logs.items()
            if k.startswith("train_loss_step/")
        }
        self._update(losses, step, trainer, module)

    def on_train_epoch_end(self, trainer, module, epoch: int, metrics) -> None:
        if self.interval != "epoch":
            return
        losses = {
            k.split("/", 1)[1]: v
            for k, v in metrics.items()
            if k.startswith("train_loss_epoch/")
        }
        if losses:
            self._update(losses, epoch + 1, trainer, module)

    def state_dict(self) -> dict:
        return {
            "beta": self.beta,
            "interval": self.interval,
            "frequency": self.frequency,
            "eps": self.eps,
            "prev_losses": self.prev_losses,
            "cached_coeffs": self.cached_coeffs,
        }

    def load_state_dict(self, sd: dict) -> None:
        self.beta = sd["beta"]
        self.interval = sd["interval"]
        self.frequency = sd["frequency"]
        self.eps = sd["eps"]
        self.prev_losses = sd["prev_losses"]
        self.cached_coeffs = sd["cached_coeffs"]
