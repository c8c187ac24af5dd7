"""Log weight statistics during training.

Port of ``nequip_tpu/train/callbacks/training_stats.py``: the rms and the
largest magnitude over every model tensor (``weights/rms``,
``weights/absmax``) and, with an EMA module, over the EMA model's
(``ema_weights/*``).  As in the JAX package, the tensors are all of the JAX
parameter tree, the frozen per-type scales and shifts and Bessel weights
included (``jax_named_tensors``), in the tree's order.
"""

from __future__ import annotations

import numpy as np

from .base import Callback


def _tensor_stats(model, prefix: str) -> dict:
    named = sorted(model.jax_named_tensors(), key=lambda kv: kv[0].split("."))
    if not named:
        return {}
    flat = np.concatenate([t.detach().cpu().numpy().reshape(-1) for _, t in named])
    return {f"{prefix}/rms": float(np.sqrt(np.mean(flat**2))), f"{prefix}/absmax": float(np.abs(flat).max())}


class TrainingStatsMonitor(Callback):
    def __init__(self, every_n_epochs: int = 1):
        self.every_n_epochs = int(every_n_epochs)

    def on_train_epoch_end(self, trainer, module, epoch: int, metrics) -> None:
        if epoch % self.every_n_epochs:
            return
        stats = _tensor_stats(module.model, "weights")
        if getattr(module, "ema_model", None) is not None:
            stats.update(_tensor_stats(module.ema_model, "ema_weights"))
        for name, value in stats.items():
            trainer.log_scalar(name, value)
