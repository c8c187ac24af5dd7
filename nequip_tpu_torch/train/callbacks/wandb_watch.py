"""Weights & Biases logging of weight and update histograms.

Port of ``nequip_tpu/train/callbacks/wandb_watch.py``.  ``wandb`` is
imported when training starts; without it the callback logs "wandb not
installed; WandbWatch is a no-op" and does nothing.  With it, every
``log_every_epochs`` epochs it logs the epoch's metrics and, for every
model tensor (``weights/<JAX path with "/">``), its histogram and norm
(``weights_norm/...``), and the histogram and norm of its change since the
last such epoch (``updates/...``, ``updates_norm/...``; the first against
the weights at the start of training).  The tensors are the module's
models' (the weights the step trains, as the JAX package reads its
``state.params``), the frozen ones included.
"""

from __future__ import annotations

import logging

import numpy as np

from .base import Callback


class WandbWatch(Callback):
    def __init__(self, project: str = "nequip-tpu", log_every_epochs: int = 1, watch_weights: bool = True,
                 watch_updates: bool = True, **init_kwargs):
        self.project = project
        self.init_kwargs = init_kwargs
        self.log_every_epochs = int(log_every_epochs)
        self.watch_weights = watch_weights
        self.watch_updates = watch_updates
        self._run = None
        self._prev = None

    @staticmethod
    def _leaves(module) -> dict:
        return {path.replace(".", "/"): t.detach().cpu().numpy().copy() for path, t in module.named_tensors()}

    @staticmethod
    def _histograms(leaves: dict, prefix: str) -> dict:
        import wandb

        logs = {}
        for name, arr in leaves.items():
            logs[f"{prefix}/{name}"] = wandb.Histogram(arr.reshape(-1))
            logs[f"{prefix}_norm/{name}"] = float(np.linalg.norm(arr))
        return logs

    def on_train_start(self, trainer, module) -> None:
        try:
            import wandb
        except ImportError:
            logging.getLogger("nequip_tpu_torch").warning("wandb not installed; WandbWatch is a no-op")
            return
        self._run = wandb.init(project=self.project, **self.init_kwargs)
        if self.watch_updates:
            self._prev = self._leaves(module)

    def on_train_epoch_end(self, trainer, module, epoch: int, metrics) -> None:
        if self._run is None:
            return
        logs = dict(metrics)
        if epoch % self.log_every_epochs == 0:
            leaves = self._leaves(module)
            if self.watch_weights:
                logs.update(self._histograms(leaves, "weights"))
            if self.watch_updates:
                if self._prev is not None:
                    logs.update(self._histograms({k: v - self._prev[k] for k, v in leaves.items() if k in self._prev},
                                                 "updates"))
                self._prev = leaves
        self._run.log(logs, step=epoch)
