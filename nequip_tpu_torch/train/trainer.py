"""The training loop.

Port of ``nequip_tpu/train/trainer.py``: epochs of training steps over the
train loader, validation over every val loader after each epoch with
batch-size-invariant running metrics, one metric row per epoch
(``train_loss_epoch/*``, ``val<i>_epoch/*``, ``epoch``, ``global_step``,
``epoch_time``, ``padding_waste``) written to ``<ckpt_dir>/metrics.csv``.
Not ported yet: checkpoints and resume, LR schedulers, callbacks, step
limits, test and predict runs.

``step_seconds`` holds the host-clock time of every training step; each
step ends when its loss sums reach the host, so the time covers the
device work.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List

log = logging.getLogger("nequip_tpu_torch")


class Trainer:
    def __init__(self, max_epochs: int = 1, ckpt_dir: str = "checkpoints"):
        self.max_epochs = int(max_epochs)
        self.ckpt_dir = ckpt_dir
        self.epoch = 0
        self.global_step = 0
        self.step_seconds: List[float] = []
        self.metrics_rows: List[Dict[str, float]] = []

    def fit(self, module, datamodule) -> None:
        self.module = module
        datamodule.setup("fit")
        train_loader = datamodule.train_dataloader()
        val_loaders = datamodule.val_dataloaders()
        while self.epoch < self.max_epochs:
            epoch_t0 = time.time()
            module.loss_state = module.loss.init_state()
            n_batches = 0
            for batch in train_loader:
                t0 = time.perf_counter()
                module.training_step(batch)
                self.step_seconds.append(time.perf_counter() - t0)
                self.global_step += 1
                n_batches += 1
            metrics: Dict[str, float] = {}
            if n_batches:
                metrics.update({f"train_loss_epoch/{k}": v for k, v in module.loss.compute(module.loss_state).items()})
            metrics["padding_waste"] = train_loader.padding_waste()
            if val_loaders and module.val_metrics is not None:
                metrics.update(self._validation_metrics(val_loaders))
            metrics.update(epoch=self.epoch, global_step=self.global_step, epoch_time=time.time() - epoch_t0)
            self.metrics_rows.append(metrics)
            self._write_metrics_csv()
            self.epoch += 1
            log.info(f"epoch {self.epoch - 1} done in {metrics['epoch_time']:.1f}s")

    def _validation_metrics(self, loaders) -> Dict[str, float]:
        mgr = self.module.val_metrics
        out: Dict[str, float] = {}
        for i, loader in enumerate(loaders):
            state = mgr.init_state()
            for batch in loader:
                state, _ = self.module.evaluation_step(mgr, state, batch)
            out.update({f"val{i}_epoch/{k}": v for k, v in mgr.compute(state).items()})
        return out

    def validate(self, module, datamodule) -> Dict[str, float]:
        """Validation metrics of the module's evaluation model, as a row."""
        self.module = module
        datamodule.setup("validate")
        metrics = self._validation_metrics(datamodule.val_dataloaders())
        self.metrics_rows.append(metrics)
        self._write_metrics_csv()
        return metrics

    def _write_metrics_csv(self) -> None:
        os.makedirs(self.ckpt_dir, exist_ok=True)
        keys = sorted({k for row in self.metrics_rows for k in row})
        with open(os.path.join(self.ckpt_dir, "metrics.csv"), "w") as f:
            f.write(",".join(keys) + "\n")
            for row in self.metrics_rows:
                f.write(",".join(str(row.get(k, "")) for k in keys) + "\n")
