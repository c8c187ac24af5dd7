"""The training loop.

Port of ``nequip_tpu/train/trainer.py``: epochs of training steps over the
train loader (up to ``max_epochs`` or ``max_steps``), validation over
every val loader every ``check_val_every_n_epoch`` epochs with
batch-size-invariant running metrics, one metric row per epoch
(``train_loss_epoch/*``, ``val<i>_epoch/*``, the scalars callbacks logged
during the previous epoch, ``epoch``, ``global_step``, ``epoch_time``,
``padding_waste``, ``lr_scale`` with an epoch LR scheduler) written to
``<ckpt_dir>/metrics.csv``, then ``last.ckpt`` and, when the monitored
metric improves, ``best.ckpt``.  ``fit(..., ckpt_path=)`` resumes from a
checkpoint at the same epoch, step, data position, loss coefficients, LR
scale and callback states, so a resumed run continues as the straight run
would.  ``validate``, ``test`` and ``predict`` run the module's
evaluation model, from a checkpoint with ``ckpt_path`` (``"best"`` is
``<ckpt_dir>/best.ckpt``).  The loss coefficients the step uses are the
trainer's float32 vector, which callbacks change through
``set_loss_coeffs``.

``devices > 1`` (or ``"auto"``: the world size) trains data-parallel over
the ranks of an initialised process group (``parallel.init_distributed``,
one process per device, e.g. under ``torchrun``), as the JAX trainer does
over a mesh: ``devices`` must equal the world size, every rank runs the
same loader, and ``parallel.DataParallel`` groups the micro-batches and
runs each step and evaluation with merged loss and metric sums and
all-reduced gradients, so every rank takes the global-batch step.  Under
an initialised process group (data parallel, or a 2-D
``parallel.SpatialTrainModule``) every rank runs ``fit``, which ends in a
barrier; only rank 0 writes checkpoints, ``metrics.csv`` and logs, and
every rank resumes from the same checkpoint.  Under data parallel the
model outputs stay on their ranks, so writer callbacks get none.

``step_seconds`` holds the host-clock time of every training step; each
step ends when its loss sums reach the host, so the time covers the
device work.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch.distributed as dist

from ..utils.config import instantiate
from .checkpoint import load_checkpoint, save_checkpoint
from .metrics_manager import MetricsManager

log = logging.getLogger("nequip_tpu_torch")


class Trainer:
    def __init__(
        self,
        max_epochs: int = 1,
        max_steps: Optional[int] = None,
        callbacks: Optional[List] = None,
        ckpt_dir: str = "checkpoints",
        check_val_every_n_epoch: int = 1,
        log_every_n_steps: int = 50,
        monitor: str = "val0_epoch/weighted_sum",
        monitor_mode: str = "min",
        save_last: bool = True,
        save_best: bool = True,
        devices: Optional[int] = None,
    ):
        self.devices = devices
        if monitor_mode not in ("min", "max"):
            raise ValueError(f"monitor_mode must be 'min' or 'max', got {monitor_mode!r}")
        self.max_epochs = int(max_epochs)
        self.max_steps = max_steps
        self.callbacks = [instantiate(c) if isinstance(c, dict) else c for c in (callbacks or [])]
        self.ckpt_dir = ckpt_dir
        self.check_val_every_n_epoch = int(check_val_every_n_epoch)
        self.log_every_n_steps = int(log_every_n_steps)
        self.monitor = monitor
        self.monitor_mode = monitor_mode
        self.save_last = save_last
        self.save_best = save_best

        self.epoch = 0
        self.global_step = 0
        self.best_monitor: Optional[float] = None
        self.info_dict: Dict[str, Any] = {}  # the run's config, set by the CLI
        self.run_index = 0
        self.step_seconds: List[float] = []
        self.metrics_rows: List[Dict[str, float]] = []
        self.loaded_ckpt_path: Optional[str] = None  # the checkpoint the last standalone run read
        self._scalars: Dict[str, float] = {}
        self._lr_scale = np.float32(1.0)
        self._loss_coeffs: Optional[np.ndarray] = None
        self._dp = None

    # --- loss coefficients and scalars (for callbacks) ---------------------
    def set_loss_coeffs(self, coeffs: Dict[str, float]) -> None:
        mgr: MetricsManager = self.module.loss
        total = sum(coeffs.values())
        vec = np.array(self._loss_coeffs, dtype=np.float32)
        for i, e in enumerate(mgr.entries):
            if e["name"] in coeffs:
                vec[i] = coeffs[e["name"]] / total if total else 0.0
        self._loss_coeffs = vec
        mgr.set_coeffs({
            e["name"]: float(vec[i]) if vec[i] or mgr.coeffs[e["name"]] is not None else None
            for i, e in enumerate(mgr.entries)
        })

    def current_loss_coeffs(self) -> Dict[str, float]:
        return {e["name"]: float(self._loss_coeffs[i]) for i, e in enumerate(self.module.loss.entries)}

    def log_scalar(self, name: str, value: float) -> None:
        self._scalars[name] = value

    # --- data parallel -----------------------------------------------------
    def _n_devices(self) -> int:
        """The data-parallel width ``devices`` asks for (``"auto"``: the world size)."""
        from ..parallel.mesh import device_count

        if self.devices in (None, 1, "1"):
            return 1
        return device_count() if self.devices == "auto" else int(self.devices)

    def _setup_data_parallel(self, module) -> None:
        from ..parallel.mesh import device_count, make_mesh

        n = self._n_devices()
        if n == 1:
            self._dp = None
            return
        if n != device_count():
            raise ValueError(
                f"trainer.devices={self.devices!r} asks for {n} data-parallel ranks but the process group has "
                f"{device_count()}: start one process per device (torchrun --nproc-per-node {n}) and call "
                "nequip_tpu_torch.parallel.init_distributed() before building the trainer"
            )
        from ..parallel.dp import DataParallel

        self._dp = DataParallel(module, make_mesh((n,), ("dp",)))
        self._log(f"data-parallel training over {n} ranks")

    def _batches(self, loader):
        """The loader's batches, or this rank's micro-batch of each group under data parallel."""
        return loader if self._dp is None else self._dp.group_batches(iter(loader))

    def _training_step(self, batch):
        if self._dp is not None:
            return self._dp.training_step(batch, self._loss_coeffs)
        return self.module.training_step(batch, self._loss_coeffs)

    @property
    def is_global_zero(self) -> bool:
        """Whether this process writes (rank 0, or the only process)."""
        return not dist.is_initialized() or dist.get_rank() == 0

    def _log(self, msg: str) -> None:
        if self.is_global_zero:
            log.info(msg)

    # --- fit ---------------------------------------------------------------
    def fit(self, module, datamodule, ckpt_path: Optional[str] = None) -> None:
        if module.loss is None:
            raise ValueError("training needs a loss")
        self.module = module
        self.datamodule = datamodule
        datamodule.setup("fit")
        train_loader = datamodule.train_dataloader()
        val_loaders = datamodule.val_dataloaders()
        self._loss_coeffs = np.asarray(module.loss.coeff_vector(), dtype=np.float32)
        self._setup_data_parallel(module)

        if ckpt_path is not None:
            self._resume(load_checkpoint(ckpt_path), train_loader)
            self._log(f"resumed from {ckpt_path} at epoch {self.epoch}")
        module.set_lr_scale(self._lr_scale)
        for cb in self.callbacks:
            cb.on_train_start(self, module)

        while self.epoch < self.max_epochs:
            if self.max_steps is not None and self.global_step >= self.max_steps:
                break
            epoch_t0 = time.time()
            for cb in self.callbacks:
                cb.on_train_epoch_start(self, module, self.epoch)
            module.loss_state = module.loss.init_state()
            n_batches = 0
            for batch in self._batches(train_loader):
                t0 = time.perf_counter()
                logs = self._training_step(batch)
                self.step_seconds.append(time.perf_counter() - t0)
                self.global_step += 1
                n_batches += 1
                if self.global_step % self.log_every_n_steps == 0:
                    self._log(f"epoch {self.epoch} step {self.global_step} "
                              f"loss {float(logs['train_loss_step/weighted_sum']):.6f}")
                host_logs = None
                for cb in self.callbacks:
                    if hasattr(cb, "on_train_batch_end"):
                        if host_logs is None:
                            host_logs = {k: float(v) for k, v in logs.items()}
                        cb.on_train_batch_end(self, module, host_logs, self.global_step)
                if self.max_steps is not None and self.global_step >= self.max_steps:
                    break

            metrics: Dict[str, float] = {}
            if n_batches:
                metrics.update({f"train_loss_epoch/{k}": v for k, v in module.loss.compute(module.loss_state).items()})
            if hasattr(train_loader, "padding_waste"):
                metrics["padding_waste"] = train_loader.padding_waste()
            if val_loaders and module.val_metrics is not None and (self.epoch + 1) % self.check_val_every_n_epoch == 0:
                metrics.update(self._run_eval("val", val_loaders))
            metrics.update(self._scalars)
            self._scalars = {}
            metrics.update(epoch=self.epoch, global_step=self.global_step, epoch_time=time.time() - epoch_t0)
            self.metrics_rows.append(metrics)
            self._write_metrics_csv()

            for cb in self.callbacks:
                cb.on_train_epoch_end(self, module, self.epoch, metrics)
                cb.on_validation_epoch_end(self, module, self.epoch, metrics)

            new_scale = module.lr_scheduler_epoch_end(self.epoch, metrics)
            if new_scale is not None:
                if float(new_scale) != float(self._lr_scale):
                    self._log(f"lr scale -> {float(new_scale):.3e}")
                self._lr_scale = np.float32(new_scale)
                module.set_lr_scale(self._lr_scale)
                metrics["lr_scale"] = float(new_scale)

            self.epoch += 1
            self._checkpoint(metrics)
            mon = metrics.get(self.monitor)
            self._log(f"epoch {self.epoch - 1} done in {metrics['epoch_time']:.1f}s"
                      + (f"; {self.monitor}={mon:.6f}" if mon is not None else ""))
        if dist.is_initialized():
            dist.barrier()  # rank 0's checkpoints are written before any rank reads them

    def _resume(self, payload: dict, train_loader) -> None:
        module = self.module
        module.load_state_dict(payload["state"])
        meta = payload["meta"]
        self.epoch = int(meta.get("epoch", 0))
        self.global_step = int(meta.get("global_step", 0))
        self.best_monitor = meta.get("best_monitor")
        self.run_index = int(meta.get("run_index", 0))
        if meta.get("loss_coeffs") is not None:
            self._loss_coeffs = np.asarray(meta["loss_coeffs"], dtype=np.float32)
        if meta.get("lr_scale") is not None:
            self._lr_scale = np.float32(meta["lr_scale"])
        if meta.get("lr_scheduler_state") is not None and module.lr_scheduler_obj is not None:
            module.lr_scheduler_obj.load_state_dict(meta["lr_scheduler_state"])
        if meta.get("loss_manager_state") is not None:
            module.loss.load_state_dict(meta["loss_manager_state"])
        for cb, sd in zip(self.callbacks, meta.get("callback_states", [])):
            cb.load_state_dict(sd)
        if meta.get("dataloader_state") is not None:
            train_loader.load_state_dict(meta["dataloader_state"])

    # --- evaluation --------------------------------------------------------
    def _run_eval(self, stage: str, loaders) -> Dict[str, float]:
        module = self.module
        mgr = module.val_metrics if stage == "val" else module.test_metrics
        writers = [cb for cb in self.callbacks if hasattr(cb, "on_eval_batch")] if stage == "test" else []
        out_metrics: Dict[str, float] = {}
        for i, loader in enumerate(loaders):
            state = mgr.init_state()
            for batch in self._batches(loader):
                if self._dp is not None:
                    state, out = self._dp.evaluation_step(mgr, state, batch)
                else:
                    state, out = module.evaluation_step(mgr, state, batch)
                for cb in writers if out is not None else ():
                    cb.on_eval_batch(out, batch)
            out_metrics.update({f"{stage}{i}_epoch/{k}": v for k, v in mgr.compute(state).items()})
        return out_metrics

    def _load_for_eval(self, module, ckpt_path: Optional[str]) -> None:
        if ckpt_path is None:
            return
        if ckpt_path == "best":
            ckpt_path = os.path.join(self.ckpt_dir, "best.ckpt")
        module.load_state_dict(load_checkpoint(ckpt_path)["state"])
        self.loaded_ckpt_path = ckpt_path

    def validate(self, module, datamodule, ckpt_path: Optional[str] = None) -> Dict[str, float]:
        return self._standalone_eval("val", module, datamodule, ckpt_path)

    def test(self, module, datamodule, ckpt_path: Optional[str] = None) -> Dict[str, float]:
        return self._standalone_eval("test", module, datamodule, ckpt_path)

    def _standalone_eval(self, stage, module, datamodule, ckpt_path) -> Dict[str, float]:
        self.module = module
        self._setup_data_parallel(module)
        datamodule.setup(stage)
        loaders = datamodule.val_dataloaders() if stage == "val" else datamodule.test_dataloaders()
        self._load_for_eval(module, ckpt_path)
        metrics = self._run_eval(stage, loaders)
        if stage == "test":
            for cb in self.callbacks:
                cb.on_test_epoch_end(self, module, metrics)
        for k, v in sorted(metrics.items()):
            self._log(f"{k}: {v:.6f}")
        self.metrics_rows.append(metrics)
        self._write_metrics_csv()
        return metrics

    def predict(self, module, datamodule, ckpt_path: Optional[str] = None) -> List[dict]:
        """The evaluation model's outputs on every predict batch (the test
        batches without a predict split), fed to XYZ-writer callbacks."""
        self.module = module
        datamodule.setup("predict")
        loaders = datamodule.predict_dataloaders() or datamodule.test_dataloaders()
        self._load_for_eval(module, ckpt_path)
        writers = [cb for cb in self.callbacks if hasattr(cb, "on_eval_batch")]
        outputs = []
        for loader in loaders:
            for batch in loader:
                out = module.predict_step(batch)
                for cb in writers:
                    cb.on_eval_batch(out, batch)
                outputs.append(out)
        for cb in self.callbacks:
            cb.on_test_epoch_end(self, module, {})
        return outputs

    # --- checkpoints and metrics.csv ---------------------------------------
    def _checkpoint(self, metrics: Dict[str, float]) -> None:
        if not (self.save_last or self.save_best) or not self.is_global_zero:
            return
        os.makedirs(self.ckpt_dir, exist_ok=True)
        module = self.module
        meta = {
            "epoch": self.epoch,
            "global_step": self.global_step,
            "best_monitor": self.best_monitor,
            "run_index": self.run_index,
            "loss_coeffs": self._loss_coeffs.tolist(),
            "lr_scale": float(self._lr_scale),
            "lr_scheduler_state": module.lr_scheduler_obj.state_dict() if module.lr_scheduler_obj is not None else None,
            "loss_manager_state": module.loss.state_dict(),
            "callback_states": [cb.state_dict() for cb in self.callbacks],
            "dataloader_state": self.datamodule.train_dataloader().state_dict(),
            "metrics": dict(metrics),
        }
        config = dict(self.info_dict)
        config.setdefault("training_module", module.hyperparameters())
        state = module.state_dict()
        if self.save_last:
            save_checkpoint(os.path.join(self.ckpt_dir, "last.ckpt"), state, config, meta)
        mon = metrics.get(self.monitor)
        if self.save_best and mon is not None:
            if (self.best_monitor is None or (self.monitor_mode == "min" and mon < self.best_monitor)
                    or (self.monitor_mode == "max" and mon > self.best_monitor)):
                self.best_monitor = float(mon)
                meta["best_monitor"] = self.best_monitor
                save_checkpoint(os.path.join(self.ckpt_dir, "best.ckpt"), state, config, meta)

    def _write_metrics_csv(self) -> None:
        if not self.is_global_zero:
            return
        os.makedirs(self.ckpt_dir, exist_ok=True)
        keys = sorted({k for row in self.metrics_rows for k in row})
        with open(os.path.join(self.ckpt_dir, "metrics.csv"), "w") as f:
            f.write(",".join(keys) + "\n")
            for row in self.metrics_rows:
                f.write(",".join(str(row.get(k, "")) for k in keys) + "\n")
