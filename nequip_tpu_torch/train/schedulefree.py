"""Schedule-free training (Defazio et al., arXiv:2405.15682).

Port of ``nequip_tpu/train/schedulefree.py`` and of optax's
``contrib.schedule_free`` / ``schedule_free_eval_params``.  The model holds
``y``, where gradients are taken; the module keeps ``z``, ``weight_sum``,
``step_count`` (1 at the first update), ``max_lr`` and the base optimizer's
state.  One update, after the base optimizer (the module's ``optimizer``
config, e.g. ``optax.adam``) has stepped ``y`` by ``u``:

    lr = linear_schedule(0, learning_rate, warmup_steps)(step_count)   # or learning_rate
    max_lr = max(max_lr, lr); weight_sum += max_lr**2
    ck = max_lr**2 / weight_sum                                          # optax's NaN rules
    z' = z + u;  x = (1 - ck) * (y - (1 - b1) z) / b1 + ck * z'
    y <- y + (b1 x + (1 - b1) z' - y) * epoch LR scale

so the epoch LR scale multiplies the final ``y`` update, not the base
rate.  Evaluation (validation, test, predict, and a checkpoint's
``eval_params``, which ``ModelFromCheckpoint`` reads) runs ``x = (y - (1 -
b1) z) / b1``: ``evaluation_model()`` is a copy of the model holding it.

The base optimizer may be any the base module takes (``optim.py``); it
reads the step's loss where it needs it (``polyak_sgd``,
``reduce_on_plateau``), as optax's ``schedule_free`` hands its extra
arguments on.  The base module's clip and per-step schedule act on the base updates
(inside schedule-free), over the trainable parameters.  The JAX module
applies them, inside, only when its model has frozen leaves, and wraps the
bare base optimizer otherwise.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Dict

import torch

from .schedules import linear_schedule
from .training_module import NequIPTrainModule, named_tensors_cpu


class ScheduleFreeTrainModule(NequIPTrainModule):
    """``optimizer`` is the base optimizer; ``learning_rate`` and
    ``warmup_steps`` make schedule-free's own rate, which weighs the
    average."""

    def __init__(self, *args, warmup_steps: int = 0, sf_b1: float = 0.9, learning_rate: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.warmup_steps = int(warmup_steps)
        self.sf_b1 = float(sf_b1)
        self.learning_rate = float(learning_rate)
        self._sf_lr = (linear_schedule(0.0, self.learning_rate, self.warmup_steps) if self.warmup_steps > 0
                       else lambda count: self.learning_rate)
        self.z = None  # the first update starts it at y
        self.weight_sum, self.step_count, self.max_lr = 0.0, 1, 0.0
        self.eval_model = copy.deepcopy(self.model).requires_grad_(False)
        self._eval_stale = True

    def _rate_factor(self) -> float:
        # the epoch scale multiplies the y update instead (_optimizer_step)
        return 1.0 if self._step_schedule is None else float(self._step_schedule(self.update_count))

    @torch.no_grad()
    def _optimizer_step(self, loss=None) -> None:
        params = [p for _, p in self.named_trainable()]
        y = [p.detach().clone() for p in params]
        if self.z is None:
            self.z = [t.clone() for t in y]
        super()._optimizer_step(loss)  # p = y + u
        lr = float(self._sf_lr(self.step_count))
        max_lr = max(self.max_lr, lr)
        weight = max_lr**2
        total = self.weight_sum + weight
        if math.isnan(weight) or math.isnan(total):
            ck = math.nan
        else:
            ck = weight / total if total else 0.0
        b1, scale = self.sf_b1, self._lr_scale
        for p, yi, zi in zip(params, y, self.z):
            z_new = zi + (p - yi)
            x = (1.0 - ck) * ((yi - (1.0 - b1) * zi) / b1) + ck * z_new
            p.copy_(yi + (b1 * x + (1.0 - b1) * z_new - yi) * scale)
            zi.copy_(z_new)
        self.max_lr, self.weight_sum, self.step_count = max_lr, total, self.step_count + 1
        self._eval_stale = True

    @torch.no_grad()
    def evaluation_model(self) -> torch.nn.Module:
        """A copy of the model holding the evaluation parameters ``x``."""
        if self._eval_stale:
            target = dict(self.eval_model.jax_named_tensors())
            for path, t in self.model.jax_named_tensors():
                target[path].copy_(t)
            b1 = self.sf_b1
            zs = self.z or [p for _, p in self.named_trainable()]
            for (path, p), zi in zip(self.named_trainable(), zs):
                target[path].copy_((p - (1.0 - b1) * zi) / b1)
            self._eval_stale = False
        return self.eval_model

    def hyperparameters(self) -> dict:
        return {**super().hyperparameters(), "warmup_steps": self.warmup_steps, "sf_b1": self.sf_b1,
                "learning_rate": self.learning_rate}

    def state_dict(self) -> Dict[str, Any]:
        names = [k for k, _ in self.named_trainable()]
        return {
            **super().state_dict(),
            "schedule_free": {
                "z": None if self.z is None else {k: z.detach().to("cpu", copy=True) for k, z in zip(names, self.z)},
                "weight_sum": self.weight_sum, "step_count": self.step_count, "max_lr": self.max_lr,
            },
            "eval_params": named_tensors_cpu(self.evaluation_model()),
        }

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        super().load_state_dict(sd)
        sf = sd["schedule_free"]
        if sf["z"] is None:
            self.z = None
        else:
            self.z = [sf["z"][k].to(device=p.device, dtype=p.dtype) for k, p in self.named_trainable()]
        self.weight_sum, self.step_count, self.max_lr = float(sf["weight_sum"]), int(sf["step_count"]), float(sf["max_lr"])
        self._eval_stale = True


ScheduleFreeLightningModule = ScheduleFreeTrainModule
