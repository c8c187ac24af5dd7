"""Checkpoint save and load.

The port's own format (``torch.save`` of one dict), holding what the JAX
package's ``TrainState`` and checkpoint hold together:

* ``state``: the model's and the EMA model's tensors under their JAX dotted
  paths (``jax_named_tensors``: parameters and the frozen buffers), the
  optimizer's ``state_dict``, ``ema_step`` and the running loss sums;
* ``config``: the run's resolved config (the training module's
  ``hyperparameters()`` among it), enough to rebuild every object;
* ``meta``: the trainer's bookkeeping (epoch, global step, best monitored
  value, run index, loss coefficients, LR scale and scheduler state, loss
  manager, callback and dataloader states, the epoch's metrics).

Tensors are saved on the CPU, so a checkpoint loads on any device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

FORMAT_VERSION = 1


def format_version() -> int:
    return FORMAT_VERSION


def save_checkpoint(path: str, state: Dict[str, Any], config: Optional[dict] = None,
                    meta: Optional[dict] = None) -> None:
    torch.save({"format_version": FORMAT_VERSION, "state": state, "config": config or {}, "meta": meta or {}}, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    # the payload holds plain containers, numbers, numpy arrays and tensors
    payload = torch.load(path, map_location="cpu", weights_only=False)
    if payload.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"{path}: unknown checkpoint format {payload.get('format_version')!r}")
    return payload
