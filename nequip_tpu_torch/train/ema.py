"""Exponential moving average of parameters.

Port of ``nequip_tpu/train/ema.py``: warm-up corrected decay
``min(decay, (1 + n) / (10 + n))`` and the update
``ema += (1 - decay_eff) * (params - ema)``.  As in the JAX package the
effective decay is computed in float32.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch


@torch.no_grad()
def ema_update(ema_params: Iterable[torch.Tensor], params: Iterable[torch.Tensor], ema_step: int, decay: float) -> int:
    """One EMA step in place; returns the new step count."""
    n = np.float32(ema_step)
    w = float(np.float32(1.0) - np.minimum(np.float32(decay), (np.float32(1.0) + n) / (np.float32(10.0) + n)))
    for e, p in zip(ema_params, params):
        e.add_(p.to(e.dtype) - e, alpha=w)
    return ema_step + 1
