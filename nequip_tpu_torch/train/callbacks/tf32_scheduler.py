"""Switch TF32 matmuls on or off at given epochs (``set_tf32``).

Port of ``nequip_tpu/train/callbacks/tf32_scheduler.py``.
"""

from __future__ import annotations

from typing import Dict

from ...utils.global_state import set_tf32
from .base import Callback


class TF32Scheduler(Callback):
    """``schedule``: {epoch: bool}, e.g. fast matmuls early, strict later."""

    def __init__(self, schedule: Dict[int, bool]):
        self.schedule = {int(k): bool(v) for k, v in schedule.items()}

    def on_train_epoch_start(self, trainer, module, epoch: int) -> None:
        if epoch in self.schedule:
            set_tf32(self.schedule[epoch])
