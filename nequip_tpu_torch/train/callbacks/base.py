"""Callback interface of the training loop: the hooks the trainer calls,
and state a checkpoint keeps.

Port of ``nequip_tpu/train/callbacks/base.py``.
"""

from __future__ import annotations

from typing import Any, Dict


class Callback:
    def on_train_start(self, trainer, module) -> None: ...

    def on_train_epoch_start(self, trainer, module, epoch: int) -> None: ...

    def on_train_batch_end(self, trainer, module, logs: Dict[str, Any], step: int) -> None: ...

    def on_train_epoch_end(self, trainer, module, epoch: int, metrics: Dict[str, float]) -> None: ...

    def on_validation_epoch_end(self, trainer, module, epoch: int, metrics: Dict[str, float]) -> None: ...

    def on_test_epoch_end(self, trainer, module, metrics: Dict[str, float]) -> None: ...

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None: ...
