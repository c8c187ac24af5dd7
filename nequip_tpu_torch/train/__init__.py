"""Training: loss and metrics, EMA, LR schedulers, checkpoints, the rr and
fr training modules, the trainer and its callbacks.

The JAX package's ConFIG and schedule-free training modules are not ported
yet: their names raise ``NotImplementedError`` when a config builds them.
"""

from . import callbacks
from .checkpoint import format_version, load_checkpoint, save_checkpoint
from .ema import ema_update
from .lr_scheduler import (
    ChainedScheduler,
    ConstantLR,
    CosineAnnealingLR,
    ExponentialLR,
    LinearLR,
    LRScheduler,
    MultiStepLR,
    ReduceLROnPlateau,
    SequentialLR,
    StepLR,
    build_scheduler,
)
from .metrics_manager import (
    EnergyForceLoss,
    EnergyForceMetrics,
    EnergyForceStressLoss,
    EnergyForceStressMetrics,
    MetricsManager,
)
from .trainer import Trainer
from .training_module import EMATrainModule, NequIPTrainModule


def _not_ported(name: str, source: str):
    def build(*args, **kwargs):
        raise NotImplementedError(f"{name} ({source} in the JAX package) is not ported yet")

    build.__name__ = name
    return build


ConFIGTrainModule = _not_ported("ConFIGTrainModule", "train/config_module.py")
EMAConFIGTrainModule = _not_ported("EMAConFIGTrainModule", "train/config_module.py")
ScheduleFreeTrainModule = _not_ported("ScheduleFreeTrainModule", "train/schedulefree.py")

__all__ = [
    "ChainedScheduler",
    "ConFIGTrainModule",
    "ConstantLR",
    "CosineAnnealingLR",
    "EMAConFIGTrainModule",
    "EMATrainModule",
    "EnergyForceLoss",
    "EnergyForceMetrics",
    "EnergyForceStressLoss",
    "EnergyForceStressMetrics",
    "ExponentialLR",
    "LRScheduler",
    "LinearLR",
    "MetricsManager",
    "MultiStepLR",
    "NequIPTrainModule",
    "ReduceLROnPlateau",
    "ScheduleFreeTrainModule",
    "SequentialLR",
    "StepLR",
    "Trainer",
    "build_scheduler",
    "callbacks",
    "ema_update",
    "format_version",
    "load_checkpoint",
    "save_checkpoint",
]
