"""Training: loss and metrics, EMA, LR schedulers (epoch and per-step),
optimizers (Adam, AdamW, SGD, Muon), checkpoints, the rr and fr training
modules, ConFIG and schedule-free, the trainer and its callbacks.
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
from .config_module import (
    ConFIGLightningModule,
    ConFIGTrainModule,
    EMAConFIGLightningModule,
    EMAConFIGTrainModule,
)
from .muon import muon, muon_adam, zeropower_via_newtonschulz5
from .schedulefree import ScheduleFreeLightningModule, ScheduleFreeTrainModule
from .trainer import Trainer
from .training_module import EMATrainModule, NequIPTrainModule

# the reference's class names
NequIPLightningModule = NequIPTrainModule
EMALightningModule = EMATrainModule

__all__ = [
    "ChainedScheduler",
    "ConFIGLightningModule",
    "ConFIGTrainModule",
    "ConstantLR",
    "CosineAnnealingLR",
    "EMAConFIGLightningModule",
    "EMAConFIGTrainModule",
    "EMALightningModule",
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
    "NequIPLightningModule",
    "NequIPTrainModule",
    "ReduceLROnPlateau",
    "ScheduleFreeLightningModule",
    "ScheduleFreeTrainModule",
    "SequentialLR",
    "StepLR",
    "Trainer",
    "build_scheduler",
    "callbacks",
    "ema_update",
    "format_version",
    "load_checkpoint",
    "muon",
    "muon_adam",
    "save_checkpoint",
    "zeropower_via_newtonschulz5",
]
