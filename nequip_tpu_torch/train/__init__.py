"""Training: loss and metrics, EMA, the rr training modules and the trainer."""

from .ema import ema_update
from .metrics_manager import (
    EnergyForceLoss,
    EnergyForceMetrics,
    EnergyForceStressLoss,
    EnergyForceStressMetrics,
    MetricsManager,
)
from .trainer import Trainer
from .training_module import EMATrainModule, NequIPTrainModule

__all__ = [
    "EMATrainModule",
    "EnergyForceLoss",
    "EnergyForceMetrics",
    "EnergyForceStressLoss",
    "EnergyForceStressMetrics",
    "MetricsManager",
    "NequIPTrainModule",
    "Trainer",
    "ema_update",
]
