"""Training callbacks (the JAX package's ``train/callbacks``)."""

from .base import Callback
from .loss_coeff_monitor import LossCoefficientMonitor
from .loss_coeff_scheduler import LinearLossCoefficientScheduler, LossCoefficientScheduler
from .softadapt import SoftAdapt
from .tf32_scheduler import TF32Scheduler
from .training_stats import TrainingStatsMonitor
from .wandb_watch import WandbWatch
from .write_xyz import TestTimeXYZFileWriter


__all__ = [
    "Callback",
    "LinearLossCoefficientScheduler",
    "LossCoefficientMonitor",
    "LossCoefficientScheduler",
    "SoftAdapt",
    "TF32Scheduler",
    "TestTimeXYZFileWriter",
    "TrainingStatsMonitor",
    "WandbWatch",
]
