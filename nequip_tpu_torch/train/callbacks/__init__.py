"""Training callbacks.  ``WandbWatch`` is not ported (``wandb`` is not
installed): building it raises."""

from .base import Callback
from .loss_coeff_monitor import LossCoefficientMonitor
from .loss_coeff_scheduler import LinearLossCoefficientScheduler, LossCoefficientScheduler
from .softadapt import SoftAdapt
from .tf32_scheduler import TF32Scheduler
from .training_stats import TrainingStatsMonitor
from .write_xyz import TestTimeXYZFileWriter



class WandbWatch(Callback):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("WandbWatch (train/callbacks/wandb_watch.py in the JAX package) is not ported yet")


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
