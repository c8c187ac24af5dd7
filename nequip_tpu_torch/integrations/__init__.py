from .batched import NequIPBatchedInference
from .calculator import NequIPCalculator
from .md import MDDriver, NoseHoover, VelocityVerlet, maxwell_boltzmann_velocities
from .pair_style import NequIPPairStyleWrapper

__all__ = [
    "MDDriver",
    "NequIPBatchedInference",
    "NequIPCalculator",
    "NequIPPairStyleWrapper",
    "NoseHoover",
    "VelocityVerlet",
    "maxwell_boltzmann_velocities",
]
