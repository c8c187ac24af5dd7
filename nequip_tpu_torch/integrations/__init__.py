from .batched import NequIPBatchedInference
from .calculator import NequIPCalculator
from .md import MDDriver, NoseHoover, VelocityVerlet, maxwell_boltzmann_velocities

__all__ = [
    "MDDriver",
    "NequIPBatchedInference",
    "NequIPCalculator",
    "NoseHoover",
    "VelocityVerlet",
    "maxwell_boltzmann_velocities",
]
