from .model_tests import BaseEnergyModelTests

__all__ = ["BaseEnergyModelTests"]
