from .calculator import NequIPCalculator

__all__ = ["NequIPCalculator"]
