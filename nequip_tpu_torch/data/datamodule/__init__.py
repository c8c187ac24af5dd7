from .base import NequIPDataModule

__all__ = ["NequIPDataModule"]
