from .ase import ASEDataModule
from .base import NequIPDataModule
from .named import (
    COLLDataModule,
    MD22DataModule,
    NequIP3BPADataModule,
    NPZSplitDataModule,
    SAMD23DataModule,
    TM23DataModule,
    WaterDataModule,
    rMD17DataModule,
    sGDML_CCSD_DataModule,
)

__all__ = [
    "ASEDataModule",
    "COLLDataModule",
    "MD22DataModule",
    "NPZSplitDataModule",
    "NequIP3BPADataModule",
    "NequIPDataModule",
    "SAMD23DataModule",
    "TM23DataModule",
    "WaterDataModule",
    "rMD17DataModule",
    "sGDML_CCSD_DataModule",
]
