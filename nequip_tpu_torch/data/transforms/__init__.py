from .cell_utils import NonPeriodicCellTransform
from .dataset import DatasetIndexTransform
from .neighborlist import NeighborListPruneTransform, NeighborListTransform, SortedNeighborListTransform
from .stress_utils import AddNaNStressTransform, StressSignFlipTransform, VirialToStressTransform
from .type_mapper import ChemicalSpeciesToAtomTypeMapper

__all__ = [
    "AddNaNStressTransform",
    "ChemicalSpeciesToAtomTypeMapper",
    "DatasetIndexTransform",
    "NeighborListPruneTransform",
    "NeighborListTransform",
    "NonPeriodicCellTransform",
    "SortedNeighborListTransform",
    "StressSignFlipTransform",
    "VirialToStressTransform",
]
