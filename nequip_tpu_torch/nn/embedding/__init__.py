from .edge import (
    AddRadialCutoffToData,
    BesselEdgeLengthEncoding,
    EdgeLengthNormalizer,
    PolynomialCutoff,
    SphericalHarmonicEdgeAttrs,
)
from .node import NodeTypeEmbed
from .node_tensor import AppendVectorFieldEmbed
from .utils import cutoff_dict_to_matrix, cutoff_matrix_to_dict

__all__ = [
    "AddRadialCutoffToData",
    "AppendVectorFieldEmbed",
    "BesselEdgeLengthEncoding",
    "EdgeLengthNormalizer",
    "NodeTypeEmbed",
    "PolynomialCutoff",
    "SphericalHarmonicEdgeAttrs",
    "cutoff_dict_to_matrix",
    "cutoff_matrix_to_dict",
]
