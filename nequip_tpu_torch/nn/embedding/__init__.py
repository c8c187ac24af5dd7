from .edge import (
    BesselEdgeLengthEncoding,
    EdgeLengthNormalizer,
    PolynomialCutoff,
    SphericalHarmonicEdgeAttrs,
)
from .node import NodeTypeEmbed

__all__ = [
    "BesselEdgeLengthEncoding",
    "EdgeLengthNormalizer",
    "NodeTypeEmbed",
    "PolynomialCutoff",
    "SphericalHarmonicEdgeAttrs",
]
