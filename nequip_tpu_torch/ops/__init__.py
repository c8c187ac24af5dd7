"""Irreps algebra, SH/CG constants and plain-PyTorch equivariant ops."""

from .irreps import Irrep, Irreps, MulIrrep
from .linear import Linear
from .tensor_product import TensorProduct, fully_connected_tensor_product, uvu_instructions

__all__ = [
    "Irrep",
    "Irreps",
    "Linear",
    "MulIrrep",
    "TensorProduct",
    "fully_connected_tensor_product",
    "uvu_instructions",
]
