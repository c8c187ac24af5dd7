from .jax_params import load_jax_params
from .nequip_models import FullNequIPGNNModel, NequIPGNNModel

__all__ = ["FullNequIPGNNModel", "NequIPGNNModel", "load_jax_params"]
