from .jax_params import flatten_tree, jax_named_grads, load_jax_params
from .nequip_models import FullNequIPGNNModel, NequIPGNNModel

__all__ = ["FullNequIPGNNModel", "NequIPGNNModel", "flatten_tree", "jax_named_grads", "load_jax_params"]
