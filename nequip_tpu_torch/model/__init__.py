from .inference_models import CompiledModel, load_compiled_model, save_compiled_model, validate_artifact
from .jax_params import flatten_tree, jax_named_grads, jax_params_tree, load_jax_params
from .modify_utils import modify
from .nequip_models import FullNequIPGNNModel, NequIPGNNModel, PresetNequIPGNNModel
from .pair_potential import ZBLPairPotential
from .saved_models import ModelFromCheckpoint, ModelFromPackage, data_dict_from_checkpoint, load_saved_model
from .utils import init_weights, model_builder

__all__ = [
    "CompiledModel",
    "FullNequIPGNNModel",
    "ModelFromCheckpoint",
    "ModelFromPackage",
    "NequIPGNNModel",
    "PresetNequIPGNNModel",
    "data_dict_from_checkpoint",
    "flatten_tree",
    "init_weights",
    "jax_named_grads",
    "jax_params_tree",
    "load_compiled_model",
    "load_jax_params",
    "load_saved_model",
    "model_builder",
    "modify",
    "save_compiled_model",
    "validate_artifact",
    "ZBLPairPotential",
]
