"""Graph modules of the NequIP energy model (PyTorch)."""

from .atomwise import AtomwiseLinear, AtomwiseOperation, AtomwiseReduce, PerTypeScaleShift
from .convnetlayer import ConvNetLayer
from .grad_output import ForceStressOutput, PartialForceOutput
from .graph_model import GraphModel
from .interaction_block import InteractionBlock
from .misc import ApplyFactor, Concat, SaveForOutput
from .module import GraphModule, SequentialGraphNetwork, replace_submodules
from .scalar_mlp import ScalarMLP

__all__ = [
    "ApplyFactor",
    "AtomwiseLinear",
    "AtomwiseOperation",
    "AtomwiseReduce",
    "Concat",
    "ConvNetLayer",
    "ForceStressOutput",
    "GraphModel",
    "GraphModule",
    "InteractionBlock",
    "PartialForceOutput",
    "PerTypeScaleShift",
    "SaveForOutput",
    "ScalarMLP",
    "SequentialGraphNetwork",
    "replace_submodules",
]
