"""Graph modules of the NequIP energy model (PyTorch)."""

from .atomwise import AtomwiseReduce, PerTypeScaleShift
from .convnetlayer import ConvNetLayer
from .grad_output import ForceStressOutput
from .graph_model import GraphModel
from .interaction_block import InteractionBlock
from .misc import ApplyFactor
from .module import GraphModule, SequentialGraphNetwork
from .scalar_mlp import ScalarMLP

__all__ = [
    "ApplyFactor",
    "AtomwiseReduce",
    "ConvNetLayer",
    "ForceStressOutput",
    "GraphModel",
    "GraphModule",
    "InteractionBlock",
    "PerTypeScaleShift",
    "ScalarMLP",
    "SequentialGraphNetwork",
]
