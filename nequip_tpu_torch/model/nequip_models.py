"""NequIP GNN model builders.

Port of ``nequip_tpu/model/nequip_models.py``: the same architecture and
arguments,

    type_embed -> spherical harmonics -> edge length norm -> Bessel encoding
    -> x(2*pi/r_max^2) -> N x ConvNetLayer -> scalar readout MLP
    -> per-type scale/shift -> per-frame sum -> ForceStressOutput

``tp_impl`` is ``"torch"`` (plain PyTorch) or ``"fused"`` (the CUDA
kernels).  Weights come from a seeded ``torch.Generator``; they differ from
the JAX package's initialisation, and ``model/jax_params.py`` loads a JAX
parameter tree instead.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Union

import torch

from ..data import _keys
from ..nn import (
    ApplyFactor,
    AtomwiseReduce,
    ConvNetLayer,
    ForceStressOutput,
    GraphModel,
    PerTypeScaleShift,
    ScalarMLP,
    SequentialGraphNetwork,
)
from ..nn.embedding import (
    BesselEdgeLengthEncoding,
    EdgeLengthNormalizer,
    NodeTypeEmbed,
    PolynomialCutoff,
    SphericalHarmonicEdgeAttrs,
)
from ..ops.irreps import Irrep, Irreps, MulIrrep
from ..utils.dtype import default_dtype


def NequIPGNNModel(
    seed: int,
    model_dtype: str,
    type_names: Sequence[str],
    num_layers: int = 4,
    l_max: int = 1,
    parity: bool = True,
    num_features: Union[int, List[int]] = 32,
    type_embed_num_features: Optional[int] = None,
    radial_mlp_depth: int = 1,
    radial_mlp_width: int = 128,
    **kwargs,
) -> GraphModel:
    """The standard NequIP energy(+forces/stress) model."""
    if num_layers <= 0:
        raise ValueError("num_layers must be positive")
    if isinstance(num_features, int):
        num_features = [num_features] * (l_max + 1)
    if len(num_features) != l_max + 1:
        raise ValueError(f"num_features must have l_max+1={l_max + 1} entries, got {num_features}")
    if type_embed_num_features is None:
        type_embed_num_features = num_features[0]
    hidden = Irreps(
        [
            MulIrrep(num_features[l], Irrep(l, p))
            for l in range(l_max + 1)
            for p in ((1, -1) if parity else ((1,) if l % 2 == 0 else (-1,)))
        ]
    )
    # the last conv layer outputs scalars only
    hidden_list = [hidden] * (num_layers - 1) + [Irreps([(num_features[0], (0, 1))])]
    return FullNequIPGNNModel(
        seed=seed,
        model_dtype=model_dtype,
        type_names=type_names,
        irreps_edge_sh=l_max,
        type_embed_num_features=type_embed_num_features,
        feature_irreps_hidden=hidden_list,
        radial_mlp_depth=[radial_mlp_depth] * num_layers,
        radial_mlp_width=[radial_mlp_width] * num_layers,
        **kwargs,
    )


def FullNequIPGNNModel(
    seed: int,
    model_dtype: str,
    type_names: Sequence[str],
    r_max: float,
    radial_mlp_depth: Sequence[int] = (1,),
    radial_mlp_width: Sequence[int] = (8,),
    feature_irreps_hidden: Sequence[Union[str, Irreps]] = ("32x0e",),
    irreps_edge_sh: Union[int, str, Irreps] = 1,
    type_embed_num_features: int = 32,
    readout_mlp_hidden_layers_depth: int = 0,
    readout_mlp_hidden_layers_width: Optional[int] = None,
    readout_mlp_nonlinearity: Optional[str] = "silu",
    per_edge_type_cutoff: Optional[Dict[str, Union[float, Dict[str, float]]]] = None,
    num_bessels: int = 8,
    polynomial_cutoff_p: int = 6,
    avg_num_neighbors: Optional[Union[float, Dict[str, float]]] = None,
    per_type_energy_scales: Optional[Union[float, Dict[str, float]]] = None,
    per_type_energy_shifts: Optional[Union[float, Dict[str, float]]] = None,
    do_derivatives: bool = True,
    convnet_sc: bool = True,
    convnet_resnet: bool = False,
    convnet_nonlinearity_scalars: Dict[str, str] = {"e": "silu", "o": "tanh"},
    convnet_nonlinearity_gates: Dict[str, str] = {"e": "silu", "o": "tanh"},
    tp_impl: str = "torch",
) -> GraphModel:
    """Fully explicit NequIP GNN builder (one config entry per layer)."""
    type_names = list(type_names)
    if not all(tn.isalnum() for tn in type_names):
        raise ValueError("type_names must be alphanumeric")
    if not len(radial_mlp_depth) == len(radial_mlp_width) == len(feature_irreps_hidden):
        raise ValueError("one radial MLP depth, width and hidden irreps per layer")
    num_layers = len(radial_mlp_depth)
    if not all(mi.ir.l == 0 for mi in Irreps(feature_irreps_hidden[-1])):
        raise ValueError("the last convnet layer must output scalars only")

    with default_dtype(model_dtype):
        type_embed = NodeTypeEmbed(type_names=type_names, num_features=type_embed_num_features)
        spharm = SphericalHarmonicEdgeAttrs(irreps_edge_sh=irreps_edge_sh, irreps_in=type_embed.irreps_out)
        edge_norm = EdgeLengthNormalizer(
            r_max=r_max, type_names=type_names, per_edge_type_cutoff=per_edge_type_cutoff,
            irreps_in=spharm.irreps_out,
        )
        bessel_encode = BesselEdgeLengthEncoding(
            cutoff=PolynomialCutoff(polynomial_cutoff_p), num_bessels=num_bessels,
            irreps_in=edge_norm.irreps_out,
        )
        factor = ApplyFactor(
            in_field=_keys.EDGE_EMBEDDING_KEY, factor=(2 * math.pi) / (r_max * r_max),
            irreps_in=bessel_encode.irreps_out,
        )
        modules = {
            "type_embed": type_embed,
            "spharm": spharm,
            "edge_norm": edge_norm,
            "bessel_encode": bessel_encode,
            "factor": factor,
        }
        prev = factor.irreps_out
        for i in range(num_layers):
            conv = ConvNetLayer(
                irreps_in=prev,
                feature_irreps_hidden=feature_irreps_hidden[i],
                convolution_kwargs={
                    "radial_mlp_depth": radial_mlp_depth[i],
                    "radial_mlp_width": radial_mlp_width[i],
                    # no self-connection on the first layer: the isolated-atom limit
                    "use_sc": i != 0 and convnet_sc,
                    "is_first_layer": i == 0,
                    "avg_num_neighbors": avg_num_neighbors,
                    "type_names": type_names,
                    "tp_impl": tp_impl,
                },
                resnet=i != 0 and convnet_resnet,
                nonlinearity_scalars=convnet_nonlinearity_scalars,
                nonlinearity_gates=convnet_nonlinearity_gates,
            )
            prev = conv.irreps_out
            modules[f"layer{i}_convnet"] = conv
        if readout_mlp_hidden_layers_width is None:
            readout_mlp_hidden_layers_width = Irreps(feature_irreps_hidden[-1]).dim
        modules["per_atom_energy_readout"] = ScalarMLP(
            output_dim=1,
            hidden_layers_depth=readout_mlp_hidden_layers_depth,
            hidden_layers_width=readout_mlp_hidden_layers_width,
            nonlinearity=readout_mlp_nonlinearity,
            field=_keys.NODE_FEATURES_KEY,
            out_field=_keys.PER_ATOM_ENERGY_KEY,
            irreps_in=prev,
        )
        modules["per_type_energy_scale_shift"] = PerTypeScaleShift(
            type_names=type_names,
            field=_keys.PER_ATOM_ENERGY_KEY,
            out_field=_keys.PER_ATOM_ENERGY_KEY,
            scales=per_type_energy_scales,
            shifts=per_type_energy_shifts,
            irreps_in=modules["per_atom_energy_readout"].irreps_out,
        )
        energy_model = SequentialGraphNetwork(modules)
        energy_model.append(
            "total_energy_sum",
            AtomwiseReduce(
                field=_keys.PER_ATOM_ENERGY_KEY, out_field=_keys.TOTAL_ENERGY_KEY,
                irreps_in=energy_model.irreps_out,
            ),
        )
        model = GraphModel(
            ForceStressOutput(energy_model, do_derivatives),
            type_names=type_names, r_max=r_max, per_edge_type_cutoff=per_edge_type_cutoff,
        )

    generator = torch.Generator().manual_seed(int(seed))
    for m in model.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
    model.model_config = {
        "seed": seed,
        "model_dtype": model_dtype,
        "type_names": type_names,
        "r_max": r_max,
        "tp_impl": tp_impl,
    }
    return model
