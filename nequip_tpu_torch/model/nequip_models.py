"""NequIP GNN model builders.

Port of ``nequip_tpu/model/nequip_models.py``: the same architecture and
arguments,

    type_embed -> spherical harmonics -> edge length norm -> Bessel encoding
    -> x(2*pi/r_max^2) -> N x ConvNetLayer -> scalar readout MLP
    -> per-type scale/shift -> [pair potential] -> per-frame sum -> ForceStressOutput

``tp_impl`` is ``"torch"`` (plain PyTorch, JAX ``"xla"``), ``"fused"``
(the fused CUDA kernels with the radial MLP inside, JAX ``"pallas_fused"``)
or ``"fused_tp"`` (the trilinear CUDA kernels after a plain radial MLP, JAX
``"pallas"``).  Both builders are ``@model_builder``s (``model/utils.py``): weights come
from a seeded ``torch.Generator`` (they differ from the JAX package's
initialisation; ``model/jax_params.py`` loads a JAX parameter tree instead),
and ``model.model_config`` rebuilds the model through
``utils.config.instantiate``.  ``PresetNequIPGNNModel`` builds the S, M, L
and XL size presets of the JAX package.

Every keyword of the JAX builders is taken: the categorical graph-field
embeddings, trainable Bessel frequencies and per-type scales and shifts
(parameters at the JAX tree's paths, frozen buffers otherwise),
``learnable_shift`` (the first layer keeps its self-connection and
resnet), the norm nonlinearity (``convnet_nonlinearity_type="norm"``),
``remat_conv`` (``torch.utils.checkpoint``, see ``nn/convnetlayer.py``)
and ``remat_force`` (accepted and recorded; the force branch runs as
without it, see ``nn/grad_output.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Union

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
from ..utils.config import instantiate
from .utils import model_builder

_NEQUIP_GNN_PRESETS = {
    "S": {"num_layers": 2, "l_max": 1, "num_features": [128, 64]},
    "M": {"num_layers": 4, "l_max": 2, "num_features": [128, 64, 32]},
    "L": {"num_layers": 6, "l_max": 3, "num_features": [128, 64, 32, 32]},
    "XL": {"num_layers": 6, "l_max": 4, "num_features": [320, 96, 64, 32, 32]},
}
_NEQUIP_GNN_STANDARD_PRESET = {
    "parity": False,
    "type_embed_num_features": 32,
    "radial_mlp_depth": 1,
    "radial_mlp_width": 128,
}


@model_builder
def PresetNequIPGNNModel(preset: str, type_names: Sequence[str] = None, **kwargs) -> GraphModel:
    """``NequIPGNNModel`` at a named size preset (S, M, L or XL); keywords
    override the preset's."""
    preset = preset.upper()
    if preset not in _NEQUIP_GNN_PRESETS:
        raise ValueError(f"preset must be one of {list(_NEQUIP_GNN_PRESETS)}, got {preset!r}")
    return NequIPGNNModel(type_names=type_names,
                          **{**_NEQUIP_GNN_STANDARD_PRESET, **_NEQUIP_GNN_PRESETS[preset], **kwargs})


@model_builder
def NequIPGNNModel(
    num_layers: int = 4,
    l_max: int = 1,
    parity: bool = True,
    num_features: Union[int, List[int]] = 32,
    type_embed_num_features: Optional[int] = None,
    radial_mlp_depth: int = 1,
    radial_mlp_width: int = 128,
    type_names: Sequence[str] = None,
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
        type_names=type_names,
        irreps_edge_sh=l_max,
        type_embed_num_features=type_embed_num_features,
        feature_irreps_hidden=hidden_list,
        radial_mlp_depth=[radial_mlp_depth] * num_layers,
        radial_mlp_width=[radial_mlp_width] * num_layers,
        **kwargs,
    )


@model_builder
def FullNequIPGNNModel(
    r_max: float,
    type_names: Sequence[str] = None,
    radial_mlp_depth: Sequence[int] = (1,),
    radial_mlp_width: Sequence[int] = (8,),
    feature_irreps_hidden: Sequence[Union[str, Irreps]] = ("32x0e",),
    irreps_edge_sh: Union[int, str, Irreps] = 1,
    type_embed_num_features: int = 32,
    categorical_graph_field_embed: Optional[List[Dict]] = None,
    readout_mlp_hidden_layers_depth: int = 0,
    readout_mlp_hidden_layers_width: Optional[int] = None,
    readout_mlp_nonlinearity: Optional[str] = "silu",
    per_edge_type_cutoff: Optional[Dict[str, Union[float, Dict[str, float]]]] = None,
    num_bessels: int = 8,
    bessel_trainable: bool = False,
    polynomial_cutoff_p: int = 6,
    avg_num_neighbors: Optional[Union[float, Dict[str, float]]] = None,
    per_type_energy_scales: Optional[Union[float, Dict[str, float]]] = None,
    per_type_energy_shifts: Optional[Union[float, Dict[str, float]]] = None,
    per_type_energy_scales_trainable: bool = False,
    per_type_energy_shifts_trainable: bool = False,
    do_derivatives: bool = True,
    convnet_sc: bool = True,
    learnable_shift: bool = False,
    convnet_resnet: bool = False,
    convnet_nonlinearity_type: str = "gate",
    convnet_nonlinearity_scalars: Dict[str, str] = {"e": "silu", "o": "tanh"},
    convnet_nonlinearity_gates: Dict[str, str] = {"e": "silu", "o": "tanh"},
    tp_impl: str = "torch",
    remat_conv: Union[bool, str] = False,
    remat_force: bool = False,
    pair_potential: Optional[dict] = None,
) -> GraphModel:
    """Fully explicit NequIP GNN builder (one config entry per layer).

    ``pair_potential``: a ``_target_`` config of a pair potential
    (``nn.pair_potential.ZBL`` or ``LennardJones``), added to the per-atom
    energy before the frame sum."""
    type_names = list(type_names)
    if not all(tn.isalnum() for tn in type_names):
        raise ValueError("type_names must be alphanumeric")
    if not len(radial_mlp_depth) == len(radial_mlp_width) == len(feature_irreps_hidden):
        raise ValueError("one radial MLP depth, width and hidden irreps per layer")
    if learnable_shift and not (convnet_sc or convnet_resnet):
        raise ValueError("learnable_shift needs convnet_sc or convnet_resnet")
    num_layers = len(radial_mlp_depth)
    if not all(mi.ir.l == 0 for mi in Irreps(feature_irreps_hidden[-1])):
        raise ValueError("the last convnet layer must output scalars only")

    type_embed = NodeTypeEmbed(type_names=type_names, num_features=type_embed_num_features,
                               categorical_graph_field_embed=categorical_graph_field_embed)
    spharm = SphericalHarmonicEdgeAttrs(irreps_edge_sh=irreps_edge_sh, irreps_in=type_embed.irreps_out)
    edge_norm = EdgeLengthNormalizer(
        r_max=r_max, type_names=type_names, per_edge_type_cutoff=per_edge_type_cutoff,
        irreps_in=spharm.irreps_out,
    )
    bessel_encode = BesselEdgeLengthEncoding(
        cutoff=PolynomialCutoff(polynomial_cutoff_p), num_bessels=num_bessels, trainable=bessel_trainable,
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
                # no self-connection on the first layer (the isolated-atom
                # limit), unless the shift is learned through it
                "use_sc": convnet_sc if learnable_shift else i != 0 and convnet_sc,
                "is_first_layer": i == 0,
                "avg_num_neighbors": avg_num_neighbors,
                "type_names": type_names,
                "tp_impl": tp_impl,
            },
            resnet=convnet_resnet if learnable_shift else i != 0 and convnet_resnet,
            remat=remat_conv,
            nonlinearity_type=convnet_nonlinearity_type,
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
        bias=False,
        forward_weight_init=True,
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
        scales_trainable=per_type_energy_scales_trainable,
        shifts_trainable=per_type_energy_shifts_trainable,
        irreps_in=modules["per_atom_energy_readout"].irreps_out,
    )
    energy_model = SequentialGraphNetwork(modules)
    if pair_potential is not None:
        energy_model.append(
            "pair_potential", instantiate(pair_potential, type_names=type_names, irreps_in=energy_model.irreps_out)
        )
    energy_model.append(
        "total_energy_sum",
        AtomwiseReduce(
            field=_keys.PER_ATOM_ENERGY_KEY, out_field=_keys.TOTAL_ENERGY_KEY,
            irreps_in=energy_model.irreps_out,
        ),
    )
    model = GraphModel(
        ForceStressOutput(energy_model, do_derivatives, remat=remat_force),
        type_names=type_names, r_max=r_max, per_edge_type_cutoff=per_edge_type_cutoff,
    )
    return model
