"""A force field of the ZBL pair potential alone (tests, priors).

Port of ``nequip_tpu/model/pair_potential.py`` (``ZBLPairPotential``).
"""

from __future__ import annotations

from typing import List, Sequence

from ..data import _keys
from ..nn import AtomwiseReduce, ForceStressOutput, GraphModel, SequentialGraphNetwork
from ..nn.embedding import EdgeLengthNormalizer
from ..nn.pair_potential import ZBL
from .utils import model_builder


@model_builder
def ZBLPairPotential(
    r_max: float,
    chemical_species: List[str],
    units: str,
    type_names: Sequence[str] = None,
    polynomial_cutoff_p: float = 6.0,
    do_derivatives: bool = True,
) -> GraphModel:
    type_names = list(type_names)
    edge_norm = EdgeLengthNormalizer(r_max=r_max, type_names=type_names)
    zbl = ZBL(
        type_names=type_names,
        chemical_species=chemical_species,
        units=units,
        polynomial_cutoff_p=polynomial_cutoff_p,
        irreps_in=edge_norm.irreps_out,
    )
    total = AtomwiseReduce(
        irreps_in=zbl.irreps_out, field=_keys.PER_ATOM_ENERGY_KEY, out_field=_keys.TOTAL_ENERGY_KEY
    )
    model = SequentialGraphNetwork({"edge_norm": edge_norm, "zbl": zbl, "total_energy_sum": total})
    return GraphModel(ForceStressOutput(model, do_derivatives), type_names=type_names, r_max=r_max)
