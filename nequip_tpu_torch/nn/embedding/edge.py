"""Edge embeddings: spherical harmonics, length normalisation, Bessel basis.

Port of ``nequip_tpu/nn/embedding/edge.py``.  Padding contract: masked
edges get exactly-zero edge embedding and cutoff, so their messages vanish
(the radial MLP is bias-free).  The geometry runs in the positions' dtype
(float64); SH, embedding and cutoff are cast to the model dtype.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ...data import _keys
from ...ops.irreps import Irreps
from ...ops.radial import bessel_basis, polynomial_cutoff
from ...ops.spherical import spherical_harmonics
from ..graph_utils import with_edge_types, with_edge_vectors
from ..module import GraphModule
from .utils import cutoff_dict_to_matrix


class PolynomialCutoff:
    """Config-friendly wrapper for the DimeNet polynomial envelope."""

    def __init__(self, p: float = 6.0):
        if p < 2.0:
            raise ValueError("polynomial cutoff needs p >= 2")
        self.p = float(p)

    def __call__(self, x):
        return polynomial_cutoff(x, self.p)


class SphericalHarmonicEdgeAttrs(GraphModule):
    """edge_attrs = component-normalised SH of the edge unit vector."""

    def __init__(self, irreps_edge_sh: Union[int, str, Irreps], irreps_in=None,
                 out_field: str = _keys.EDGE_ATTRS_KEY):
        super().__init__()
        self.out_field = out_field
        if isinstance(irreps_edge_sh, int):
            self.irreps_edge_sh = Irreps.spherical_harmonics(irreps_edge_sh)
        else:
            self.irreps_edge_sh = Irreps(irreps_edge_sh)
        ls = [mi.ir.l for mi in self.irreps_edge_sh]
        if ls != list(range(len(ls))):
            raise ValueError("SH irreps must be 0..lmax")
        self.lmax = max(ls)
        self._init_irreps(irreps_in=irreps_in, irreps_out={out_field: self.irreps_edge_sh})

    def forward(self, data: dict) -> dict:
        data = with_edge_vectors(data, with_lengths=False)
        sh = spherical_harmonics(self.lmax, data[_keys.EDGE_VECTORS_KEY], normalize=True)
        data[self.out_field] = sh.to(self.model_dtype)
        return data


class EdgeLengthNormalizer(GraphModule):
    """normed_edge_lengths = r / r_max (or per-edge-type cutoff)."""

    def __init__(
        self,
        r_max: float,
        type_names: List[str],
        per_edge_type_cutoff: Optional[Dict[str, Union[float, Dict[str, float]]]] = None,
        irreps_in=None,
    ):
        super().__init__()
        self.r_max = float(r_max)
        self.type_names = list(type_names)
        self.num_types = len(type_names)
        self.per_edge_type = per_edge_type_cutoff is not None
        if self.per_edge_type:
            mat = cutoff_dict_to_matrix(per_edge_type_cutoff, self.type_names, self.r_max)
            self._rmax_recip = (1.0 / mat).reshape(-1)
        else:
            self._rmax_recip = np.array(1.0 / self.r_max)
        irreps_out = {_keys.NORM_LENGTH_KEY: Irreps("1x0e")}
        if self.per_edge_type:
            irreps_out[_keys.EDGE_TYPE_KEY] = None
        self._init_irreps(irreps_in=irreps_in, irreps_out=irreps_out)

    def forward(self, data: dict) -> dict:
        data = with_edge_vectors(data, with_lengths=True)
        r = data[_keys.EDGE_LENGTH_KEY].reshape(-1, 1)
        recip = torch.as_tensor(self._rmax_recip, dtype=r.dtype, device=r.device)
        if self.per_edge_type:
            data = with_edge_types(data)
            et = data[_keys.EDGE_TYPE_KEY]
            recip = recip[et[0] * self.num_types + et[1]].unsqueeze(-1)
        data[_keys.NORM_LENGTH_KEY] = r * recip
        return data


class BesselEdgeLengthEncoding(GraphModule):
    """edge_embedding = bessel(normed length) * cutoff envelope."""

    def __init__(self, cutoff: PolynomialCutoff, num_bessels: int = 8, irreps_in=None):
        super().__init__()
        self.cutoff = cutoff
        self.num_bessels = int(num_bessels)
        self._init_irreps(
            irreps_in=irreps_in,
            irreps_out={
                _keys.EDGE_EMBEDDING_KEY: Irreps([(self.num_bessels, (0, 1))]),
                _keys.EDGE_CUTOFF_KEY: Irreps("1x0e"),
            },
        )
        # a frozen parameter of the JAX tree (``bessel_trainable=False``)
        self.register_buffer(
            "bessel_weights", torch.arange(1.0, self.num_bessels + 1.0, dtype=torch.float64)
        )

    def forward(self, data: dict) -> dict:
        x = data[_keys.NORM_LENGTH_KEY]
        bessel = bessel_basis(x, self.bessel_weights.to(x.dtype)).to(self.model_dtype)
        cutoff = self.cutoff(x).to(self.model_dtype)
        if _keys.EDGE_MASK_KEY in data:
            mask = data[_keys.EDGE_MASK_KEY].unsqueeze(-1)
            bessel = torch.where(mask, bessel, torch.zeros_like(bessel))
            cutoff = torch.where(mask, cutoff, torch.zeros_like(cutoff))
        data = dict(data)
        data[_keys.EDGE_CUTOFF_KEY] = cutoff
        data[_keys.EDGE_EMBEDDING_KEY] = bessel * cutoff
        return data
