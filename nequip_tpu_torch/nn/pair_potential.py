"""Pair potentials: the ZBL universal repulsion and Lennard-Jones.

Port of ``nequip_tpu/nn/pair_potential.py`` in plain PyTorch (the JAX
package computes them in XLA, outside any kernel): ZBL screening constants
from LAMMPS ``pair_zbl_const.h``, unit prefactors from LAMMPS
``update.cpp`` (metal: 14.399645 eV*A, real: 332.06371 kcal/mol*A), half
the pair energy on each directed edge, summed onto ``edge_index[0]`` in
the model dtype and added to the per-atom energy.

They read the edge stream in whatever order the model runs on (the
kernel order ``GraphModel`` applied), so they follow it; every op has a
forward-mode derivative (the scatter is ``index_add``), which the fr dual
sweep (``GraphModule.jvp``) runs through.  Padded edges have zero length:
``r_safe`` keeps their energy finite and the edge mask zeroes it through
the cutoff.
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Union

import numpy as np
import torch

from ..data import _keys
from ..data.transforms.type_mapper import ATOMIC_NUMBERS
from ..ops.irreps import Irreps
from ..ops.scatter import scatter_sum
from .embedding.edge import PolynomialCutoff
from .graph_utils import with_edge_vectors
from .module import GraphModule

_QQR2E = {"metal": 14.399645, "real": 332.06371}


def _zbl_pair_energy(Zi, Zj, r, qqr2exesquare):
    """Screened-Coulomb pair energy (LAMMPS pair_zbl_const.h constants)."""
    pzbl, a0 = 0.23, 0.46850
    c1, c2, c3, c4 = 0.02817, 0.28022, 0.50986, 0.18175
    d1, d2, d3, d4 = -0.20162, -0.40290, -0.94229, -3.19980
    x = ((torch.pow(Zi, pzbl) + torch.pow(Zj, pzbl)) * r) / a0
    psi = c1 * torch.exp(d1 * x) + c2 * torch.exp(d2 * x) + c3 * torch.exp(d3 * x) + c4 * torch.exp(d4 * x)
    return qqr2exesquare * ((Zi * Zj) / r) * psi


class _PairPotential(GraphModule):
    """Per-edge energy ``_pair_energy(r_safe, t_i, t_j)`` times the masked
    polynomial cutoff, half on each directed edge, summed onto
    ``edge_index[0]`` into ``per_atom_energy_field``."""

    def __init__(self, polynomial_cutoff_p: float, per_atom_energy_field: str, irreps_in):
        super().__init__()
        self.per_atom_energy_field = per_atom_energy_field
        self._init_irreps(
            irreps_in=irreps_in,
            required_irreps_in=[_keys.NORM_LENGTH_KEY],
            irreps_out={self.per_atom_energy_field: Irreps("1x0e")},
        )
        self.cutoff = PolynomialCutoff(polynomial_cutoff_p)
        # constant tables on each device, uploaded once (a CUDA graph
        # capture allows no host-to-device copy in the force call)
        self._tables: Dict[Tuple[str, torch.dtype, torch.device], torch.Tensor] = {}

    def _table(self, name: str, values: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        key = (name, like.dtype, like.device)
        if key not in self._tables:
            self._tables[key] = torch.as_tensor(values, dtype=like.dtype, device=like.device)
        return self._tables[key]

    def _pair_energy(self, r_safe, ti, tj):
        raise NotImplementedError

    def forward(self, data: dict) -> dict:
        data = with_edge_vectors(data, with_lengths=True)
        ei = data[_keys.EDGE_INDEX_KEY]
        r = data[_keys.EDGE_LENGTH_KEY].reshape(-1)
        r_safe = torch.where(r > 0, r, torch.ones_like(r))
        types = data[_keys.ATOM_TYPE_KEY].reshape(-1)
        ti = torch.index_select(types, 0, ei[0])
        tj = torch.index_select(types, 0, ei[1])
        eng = self._pair_energy(r_safe, ti, tj).unsqueeze(-1)
        cutoff = self.cutoff(data[_keys.NORM_LENGTH_KEY]).to(self.model_dtype)
        mask = data.get(_keys.EDGE_MASK_KEY)
        if mask is not None:
            cutoff = torch.where(mask.unsqueeze(-1), cutoff, torch.zeros_like(cutoff))
        eng = eng.to(self.model_dtype) * cutoff
        atomic_eng = scatter_sum(eng, ei[0], data[_keys.POSITIONS_KEY].shape[0], mask=mask)
        data = dict(data)
        if self.per_atom_energy_field in data:
            atomic_eng = atomic_eng + data[self.per_atom_energy_field].to(atomic_eng.dtype)
        data[self.per_atom_energy_field] = atomic_eng
        return data


class ZBL(_PairPotential):
    """The ZBL universal screened nuclear repulsion between the chemical
    species of the model's types, in ``units`` ("metal" or "real")."""

    def __init__(
        self,
        type_names: List[str],
        chemical_species: List[str],
        units: str,
        polynomial_cutoff_p: float = 6.0,
        per_atom_energy_field: str = _keys.PER_ATOM_ENERGY_KEY,
        irreps_in=None,
    ):
        super().__init__(polynomial_cutoff_p, per_atom_energy_field, irreps_in)
        if len(chemical_species) != len(type_names):
            raise ValueError("ZBL needs one chemical species per type")
        atomic_numbers = [ATOMIC_NUMBERS[s] for s in chemical_species]
        if min(atomic_numbers) < 1:
            raise ValueError("invalid chemical symbols for ZBL")
        self._Z = np.asarray(atomic_numbers, dtype=np.float64)
        # half the energy on each of the (i, j), (j, i) directed edges
        self._qqr2exesquare = _QQR2E[units] * 0.5

    def _pair_energy(self, r_safe, ti, tj):
        Z = self._table("Z", self._Z, r_safe)
        return _zbl_pair_energy(Z[ti], Z[tj], r_safe, self._qqr2exesquare)

    def __repr__(self):
        return f"ZBL(Z={self._Z.tolist()})"


class LennardJones(_PairPotential):
    """Lennard-Jones per type pair: ``lj_sigma``/``lj_epsilon`` a float, or a
    dict by type name ("A") or type pair ("A,B")."""

    def __init__(
        self,
        type_names: List[str],
        lj_sigma: Union[float, Dict[str, float]],
        lj_epsilon: Union[float, Dict[str, float]],
        polynomial_cutoff_p: float = 6.0,
        per_atom_energy_field: str = _keys.PER_ATOM_ENERGY_KEY,
        irreps_in=None,
    ):
        super().__init__(polynomial_cutoff_p, per_atom_energy_field, irreps_in)
        self.type_names = list(type_names)
        n = len(type_names)

        def to_matrix(v):
            if isinstance(v, (int, float)):
                return np.full((n, n), float(v))
            mat = np.zeros((n, n))
            for key, val in v.items():
                names = key.split(",") if isinstance(key, str) and "," in key else None
                if names:
                    i, j = (self.type_names.index(x.strip()) for x in names)
                    mat[i, j] = mat[j, i] = float(val)
                else:
                    i = self.type_names.index(key)
                    mat[i, :] = mat[:, i] = float(val)
            return mat

        self._sigma = to_matrix(lj_sigma)
        self._epsilon = to_matrix(lj_epsilon)

    def _pair_energy(self, r_safe, ti, tj):
        sigma = self._table("sigma", self._sigma, r_safe)[ti, tj]
        eps = self._table("epsilon", self._epsilon, r_safe)[ti, tj]
        s6 = torch.pow(sigma / r_safe, 6.0)
        return 2.0 * eps * (s6 * s6 - s6)
