"""Deterministic synthetic labelled data: rattled fcc supercells with
smoothly truncated Lennard-Jones labels.

Port of ``nequip_tpu/data/dataset/synthetic.py`` on the port's kdtree
neighbour list: the same frames and labels from the same seed.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .. import _keys
from ..neighborlist import neighbor_list
from .base import AtomicDataset


def _lj_phi(r: np.ndarray, sigma: float, epsilon: float, r_max: float, p: float = 6.0):
    """phi(r) and phi'(r) with the DimeNet polynomial envelope."""
    s6 = (sigma / r) ** 6
    lj = 4.0 * epsilon * (s6 * s6 - s6)
    dlj = 4.0 * epsilon * (-12.0 * s6 * s6 + 6.0 * s6) / r
    x = r / r_max
    env = (
        1.0
        - ((p + 1.0) * (p + 2.0) / 2.0) * x**p
        + p * (p + 2.0) * x ** (p + 1.0)
        - (p * (p + 1.0) / 2.0) * x ** (p + 2.0)
    ) * (x < 1.0)
    denv = (
        -((p + 1.0) * (p + 2.0) / 2.0) * p * x ** (p - 1.0)
        + p * (p + 2.0) * (p + 1.0) * x**p
        - (p * (p + 1.0) / 2.0) * (p + 2.0) * x ** (p + 1.0)
    ) * (x < 1.0) / r_max
    return lj * env, dlj * env + lj * denv


def lj_reference(
    pos: np.ndarray,
    cell: Optional[np.ndarray],
    pbc,
    r_max: float = 4.0,
    sigma: float = 1.8,
    epsilon: float = 0.25,
) -> Dict[str, np.ndarray]:
    """Energy, forces, stress and virial of the truncated LJ system:
    stress = dE/dstrain / V, virial = -dE/dstrain."""
    edge_index, shifts = neighbor_list(pos, r_max, cell=cell, pbc=pbc)
    dst, src = edge_index
    vec = pos[src] - pos[dst]
    if cell is not None:
        vec = vec + shifts @ np.asarray(cell).reshape(3, 3)
    r = np.linalg.norm(vec, axis=1)
    phi, dphi = _lj_phi(r, sigma, epsilon, r_max)
    forces = np.zeros_like(pos)
    np.add.at(forces, dst, dphi[:, None] * (vec / r[:, None]))
    dE_dstrain = 0.5 * np.einsum("e,ea,eb->ab", dphi / r, vec, vec)
    out = {
        _keys.TOTAL_ENERGY_KEY: np.array([[0.5 * phi.sum()]]),
        _keys.FORCE_KEY: forces,
    }
    if cell is not None:
        vol = abs(np.linalg.det(np.asarray(cell).reshape(3, 3)))
        out[_keys.STRESS_KEY] = (dE_dstrain / vol).reshape(1, 3, 3)
        out[_keys.VIRIAL_KEY] = (-dE_dstrain).reshape(1, 3, 3)
    return out


class LJTestDataset(AtomicDataset):
    """Rattled fcc Cu-like supercells labelled with the truncated LJ potential."""

    def __init__(
        self,
        supercell: Tuple[int, int, int] = (2, 2, 2),
        sigma: float = 0.1,
        lattice_constant: float = 3.61,
        num_frames: int = 10,
        seed: int = 123456,
        atomic_number: int = 29,
        lj_params: Optional[dict] = None,
        transforms=None,
    ):
        super().__init__(transforms)
        self.lj_params = dict(r_max=4.0, sigma=1.8, epsilon=0.25)
        self.lj_params.update(lj_params or {})
        rng = np.random.RandomState(seed)
        a = lattice_constant
        base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]) * a
        nx, ny, nz = supercell
        lattice = np.concatenate(
            [base + np.array([i, j, k]) * a for i in range(nx) for j in range(ny) for k in range(nz)]
        )
        cell = np.diag([nx * a, ny * a, nz * a])
        self.frames = []
        for _ in range(num_frames):
            pos = lattice + rng.normal(0, sigma, lattice.shape)
            self.frames.append({
                _keys.POSITIONS_KEY: pos,
                _keys.CELL_KEY: cell,
                _keys.PBC_KEY: np.array([True, True, True]),
                _keys.ATOMIC_NUMBERS_KEY: np.full(len(pos), atomic_number),
                **lj_reference(pos, cell, (True, True, True), **self.lj_params),
            })

    def __len__(self) -> int:
        return len(self.frames)

    def get_frame(self, idx: int) -> dict:
        return dict(self.frames[idx])
