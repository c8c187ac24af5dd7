"""Map chemical species (atomic numbers) to model atom-type indices.

Port of ``nequip_tpu/data/transforms/type_mapper.py`` (plain numpy).
"""

from __future__ import annotations

from typing import List

import numpy as np

from .. import _keys

# periodic table symbols, index = atomic number (1-based)
CHEMICAL_SYMBOLS = [
    "X", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne", "Na", "Mg",
    "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn",
    "Fe", "Co", "Ni", "Cu", "Zn", "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb",
    "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In",
    "Sn", "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd", "Pm",
    "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb", "Lu", "Hf", "Ta",
    "W", "Re", "Os", "Ir", "Pt", "Au", "Hg", "Tl", "Pb", "Bi", "Po", "At",
    "Rn", "Fr", "Ra", "Ac", "Th", "Pa", "U", "Np", "Pu", "Am", "Cm", "Bk",
    "Cf", "Es", "Fm", "Md", "No", "Lr", "Rf", "Db", "Sg", "Bh", "Hs", "Mt",
    "Ds", "Rg", "Cn", "Nh", "Fl", "Mc", "Lv", "Ts", "Og",
]
ATOMIC_NUMBERS = {s: i for i, s in enumerate(CHEMICAL_SYMBOLS)}


class ChemicalSpeciesToAtomTypeMapper:
    """``atomic_numbers`` -> ``atom_types`` via a lookup table."""

    def __init__(self, chemical_symbols: List[str]):
        self.chemical_symbols = list(chemical_symbols)
        table = np.full(len(CHEMICAL_SYMBOLS), -1, dtype=np.int32)
        for type_i, sym in enumerate(self.chemical_symbols):
            if sym not in ATOMIC_NUMBERS:
                raise ValueError(f"unknown chemical symbol {sym!r}")
            table[ATOMIC_NUMBERS[sym]] = type_i
        self._table = table

    def __call__(self, data: dict) -> dict:
        if _keys.ATOM_TYPE_KEY in data:
            return data
        z = np.asarray(data[_keys.ATOMIC_NUMBERS_KEY]).reshape(-1)
        types = self._table[z]
        if (types < 0).any():
            bad = sorted(set(int(n) for n in z[types < 0]))
            raise ValueError(
                f"atomic numbers {bad} not covered by chemical_symbols "
                f"{self.chemical_symbols}"
            )
        data[_keys.ATOM_TYPE_KEY] = types
        return data
