"""MD-engine pair style (the LAMMPS ML-IAP pattern).

Port of ``nequip_tpu/integrations/pair_style.py``: the MD engine owns the
spatial decomposition and hands over per-rank edge vectors (``rij``), pair
indices and the types of local and ghost atoms; the wrapper returns the
local atoms' energies and the **edge forces** ``dE/d r_ij``, which the
engine sums onto atoms and communicates.  The model runs the edge branch
of ``ForceStressOutput`` (``nn/grad_output.py``) on the card, frozen, so a
model with ``tp_impl="fused"`` runs K1, K2's inference variant and K3; the
edge forces come back in the engine's pair order.

Capacities are padded as in the JAX package (atoms to ``pad_multiple``,
pairs to ``2 * pad_multiple``), and the fixed inputs of each padded
capacity are made once and kept.  The file format is the JAX package's
(``"nequip_tpu_pair_style_v1"``: the model config in the JAX package's
names and the parameter tree as numpy arrays), so files pass both ways.
"""

from __future__ import annotations

import pickle
from typing import Dict

import numpy as np
import torch

from ..data import _keys, round_up
from ..model.jax_params import jax_params_tree, load_jax_params
from ..utils.config import instantiate, retarget, unretarget
from ..utils.device import resolve_device

FORMAT = "nequip_tpu_pair_style_v1"


class NequIPPairStyleWrapper:
    """Callable pair style for external MD engines, on ``device`` (the card
    unless the caller asks for the CPU; raises without one)."""

    def __init__(self, model, pad_multiple: int = 128, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).requires_grad_(False)
        self.pad_multiple = int(pad_multiple)
        self.r_max = float(model.r_max)
        self.type_names = model.type_names
        self._fixed: Dict[tuple, dict] = {}

    def _fixed_inputs(self, cap_n: int, cap_e: int) -> dict:
        """The inputs a padded capacity fixes, made once on the device."""
        key = (cap_n, cap_e)
        if key not in self._fixed:
            self._fixed[key] = {
                _keys.POSITIONS_KEY: torch.zeros(cap_n, 3, dtype=torch.float64, device=self.device),  # unused
                _keys.BATCH_KEY: torch.zeros(cap_n, dtype=torch.int64, device=self.device),
                _keys.NUM_NODES_KEY: torch.tensor([cap_n], dtype=torch.int64, device=self.device),
                _keys.FRAME_MASK_KEY: torch.ones(1, dtype=torch.bool, device=self.device),
            }
        return self._fixed[key]

    def compute(
        self,
        rij: np.ndarray,  # (n_pairs, 3) edge vectors (center -> neighbour)
        pair_i: np.ndarray,  # (n_pairs,) center indices (local)
        pair_j: np.ndarray,  # (n_pairs,) neighbour indices (local + ghost)
        elems: np.ndarray,  # (n_total,) types of the local and ghost atoms
        n_local: int,
    ) -> Dict[str, np.ndarray]:
        """Per-atom energies of the local atoms, their total, and the edge
        forces in the order of the pairs."""
        out = self.model(self.padded_batch(rij, pair_i, pair_j, elems, n_local))
        e_atom = out[_keys.PER_ATOM_ENERGY_KEY][:n_local].reshape(-1).cpu().numpy()
        return {
            "atomic_energies": e_atom,
            "total_energy": float(e_atom.sum()),
            "edge_forces": out[_keys.EDGE_FORCE_KEY][: len(pair_i)].cpu().numpy(),
        }

    def padded_batch(self, rij, pair_i, pair_j, elems, n_local: int) -> Dict[str, torch.Tensor]:
        """The model's input for ``compute``'s arguments, padded, on the device."""
        n_total, n_pairs = int(len(elems)), int(len(pair_i))
        cap_n = round_up(max(n_total, 1), self.pad_multiple)
        cap_e = round_up(max(n_pairs, 1), 2 * self.pad_multiple)
        vec = np.zeros((cap_e, 3))
        vec[:n_pairs] = rij
        edge_index = np.full((2, cap_e), cap_n - 1, dtype=np.int64)
        edge_index[0, :n_pairs] = pair_i
        edge_index[1, :n_pairs] = pair_j
        types = np.zeros(cap_n, dtype=np.int64)
        types[:n_total] = elems
        dev = lambda a, dtype=None: torch.as_tensor(a, dtype=dtype, device=self.device)  # noqa: E731
        return {
            **self._fixed_inputs(cap_n, cap_e),
            _keys.EDGE_VECTORS_KEY: dev(vec, torch.float64),
            _keys.EDGE_INDEX_KEY: dev(edge_index),
            _keys.ATOM_TYPE_KEY: dev(types),
            _keys.NODE_MASK_KEY: dev(np.arange(cap_n) < n_total),
            _keys.EDGE_MASK_KEY: dev(np.arange(cap_e) < n_pairs),
            _keys.NUM_LOCAL_GHOST_NODES_KEY: dev(np.array([n_local, n_total - n_local], dtype=np.int64)),
        }

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        payload = {
            "format": FORMAT,
            "model_config": unretarget(getattr(self.model, "model_config", {})),
            "params": jax_params_tree(self.model),
            "metadata": {k: str(v) for k, v in self.model.metadata.items()},
        }
        with open(path, "wb") as f:
            pickle.dump(payload, f)

    @classmethod
    def load(cls, path: str, pad_multiple: int = 128, device="cuda") -> "NequIPPairStyleWrapper":
        """A pair-style file of either package."""
        device = resolve_device(device)  # before loading: no card, no work
        with open(path, "rb") as f:
            payload = pickle.load(f)
        if payload.get("format") != FORMAT:
            raise ValueError(f"{path}: not a {FORMAT} pair-style file (format {payload.get('format')!r})")
        model = instantiate(retarget(payload["model_config"]), _recursive_=False)
        return cls(load_jax_params(model, payload["params"]), pad_multiple=pad_multiple, device=device)
