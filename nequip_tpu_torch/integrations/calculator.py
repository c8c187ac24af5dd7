"""Single-point calculator: energies, forces and stress of one frame.

Port of ``nequip_tpu/integrations/calculator.py``: a request runs the host
pipeline (type mapping -> neighbour list -> padding to capacities rounded
up to ``PAD_MULTIPLE``), moves the padded batch to the device, puts the
edge stream into kernel order once when the predictor runs the fused
kernels (its ``uses_fused_kernels``), calls the predictor and returns numpy
outputs with the padding stripped.  ``timings`` holds the host-clock
seconds of the last request's neighbour list, its whole preparation (the
neighbour list included) and its model call (which ends when the outputs
are on the host).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..data import _keys, batched_from_list, compute_neighborlist_, from_dict, pad_batch, round_up, to_tensors
from ..data.transforms import ChemicalSpeciesToAtomTypeMapper
from ..ops.kernels.tp_scatter import relayout_edge_stream

PAD_MULTIPLE = 128


class NequIPCalculator:
    """``type_names`` are chemical symbols: ``atomic_numbers`` map onto them."""

    def __init__(self, predictor: Callable[[dict], dict], r_max: float, type_names: List[str], device="cpu"):
        self.predictor = predictor
        self.r_max = float(r_max)
        self.type_names = list(type_names)
        self.type_mapper = ChemicalSpeciesToAtomTypeMapper(self.type_names)
        self.device = torch.device(device)
        self.capacities: Optional[Dict[str, int]] = None
        self.timings: Dict[str, float] = {}

    @classmethod
    def from_model(cls, model, device="cpu") -> "NequIPCalculator":
        """Serve a port ``GraphModel`` (weights frozen: inference only)."""
        model = model.to(device).requires_grad_(False)
        md = model.metadata
        return cls(model, r_max=float(md["r_max"]), type_names=md["type_names"].split(), device=device)

    def _prepare(self, frame: dict):
        data = self.type_mapper(from_dict(dict(frame)))
        t0 = time.perf_counter()
        data = compute_neighborlist_(data, self.r_max)
        self.timings["neighbor_list_s"] = time.perf_counter() - t0
        batch = batched_from_list([data])
        n = batch[_keys.POSITIONS_KEY].shape[0]
        e = batch[_keys.EDGE_INDEX_KEY].shape[1]
        cap = self.capacities
        if cap is None or n > cap["n_nodes"] or e > cap["n_edges"]:
            # bucketed capacities, grown when a system outgrows them
            cap = self.capacities = {
                "n_nodes": round_up(n, PAD_MULTIPLE),
                "n_edges": round_up(max(e, 1), 2 * PAD_MULTIPLE),
                "n_frames": 2,
            }
        padded = to_tensors(pad_batch(batch, cap["n_nodes"], cap["n_edges"], cap["n_frames"]), self.device)
        if getattr(self.predictor, "uses_fused_kernels", False):
            padded = relayout_edge_stream(padded)
        return padded, n

    def calculate(self, frame: dict) -> Dict[str, np.ndarray]:
        """frame: {pos, atomic_numbers|atom_types, cell?, pbc?} -> results."""
        t0 = time.perf_counter()
        padded, n = self._prepare(frame)
        t1 = time.perf_counter()
        out = self.predictor(padded)
        host = {
            k: out[k].detach().cpu().numpy()
            for k in (_keys.TOTAL_ENERGY_KEY, _keys.PER_ATOM_ENERGY_KEY, _keys.FORCE_KEY, _keys.STRESS_KEY)
            if k in out
        }
        self.timings.update(prepare_s=t1 - t0, model_s=time.perf_counter() - t1)
        energy = float(host[_keys.TOTAL_ENERGY_KEY].reshape(-1)[0])
        results = {
            "energy": energy,
            "energies": host[_keys.PER_ATOM_ENERGY_KEY][:n].reshape(-1),
            "free_energy": energy,
        }
        if _keys.FORCE_KEY in host:
            results["forces"] = host[_keys.FORCE_KEY][:n]
        if _keys.STRESS_KEY in host and _keys.CELL_KEY in frame:
            s = host[_keys.STRESS_KEY][0]
            results["stress"] = s
            results["stress_voigt"] = np.array([s[0, 0], s[1, 1], s[2, 2], s[1, 2], s[0, 2], s[0, 1]])
        return results
