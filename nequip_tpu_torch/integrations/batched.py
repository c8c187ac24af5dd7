"""Batched inference over many frames at once (torch-sim calculator analogue).

Port of ``nequip_tpu/integrations/batched.py``: a population of frames is
batched, padded to capacities that only grow (so repeated calls of similar
populations reuse the same shapes), put into kernel order once per call
when the model runs the fused kernels, evaluated in one model call, and
unbatched into energies, forces and stress per frame.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..data import _keys, batched_from_list, compute_neighborlist_, from_dict, pad_batch, round_up, to_tensors
from ..ops.kernels.tp_scatter import relayout_edge_stream
from ..utils.device import resolve_device


class NequIPBatchedInference:
    """Frames carry ``pos``, ``atom_types`` and, if periodic, ``cell`` and
    ``pbc``.  The model moves to ``device`` (the card unless the caller asks
    for the CPU; raises without one) with its weights frozen."""

    def __init__(self, model, pad_multiple: int = 128, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).requires_grad_(False)
        self.r_max = float(model.r_max)
        self.pad_multiple = pad_multiple
        self._caps: Optional[Dict[str, int]] = None

    @torch.no_grad()
    def __call__(self, frames: List[dict]) -> List[Dict[str, np.ndarray]]:
        prepared = [compute_neighborlist_(from_dict(dict(f)), self.r_max) for f in frames]
        batch = batched_from_list(prepared)
        n = batch[_keys.POSITIONS_KEY].shape[0]
        e = batch[_keys.EDGE_INDEX_KEY].shape[1]
        caps = {
            "n_nodes": round_up(n, self.pad_multiple),
            "n_edges": round_up(max(e, 1), 2 * self.pad_multiple),
            "n_frames": len(frames) + 1,
        }
        if self._caps is None or any(caps[k] > self._caps[k] for k in caps):
            self._caps = caps  # grow the buckets
        padded = to_tensors(
            pad_batch(batch, self._caps["n_nodes"], self._caps["n_edges"], self._caps["n_frames"]), self.device
        )
        if getattr(self.model, "uses_fused_kernels", False):
            padded = relayout_edge_stream(padded)
        out = self.model(padded)
        host = {k: out[k].detach().cpu().numpy() for k in (_keys.TOTAL_ENERGY_KEY, _keys.FORCE_KEY, _keys.STRESS_KEY)
                if k in out}
        energies = host[_keys.TOTAL_ENERGY_KEY].reshape(-1)
        results = []
        offset = 0
        for i, f in enumerate(prepared):
            ni = f[_keys.POSITIONS_KEY].shape[0]
            res = {"energy": float(energies[i])}
            if _keys.FORCE_KEY in host:
                res["forces"] = host[_keys.FORCE_KEY][offset : offset + ni]
            if _keys.STRESS_KEY in host and _keys.CELL_KEY in f:
                res["stress"] = host[_keys.STRESS_KEY][i]
            results.append(res)
            offset += ni
        return results
