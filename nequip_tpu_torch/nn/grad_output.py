"""Forces and stress as gradients of the energy.

Port of the positions/strain branch of ``ForceStressOutput``
(``nequip_tpu/nn/grad_output.py``, ``_pos_stress_branch``): the symmetrised
strain-displacement trick,

    forces = -dE/dpos,   stress = (dE/ddisplacement) / V,   virial = -dE/ddisplacement.

Serving (parameters frozen, or grad mode off) takes one
``torch.autograd.grad`` with ``create_graph=False`` and detaches the
outputs.  Training (grad mode on and a parameter that requires grad)
builds the graph of that gradient (``create_graph=True``) and detaches
nothing, so a force or stress loss differentiates through it (reverse over
reverse; the fused kernels' autograd Functions are closed under it).  The
gradients flow through every module, including the kernels' ``dsh``/``demb``
outputs back to the edge vectors.
"""

from __future__ import annotations

import torch

from ..data import _keys
from ..ops.irreps import Irreps
from .graph_utils import per_frame_matmul
from .module import GraphModule


class ForceStressOutput(GraphModule):
    def __init__(self, func: GraphModule, do_derivatives: bool = True):
        super().__init__()
        self.func = func
        self.do_derivatives = do_derivatives
        self._init_irreps(irreps_in=dict(func.irreps_in), irreps_out=dict(func.irreps_out))
        for k in (_keys.FORCE_KEY, _keys.STRESS_KEY, _keys.VIRIAL_KEY):
            self.irreps_out[k] = Irreps("1o")

    _jax_transparent = ("func",)

    def forward(self, data: dict) -> dict:
        if not self.do_derivatives:
            return self.func(data)
        if _keys.EDGE_VECTORS_KEY in data:
            raise NotImplementedError("the edge-vector force branch is not ported")
        training = torch.is_grad_enabled() and any(p.requires_grad for p in self.parameters())
        pos = data[_keys.POSITIONS_KEY].detach()
        has_cell = _keys.CELL_KEY in data
        num_frames = data[_keys.NUM_NODES_KEY].shape[0]
        batch = data.get(_keys.BATCH_KEY)
        if batch is None:
            batch = torch.zeros(pos.shape[0], dtype=torch.long, device=pos.device)
        orig_cell = data.get(_keys.CELL_KEY)

        with torch.enable_grad():
            pos_in = pos.clone().requires_grad_(True)
            displacement = torch.zeros(
                (num_frames, 3, 3), dtype=pos.dtype, device=pos.device, requires_grad=True
            )
            sym = 0.5 * (displacement + displacement.transpose(-1, -2))
            inner = dict(data)
            inner[_keys.POSITIONS_KEY] = pos_in + per_frame_matmul(pos_in, sym, batch)
            if has_cell:
                cell = orig_cell.reshape(-1, 3, 3)
                inner[_keys.CELL_KEY] = cell + torch.einsum("fij,fjk->fik", cell, sym)
            out = self.func(inner)
            energy = out[_keys.TOTAL_ENERGY_KEY].reshape(-1)
            if _keys.FRAME_MASK_KEY in data:
                energy = torch.where(data[_keys.FRAME_MASK_KEY], energy, torch.zeros_like(energy))
            dE_dpos, dE_ddisp = torch.autograd.grad(
                energy.sum(), (pos_in, displacement), create_graph=training
            )

        if not training:
            out = {k: (v.detach() if isinstance(v, torch.Tensor) else v) for k, v in out.items()}
        out[_keys.POSITIONS_KEY] = data[_keys.POSITIONS_KEY]
        if has_cell:
            out[_keys.CELL_KEY] = orig_cell
            vol = torch.abs(torch.linalg.det(orig_cell.reshape(-1, 3, 3)))
            if _keys.FRAME_MASK_KEY in data:
                vol = torch.where(data[_keys.FRAME_MASK_KEY], vol, torch.ones_like(vol))
            out[_keys.STRESS_KEY] = dE_ddisp / vol[:, None, None]
        out[_keys.FORCE_KEY] = -dE_dpos
        out[_keys.VIRIAL_KEY] = -dE_ddisp
        return out
