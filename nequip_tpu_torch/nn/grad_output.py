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

With ``edge_vectors`` among the inputs (an MD engine's pair style, the
LAMMPS ML-IAP pattern) the edge branch runs instead (JAX
``_edge_force_branch``): ``edge_forces = dE/d(edge_vectors)`` with no sign
flip, of the local atoms' energies only when ``num_local_ghost_atoms`` is
given.  ``GraphModel`` returns them in the caller's edge order.

``loss_surrogate`` is the other route to the same parameter gradients
(reverse over forward, ``force_grad_mode="fr"``): a scalar whose gradient
is the loss gradient, built from one dual-number sweep of the energy graph.

``remat=True`` (the builder's ``remat_force``, JAX ``jax.checkpoint`` of the
branch) is accepted, so that JAX configs and packages that name it load,
and recorded; the port runs the ordinary branch, which gives the same
numbers.  A recompute cannot lower the rr peak: it falls in the loss
backward, where the recomputed branch and its second-order graph are live
as without remat (``PERF.md``).

``PartialForceOutput`` gives the whole jacobian ``-dE_j/dpos_i``.
"""

from __future__ import annotations

import torch

from ..data import _keys
from ..ops.irreps import Irreps
from .graph_utils import per_frame_matmul
from .module import GraphModule


def _volumes(data: dict) -> torch.Tensor:
    """|det(cell)| per frame, as the triple product (elementwise ops only, so
    a CUDA graph can capture it), 1 for padding frames."""
    cell = data[_keys.CELL_KEY].reshape(-1, 3, 3)
    vol = torch.abs(torch.sum(cell[:, 0] * torch.linalg.cross(cell[:, 1], cell[:, 2]), dim=-1))
    if _keys.FRAME_MASK_KEY in data:
        vol = torch.where(data[_keys.FRAME_MASK_KEY], vol, torch.ones_like(vol))
    return vol


class ForceStressOutput(GraphModule):
    def __init__(self, func: GraphModule, do_derivatives: bool = True, remat: bool = False):
        super().__init__()
        self.func = func
        self.do_derivatives = do_derivatives
        self.remat = bool(remat)  # recorded only (module docstring)
        self._init_irreps(irreps_in=dict(func.irreps_in), irreps_out=dict(func.irreps_out))
        for k in (_keys.FORCE_KEY, _keys.STRESS_KEY, _keys.VIRIAL_KEY, _keys.EDGE_FORCE_KEY):
            self.irreps_out[k] = Irreps("1o")

    _jax_transparent = ("func",)

    def forward(self, data: dict) -> dict:
        if not self.do_derivatives:
            return self.func(data)
        training = torch.is_grad_enabled() and any(p.requires_grad for p in self.parameters())
        branch = self._edge_force_branch if _keys.EDGE_VECTORS_KEY in data else self._pos_stress_branch
        return branch(data, training)

    def _pos_stress_branch(self, data: dict, training: bool) -> dict:
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
            out[_keys.STRESS_KEY] = dE_ddisp / _volumes(data)[:, None, None]
        out[_keys.FORCE_KEY] = -dE_dpos
        out[_keys.VIRIAL_KEY] = -dE_ddisp
        return out

    def _edge_force_branch(self, data: dict, training: bool) -> dict:
        with torch.enable_grad():
            vecs = data[_keys.EDGE_VECTORS_KEY].detach().clone().requires_grad_(True)
            inner = dict(data)
            inner[_keys.EDGE_VECTORS_KEY] = vecs
            out = self.func(inner)
            if _keys.NUM_LOCAL_GHOST_NODES_KEY in data:
                # an engine's spatial decomposition: only the locally owned
                # atoms' energies (ghost energies come from incomplete graphs
                # and belong to their home rank)
                n_local = data[_keys.NUM_LOCAL_GHOST_NODES_KEY].reshape(-1)[0]
                e_atom = out[_keys.PER_ATOM_ENERGY_KEY].reshape(-1)
                local = torch.arange(e_atom.shape[0], device=e_atom.device) < n_local
                energy = torch.where(local, e_atom, torch.zeros_like(e_atom))
            else:
                energy = out[_keys.TOTAL_ENERGY_KEY].reshape(-1)
                if _keys.FRAME_MASK_KEY in data:
                    energy = torch.where(data[_keys.FRAME_MASK_KEY], energy, torch.zeros_like(energy))
            (dE_dvec,) = torch.autograd.grad(energy.sum(), vecs, create_graph=training)
        if not training:
            out = {k: (v.detach() if isinstance(v, torch.Tensor) else v) for k, v in out.items()}
        out[_keys.EDGE_VECTORS_KEY] = data[_keys.EDGE_VECTORS_KEY]
        out[_keys.EDGE_FORCE_KEY] = dE_dvec  # no sign flip: the LAMMPS pair convention
        return out

    def loss_surrogate(self, data: dict, cotangents: dict) -> torch.Tensor:
        """Scalar ``S(params)`` with ``grad S == sum_k <cotangents[k], out_k>``
        (JAX ``ForceStressOutput.loss_surrogate``).

        For the derivative outputs the inner product is a jvp of the energy,

            <v_F, F> = -jvp_pos(sum E; v_F),  <v_V, virial> = -jvp_disp(sum E; v_V),
            <v_S, stress> = jvp_disp(sum E; v_S / vol),

        so ``S.backward()`` is one first-order reverse pass over the
        jvp-augmented energy graph (``GraphModule.jvp``): no force VJP and
        none of its residuals.  ``cotangents`` maps output fields to
        dL/d(field), detached; any other field must be an output of the
        energy graph.
        """
        if _keys.EDGE_VECTORS_KEY in data:
            raise NotImplementedError("loss_surrogate supports the positions/strain branch only")
        pos = data[_keys.POSITIONS_KEY].detach()
        has_cell = _keys.CELL_KEY in data
        batch = data.get(_keys.BATCH_KEY)
        if batch is None:
            batch = torch.zeros(pos.shape[0], dtype=torch.long, device=pos.device)
        orig_cell = data.get(_keys.CELL_KEY)
        deriv_keys = (_keys.FORCE_KEY, _keys.STRESS_KEY, _keys.VIRIAL_KEY)

        t_pos = torch.zeros_like(pos)
        t_disp = None
        if _keys.FORCE_KEY in cotangents:  # F = -dE/dpos
            t_pos = t_pos - cotangents[_keys.FORCE_KEY].to(pos.dtype)
        if _keys.VIRIAL_KEY in cotangents:  # virial = -dE/ddisp
            t_disp = -cotangents[_keys.VIRIAL_KEY].to(pos.dtype)
        if _keys.STRESS_KEY in cotangents:  # stress = (dE/ddisp) / vol
            if not has_cell:
                raise ValueError("a stress cotangent needs a cell")
            ts = (cotangents[_keys.STRESS_KEY] / _volumes(data)[:, None, None]).to(pos.dtype)
            t_disp = ts if t_disp is None else t_disp + ts

        # the strain parametrisation of forward, linearised at displacement 0:
        # d pos = t_pos + pos . sym(t_disp), d cell = cell . sym(t_disp)
        tangents = {}
        if t_disp is not None:
            sym_t = 0.5 * (t_disp + t_disp.transpose(-1, -2))
            t_pos = t_pos + per_frame_matmul(pos, sym_t, batch)
            if has_cell:
                cell = orig_cell.reshape(-1, 3, 3)
                tangents[_keys.CELL_KEY] = torch.einsum("fij,fjk->fik", cell, sym_t).reshape(orig_cell.shape)
        tangents[_keys.POSITIONS_KEY] = t_pos

        inner = dict(data)
        inner[_keys.POSITIONS_KEY] = pos
        out, t_out = self.func.jvp(inner, tangents)
        d_e = t_out[_keys.TOTAL_ENERGY_KEY].reshape(-1)
        if _keys.FRAME_MASK_KEY in data:
            d_e = torch.where(data[_keys.FRAME_MASK_KEY], d_e, torch.zeros_like(d_e))
        surrogate = d_e.sum()
        for k, v in cotangents.items():
            if k in deriv_keys:
                continue
            if k not in out:
                raise ValueError(
                    f"loss field {k!r} is not an output of the energy graph; fr supports losses on "
                    "energy-graph outputs and on forces, stress and virial"
                )
            surrogate = surrogate + (v * out[k]).sum()
        return surrogate


class PartialForceOutput(GraphModule):
    """The whole jacobian: ``partial_forces[j, i] = -dE_j/dpos_i`` over every
    node slot (padding included), and ``forces`` its sum over ``j`` (JAX
    ``PartialForceOutput``).  One backward per node slot: a tool for small
    systems."""

    def __init__(self, func: GraphModule):
        super().__init__()
        self.func = func
        self._init_irreps(irreps_in=dict(func.irreps_in), irreps_out=dict(func.irreps_out))
        self.irreps_out[_keys.PARTIAL_FORCE_KEY] = Irreps("1o")
        self.irreps_out[_keys.FORCE_KEY] = Irreps("1o")

    _jax_transparent = ("func",)

    def forward(self, data: dict) -> dict:
        with torch.enable_grad():
            pos = data[_keys.POSITIONS_KEY].detach().clone().requires_grad_(True)
            out = self.func(dict(data, **{_keys.POSITIONS_KEY: pos}))
            e = out[_keys.PER_ATOM_ENERGY_KEY].reshape(-1)
            rows = [torch.autograd.grad(e[j], pos, retain_graph=j + 1 < e.shape[0], allow_unused=True)[0]
                    for j in range(e.shape[0])]
        partial = -torch.stack([torch.zeros_like(pos) if r is None else r for r in rows])
        out = {k: (v.detach() if isinstance(v, torch.Tensor) else v) for k, v in out.items()}
        out[_keys.POSITIONS_KEY] = data[_keys.POSITIONS_KEY]
        out[_keys.PARTIAL_FORCE_KEY] = partial
        out[_keys.FORCE_KEY] = partial.sum(0)
        return out
