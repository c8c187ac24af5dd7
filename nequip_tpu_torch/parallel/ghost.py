"""Spatially decomposed (sharded-graph) serving and training over ranks.

Port of ``nequip_tpu/parallel/ghost.py``, one process per device: atoms are
partitioned into slabs, one per rank of the mesh's ``"graph"`` axis; each
rank owns its local atoms and holds *ghost* copies of the remote atoms (and
periodic images) within the interaction range.

As in the JAX package, ghost positions and ghost features are derived
inside the differentiated graph from their owners' arrays, through a
gather over the ranks (``_collectives.gather``) whose backward sums the
cotangents over the ranks: the reverse force and feature exchange (LAMMPS's
``reverse_exchange``) comes out of autograd, so forces on local atoms
include what other ranks computed through their ghost copies.  Per layer,
``MeshGhostExchange`` (swapped into every interaction block by
``enable_MeshGhostExchange``) refreshes the ghost rows of the features.

Each rank differentiates only its *local* energy and local force error; the
global energy is all-reduced outside the differentiated path (it enters the
loss gradient linearised), and the parameter gradients are all-reduced once
at the end.  An all-reduce inside the differentiated path would transpose
to another one and count contributions world-size times.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..data import _keys, round_up
from ..data._key_registry import register_fields
from ..data.neighborlist import neighbor_list
from ..nn.ghost_exchange import NoOpGhostExchange
from ..nn.interaction_block import InteractionBlock
from ..nn.module import GraphModule
from ..ops.kernels.tp_scatter import relayout_edge_stream
from . import _collectives as C
from .distributed import current_device
from .mesh import Mesh, make_mesh

GHOST_OWNER_DEV_KEY = "ghost_owner_dev"
GHOST_OWNER_IDX_KEY = "ghost_owner_idx"
GHOST_MASK_KEY = "ghost_mask"

register_fields(long_fields=[GHOST_OWNER_DEV_KEY, GHOST_OWNER_IDX_KEY])


# ---------------------------------------------------------------------------
# host-side spatial partitioner
# ---------------------------------------------------------------------------
def _unique_rows(keys: np.ndarray):
    """``(uniq, inverse)`` of integer rows, sorted lexicographically (the
    order of Python's ``sorted`` on tuples)."""
    if len(keys) == 0:
        return keys, np.zeros(0, dtype=np.int64)
    order = np.lexsort(keys.T[::-1])
    srt = keys[order]
    new = np.ones(len(srt), dtype=bool)
    new[1:] = (srt[1:] != srt[:-1]).any(axis=1)
    inverse = np.empty(len(keys), dtype=np.int64)
    inverse[order] = np.cumsum(new) - 1
    return srt[new], inverse


def spatial_partition(
    frame: dict,
    n_devices: int,
    r_max: float,
    pad_multiple: int = 128,
    caps: Optional[Dict[str, int]] = None,
) -> Dict[str, np.ndarray]:
    """Slab-partition a (periodic) frame along its longest cell axis.

    The JAX package's partition array for array (its Python loops over the
    edges vectorised with numpy).  Returns stacked per-rank arrays (leading
    dim = rank):
      local_pos (D, L, 3), local_types (D, L), local_mask (D, L),
      ghost_owner_dev/idx (D, G), ghost_types (D, G), ghost_shift (D, G, 3),
      ghost_mask (D, G), edge_index (D, 2, E) with dst in [0, L) and src in
      [0, L+G), edge_mask (D, E), local_index_global (D, L), cell (3, 3),
    plus ``caps`` = {L, G, E}.  Ghosts of a rank are its edges' remote
    (source atom, cell shift) pairs in sorted order; padded edges point at
    local slot L-1 and are masked.
    """
    pos = np.asarray(frame[_keys.POSITIONS_KEY], dtype=np.float64)
    types = np.asarray(frame[_keys.ATOM_TYPE_KEY]).reshape(-1)
    cell = np.asarray(frame[_keys.CELL_KEY]).reshape(3, 3)
    pbc = np.asarray(frame.get(_keys.PBC_KEY, np.ones(3, bool))).reshape(-1)
    n = pos.shape[0]

    axis = int(np.argmax(np.linalg.norm(cell, axis=1)))
    inv = np.linalg.inv(cell)
    fracs = (pos @ inv)[:, axis] % 1.0
    slab_of = np.minimum((fracs * n_devices).astype(int), n_devices - 1)

    edge_index, shifts = neighbor_list(pos, r_max, cell=cell, pbc=pbc)
    dst_dev = slab_of[edge_index[0]]

    local_idx = [np.nonzero(slab_of == d)[0] for d in range(n_devices)]
    g2l = np.full(n, -1, dtype=np.int64)
    for d in range(n_devices):
        g2l[local_idx[d]] = np.arange(len(local_idx[d]))

    per_dev = []
    max_local = max(len(li) for li in local_idx)
    max_ghost = 1
    max_edges = 1
    for d in range(n_devices):
        esel = np.nonzero(dst_dev == d)[0]
        e = edge_index[:, esel]
        s = shifts[esel]
        is_remote = (slab_of[e[1]] != d) | (np.abs(s).sum(axis=1) > 0)
        keys = np.concatenate([e[1][is_remote, None].astype(np.int64), s[is_remote].astype(np.int64)], axis=1)
        uniq, inverse = _unique_rows(keys)
        n_loc = len(local_idx[d])
        e_src = g2l[e[1]]
        e_src[is_remote] = n_loc + inverse
        per_dev.append(dict(local=local_idx[d], ghosts=uniq, e_dst=g2l[e[0]], e_src=e_src))
        max_ghost = max(max_ghost, len(uniq))
        max_edges = max(max_edges, e.shape[1])

    if caps is not None:
        # shared capacities (the 2-D dp x graph layout needs identical shapes)
        if not (caps["L"] >= max_local and caps["G"] >= max_ghost and caps["E"] >= max_edges):
            raise ValueError(f"caps {caps} too small for (L={max_local}, G={max_ghost}, E={max_edges})")
        L, G, E = caps["L"], caps["G"], caps["E"]
    else:
        L = round_up(max_local, pad_multiple)
        G = round_up(max_ghost, pad_multiple)
        E = round_up(max_edges, 2 * pad_multiple)

    out = {
        "local_pos": np.zeros((n_devices, L, 3)),
        "local_types": np.zeros((n_devices, L), dtype=np.int32),
        "local_mask": np.zeros((n_devices, L), dtype=bool),
        "ghost_owner_dev": np.zeros((n_devices, G), dtype=np.int32),
        "ghost_owner_idx": np.zeros((n_devices, G), dtype=np.int32),
        "ghost_types": np.zeros((n_devices, G), dtype=np.int32),
        "ghost_shift": np.zeros((n_devices, G, 3)),
        "ghost_mask": np.zeros((n_devices, G), dtype=bool),
        "edge_index": np.full((n_devices, 2, E), 0, dtype=np.int32),
        "edge_mask": np.zeros((n_devices, E), dtype=bool),
        "cell": cell,
        "caps": {"L": L, "G": G, "E": E},
        "local_index_global": np.zeros((n_devices, L), dtype=np.int64),
    }
    for d, pd in enumerate(per_dev):
        li, atoms, n_loc, ng = pd["local"], pd["ghosts"][:, 0], len(pd["local"]), len(pd["ghosts"])
        out["local_pos"][d, :n_loc] = pos[li]
        out["local_types"][d, :n_loc] = types[li]
        out["local_mask"][d, :n_loc] = True
        out["local_index_global"][d, :n_loc] = li
        out["ghost_owner_dev"][d, :ng] = slab_of[atoms]
        out["ghost_owner_idx"][d, :ng] = g2l[atoms]
        out["ghost_types"][d, :ng] = types[atoms]
        out["ghost_shift"][d, :ng] = pd["ghosts"][:, 1:] @ cell
        out["ghost_mask"][d, :ng] = True
        ne = len(pd["e_dst"])
        out["edge_index"][d, :, ne:] = L - 1
        out["edge_index"][d, 0, :ne] = pd["e_dst"]
        src = pd["e_src"].copy()
        remote = src >= n_loc
        src[remote] = L + (src[remote] - n_loc)  # ghost slots follow the L local ones
        out["edge_index"][d, 1, :ne] = src
        out["edge_mask"][d, :ne] = True
    return out


# ---------------------------------------------------------------------------
# in-graph ghost refresh (per conv layer)
# ---------------------------------------------------------------------------
class MeshGhostExchange(GraphModule):
    """Replace the ghost rows of ``field`` by their owners' current rows."""

    def __init__(self, field: str, group, n_local_cap: int, irreps_in=None):
        super().__init__()
        self.field = field
        self.group = group
        self.n_local_cap = int(n_local_cap)
        self._init_irreps(irreps_in=irreps_in)

    def forward(self, data: dict) -> dict:
        local = data[self.field][: self.n_local_cap]
        ghost = C.gather_rows(local, self.group, data[GHOST_OWNER_DEV_KEY], data[GHOST_OWNER_IDX_KEY],
                              data[GHOST_MASK_KEY])
        return dict(data, **{self.field: torch.cat([local, ghost], dim=0)})

    def __deepcopy__(self, memo):
        # a process group is not copied: the copy (an EMA model) exchanges over the same ranks
        return MeshGhostExchange(self.field, self.group, self.n_local_cap, dict(self.irreps_in))


def enable_MeshGhostExchange(model: torch.nn.Module, group, n_local_cap: int):
    """Swap every interaction block's ghost exchange for the mesh one over ``group``."""
    for m in model.modules():
        if isinstance(m, InteractionBlock):
            m.ghost_exchange = MeshGhostExchange(_keys.NODE_FEATURES_KEY, group, n_local_cap)
    return model


def disable_MeshGhostExchange(model: torch.nn.Module):
    """Restore the no-op ghost exchange (single-device use of the model)."""
    for m in model.modules():
        if isinstance(m, InteractionBlock) and isinstance(m.ghost_exchange, MeshGhostExchange):
            m.ghost_exchange = NoOpGhostExchange(field=_keys.NODE_FEATURES_KEY)
    return model


# ---------------------------------------------------------------------------
# one rank's slab of a partitioned frame, as the energy graph reads it
# ---------------------------------------------------------------------------
class Slab:
    """This rank's arrays of a partition (on ``device``) and the builders of
    the energy graph's inputs; ``group`` is the graph axis's process group."""

    def __init__(self, arrays: Dict[str, np.ndarray], caps: Dict[str, int], group, device):
        self.caps, self.group = caps, group
        t = {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}
        self.local_pos = t["local_pos"].to(torch.float64)
        self.gshift = t["ghost_shift"].to(torch.float64)
        self.local_mask, self.gmask = t["local_mask"], t["ghost_mask"]
        self.gdev, self.gidx = t["ghost_owner_dev"].long(), t["ghost_owner_idx"].long()
        L, G = caps["L"], caps["G"]
        self.fixed = {
            _keys.ATOM_TYPE_KEY: torch.cat([t["local_types"], t["ghost_types"]]).long(),
            _keys.EDGE_INDEX_KEY: t["edge_index"].long(),
            _keys.EDGE_MASK_KEY: t["edge_mask"],
            _keys.NODE_MASK_KEY: torch.cat([self.local_mask, self.gmask]),
            _keys.BATCH_KEY: torch.zeros(L + G, dtype=torch.long, device=device),
            _keys.NUM_NODES_KEY: torch.tensor([L + G], dtype=torch.long, device=device),
            _keys.FRAME_MASK_KEY: torch.ones(1, dtype=torch.bool, device=device),
            GHOST_OWNER_DEV_KEY: self.gdev,
            GHOST_OWNER_IDX_KEY: self.gidx,
            GHOST_MASK_KEY: self.gmask,
        }
        self._layout = None

    def pos_full(self, pos_local: torch.Tensor) -> torch.Tensor:
        """Local positions and the ghosts' (owners' positions plus the cell shift)."""
        ghost = C.gather_rows(pos_local, self.group, self.gdev, self.gidx) + self.gshift
        return torch.cat([pos_local, ghost], dim=0)

    def tangent_full(self, v: torch.Tensor) -> torch.Tensor:
        """The global tangent: the local ``v`` and the ghosts' owners' ``v``."""
        with torch.no_grad():
            return torch.cat([v, C.gather_rows(v, self.group, self.gdev, self.gidx)], dim=0)

    def data(self, model, pos_full: torch.Tensor) -> dict:
        data = dict(self.fixed, **{_keys.POSITIONS_KEY: pos_full})
        if getattr(model, "uses_fused_kernels", False):
            if self._layout is None:  # the edge stream in kernel order: fixed per slab
                self._layout = relayout_edge_stream(self.fixed)
            data.update(self._layout)
        return data

    def local_e_sum(self, out: dict) -> torch.Tensor:
        e_atom = out[_keys.PER_ATOM_ENERGY_KEY][: self.caps["L"]].reshape(-1)
        return torch.where(self.local_mask, e_atom, torch.zeros_like(e_atom)).sum()

    def local_t_sum(self, t_out: dict) -> torch.Tensor:
        t_atom = t_out[_keys.PER_ATOM_ENERGY_KEY][: self.caps["L"]].reshape(-1)
        return torch.where(self.local_mask, t_atom, torch.zeros_like(t_atom)).sum()

    def energy_and_neg_forces(self, model, create_graph: bool):
        """``(local energy, dE/dpos_local)``: the local energy's gradient,
        which the gathers' backward completes with the other ranks' terms."""
        with torch.enable_grad():
            pos = self.local_pos.detach().requires_grad_(True)
            e_local = self.local_e_sum(energy_net(model)(self.data(model, self.pos_full(pos))))
            (neg_f,) = torch.autograd.grad(e_local, pos, create_graph=create_graph)
        return e_local, neg_f

    def dual_sweep(self, model, v: torch.Tensor):
        """``(local energy, <local energies' jvp along the global tangent>)``:
        the fr pass over the energy graph, with the ghosts' tangents their
        owners' ``v`` (the cross-rank force coupling)."""
        with torch.no_grad():
            pos_full = self.pos_full(self.local_pos)
        with torch.enable_grad():
            out, t_out = energy_net(model).jvp(self.data(model, pos_full), {_keys.POSITIONS_KEY: self.tangent_full(v)})
        return self.local_e_sum(out), self.local_t_sum(t_out)

    def scatter_global(self, local_rows: torch.Tensor, index_global: np.ndarray, n: int) -> torch.Tensor:
        """``[n, *]`` rows in the global atom order, from every rank's local rows."""
        mask = self.local_mask
        out = local_rows.new_zeros((n,) + tuple(local_rows.shape[1:]))
        idx = torch.as_tensor(index_global, device=local_rows.device)[mask]
        out[idx] = local_rows[mask]
        return C.all_reduce(out, self.group)


def energy_net(model) -> GraphModule:
    """The energy graph under the model's force output (JAX ``model.model.func``)."""
    return model.model.func


def trainable(model) -> list:
    return [(k, p) for k, p in model.jax_named_tensors() if isinstance(p, torch.nn.Parameter) and p.requires_grad]


# ---------------------------------------------------------------------------
# sharded serving and training of one frame
# ---------------------------------------------------------------------------
class ShardedGraphEvaluator:
    """Energy and forces, or the exact loss gradient, for one large frame
    slab-partitioned over the ranks of ``mesh``'s ``axis_name`` axis.

    Every rank calls with the whole frame (each partitions it the same
    way) and gets the global results.
    """

    def __init__(self, model, mesh: Optional[Mesh] = None, axis_name: str = "graph",
                 force_grad_mode: str = "rr", device=None, fr_edge_chunks: int = 0):
        if force_grad_mode not in ("rr", "fr"):
            raise ValueError(f"force_grad_mode must be 'rr' or 'fr', got {force_grad_mode!r}")
        if fr_edge_chunks and (force_grad_mode != "fr" or not getattr(model, "uses_fused_kernels", False)):
            raise ValueError("fr_edge_chunks needs force_grad_mode='fr' and a kernel tp_impl ('fused' or 'fused_tp')")
        self.fr_edge_chunks = int(fr_edge_chunks)
        self.mesh = mesh if mesh is not None else make_mesh(axis_names=(axis_name,))
        self.axis_name = axis_name
        self.group = self.mesh.group(axis_name)
        self.model = model
        self.device = torch.device(device) if device is not None else current_device()
        self.force_grad_mode = force_grad_mode
        self.caps: Optional[Dict[str, int]] = None  # the last frame's {L, G, E}

    def prepare(self, frame: dict, r_max: Optional[float] = None):
        """Partition ``frame`` and install the mesh exchange at its caps (on
        every call: the model may have been disabled or re-enabled since)."""
        r_max = r_max if r_max is not None else float(self.model.r_max)
        parts = spatial_partition(frame, self.mesh.shape[self.axis_name], r_max)
        self.caps = parts["caps"]
        enable_MeshGhostExchange(self.model, self.group, self.caps["L"])
        return parts

    def _slab(self, parts) -> Slab:
        d = self.mesh.coords[self.axis_name]
        keys = ("local_pos", "local_types", "local_mask", "ghost_owner_dev", "ghost_owner_idx", "ghost_types",
                "ghost_shift", "ghost_mask", "edge_index", "edge_mask")
        return Slab({k: parts[k][d] for k in keys}, parts["caps"], self.group, self.device)

    def evaluate(self, frame: dict):
        """``(energy, forces [n, 3])`` of the frame, with frozen weights (the
        serving kernels)."""
        from ..train.training_module import frozen_weights

        parts = self.prepare(frame)
        slab = self._slab(parts)
        with frozen_weights(self.model) as model:
            e_local, neg_f = slab.energy_and_neg_forces(model, create_graph=False)
        energy = C.all_reduce(e_local, self.group)
        d = self.mesh.coords[self.axis_name]
        n = np.asarray(frame[_keys.POSITIONS_KEY]).shape[0]
        forces = slab.scatter_global(-neg_f.detach(), parts["local_index_global"][d], n)
        return float(energy), forces.cpu().numpy()

    def loss_and_grad(self, frame: dict, energy_ref: float, forces_ref, energy_coeff: float = 1.0,
                      force_coeff: float = 1.0):
        """``(loss, {JAX path: gradient})`` for one sharded frame, exact:

            L = energy_coeff * ((E - E_ref) / N)^2 + force_coeff * mean_{i,a} (F_ia - F_ref_ia)^2

        rr: forces with ``create_graph=True`` and one reverse pass over them
        (reverse over reverse, through the gathers' backward); fr: pass 1
        with frozen weights, then the dual sweep of the energy graph with
        the global tangent (the local force cotangent and, through the
        ghosts, the other ranks'), over ``fr_edge_chunks`` slices of each
        rank's edge stream when given.  The gradients are all-reduced at the
        end.
        """
        parts = self.prepare(frame)
        slab = self._slab(parts)
        d = self.mesh.coords[self.axis_name]
        n_atoms = int(parts["local_mask"].sum())
        ce, cf = float(energy_coeff), float(force_coeff)
        m = parts["local_mask"][d]
        f_ref = np.zeros((parts["caps"]["L"], 3))
        f_ref[m] = np.asarray(forces_ref, dtype=np.float64)[parts["local_index_global"][d][m]]
        f_ref = torch.as_tensor(f_ref, device=self.device)
        mask3 = slab.local_mask[:, None]
        model = self.model
        names, params = zip(*trainable(model))

        if self.force_grad_mode == "fr":
            from ..train.training_module import edge_chunks, frozen_weights

            with edge_chunks(model, self.fr_edge_chunks):
                with frozen_weights(model):
                    e0, neg_f0 = slab.energy_and_neg_forces(model, create_graph=False)
                de = (C.all_reduce(e0, self.group) - energy_ref) / n_atoms
                fe0 = torch.where(mask3, -neg_f0 - f_ref, torch.zeros_like(f_ref))
                sse_f = (fe0 * fe0).sum()
                e_local, d_e = slab.dual_sweep(model, ((2.0 * cf / (3.0 * n_atoms)) * fe0).detach())
                with torch.enable_grad():
                    grads = torch.autograd.grad(ce * 2.0 * de / n_atoms * e_local - d_e, params, allow_unused=True)
        else:
            with torch.enable_grad():
                e_local, neg_f = slab.energy_and_neg_forces(model, create_graph=True)
                de = (C.all_reduce(e_local, self.group) - energy_ref) / n_atoms
                fe = torch.where(mask3, -neg_f - f_ref, torch.zeros_like(f_ref))
                sse_f = (fe * fe).sum()
                sur = ce * 2.0 * de / n_atoms * e_local + cf * sse_f / (3.0 * n_atoms)
                grads = torch.autograd.grad(sur, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g.detach() for g, p in zip(grads, params)]
        grads = C.all_reduce_grads(grads, self.group)
        loss = ce * de**2 + cf * C.all_reduce(sse_f, self.group) / (3.0 * n_atoms)
        return float(loss), dict(zip(names, grads))
