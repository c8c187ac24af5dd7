"""2-D training: data parallel x spatially sharded graphs (``("dp", "graph")``).

Port of ``nequip_tpu/parallel/spatial_train.py``, one process per device:
a ``Mesh((n_dp, n_graph), ("dp", "graph"))`` of ranks takes ``n_dp``
frames a step, each slab-partitioned over the ``n_graph`` ranks of its row
with the in-graph ghost exchange of ``parallel/ghost.py``.  The gradients
are exact: each rank differentiates only local quantities (the gathers'
backward routes the cross-rank force terms), and one all-reduce over both
axes gives the global loss gradient.

``SpatialTrainModule`` plugs into the ordinary ``Trainer`` loop (its
``training_step`` and ``evaluation_step``) and accumulates the same
running loss and metric sums as ``EnergyForceLoss(per_atom_energy=True)``
over the same frames, so losses, epoch metrics, checkpoints and LR
scheduling work unchanged; the optimizer is handed the loss formed from
the merged sums (JAX ``value=loss``); ``SpatialFrameDataModule`` and
``SpatialFrameLoader`` hand each rank its slab of its frame.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..data import _keys
from ..train.training_module import EMATrainModule, NequIPTrainModule, edge_chunks, frozen_weights
from . import _collectives as C
from .distributed import current_device
from .ghost import Slab, enable_MeshGhostExchange, spatial_partition
from .mesh import Mesh, device_count

_ARR_KEYS = (
    "local_pos", "local_types", "local_mask", "ghost_owner_dev",
    "ghost_owner_idx", "ghost_shift", "ghost_mask", "ghost_types",
    "edge_index", "edge_mask",
)


def make_2d_mesh(n_dp: int, n_graph: int) -> Mesh:
    return Mesh((n_dp, n_graph), ("dp", "graph"))


def prepare_spatial_batch(
    frames: Sequence[dict],
    mesh: Mesh,
    r_max: float,
    caps: Optional[Dict[str, int]] = None,
    dp_axis: str = "dp",
    graph_axis: str = "graph",
    device=None,
):
    """``(batch, caps)``: this rank's slab of its frame among ``n_dp`` labelled
    frames, on ``device``.

    ``batch`` = {"arrays": {partition array: this rank's row}, "e_ref" (its
    frame's energy), "n_atoms" (its frame's atoms), "f_ref" ([L, 3] the
    reference forces of its local atoms)}.  Without ``caps`` every frame is
    partitioned and the capacities are their maxima (shared by all ranks).
    """
    n_dp, n_graph = mesh.shape[dp_axis], mesh.shape[graph_axis]
    if len(frames) != n_dp:
        raise ValueError(f"need {n_dp} frames per step, got {len(frames)}")
    i, j = mesh.coords[dp_axis], mesh.coords[graph_axis]
    if caps is None:
        parts = [spatial_partition(dict(f), n_graph, r_max) for f in frames]
        caps = {k: max(p["caps"][k] for p in parts) for k in ("L", "G", "E")}
        part = parts[i] if parts[i]["caps"] == caps else None
    else:
        part = None
    if part is None:  # ghost slot indices in edge_index depend on L: partition anew, not re-pad
        part = spatial_partition(dict(frames[i]), n_graph, r_max, caps=caps)
    device = torch.device(device) if device is not None else current_device()
    frame = frames[i]
    m = part["local_mask"][j]
    f_ref = np.zeros((caps["L"], 3))
    f_ref[m] = np.asarray(frame[_keys.FORCE_KEY], dtype=np.float64)[part["local_index_global"][j][m]]
    batch = {
        "arrays": {k: torch.as_tensor(part[k][j], device=device) for k in _ARR_KEYS},
        "e_ref": torch.tensor(float(np.asarray(frame[_keys.TOTAL_ENERGY_KEY]).reshape(-1)[0]), dtype=torch.float64,
                              device=device),
        "n_atoms": torch.tensor(int(np.asarray(frame[_keys.POSITIONS_KEY]).shape[0]), device=device),
        "f_ref": torch.as_tensor(f_ref, device=device),
    }
    return batch, caps


class SpatialTrainModule(NequIPTrainModule):
    """Train on a 2-D (dp x graph) mesh of ranks through the standard
    Trainer loop, with the loss of ``EnergyForceLoss`` over the same frames
    (MSE energy and force entries; metrics of energy and forces)."""

    def __init__(self, *args, mesh: Optional[Mesh] = None, dp_axis: str = "dp", graph_axis: str = "graph",
                 **kwargs):
        super().__init__(*args, **kwargs)
        if mesh is None:
            n = device_count()
            mesh = make_2d_mesh(max(1, n // 2), 2 if n >= 2 else 1)
        self.mesh = mesh
        self.dp_axis = dp_axis
        self.graph_axis = graph_axis
        self._check_entries(self.loss, is_loss=True)
        self._check_entries(self.val_metrics, is_loss=False)

    @staticmethod
    def _check_entries(mgr, is_loss: bool):
        if mgr is None:
            return
        for e in mgr.entries:
            if e["per_type"]:
                raise ValueError("per_type entries are not supported on the 2-D mesh")
            if e["mod"].field not in (_keys.TOTAL_ENERGY_KEY, _keys.FORCE_KEY):
                raise ValueError(f"2-D mesh training supports energy and forces entries, got {e['mod'].field}")
            if is_loss and e["coeff"] and e["metric"] != "mse":
                raise ValueError("2-D mesh loss gradients are implemented for MSE entries")

    def _slab(self, batch) -> Slab:
        """This rank's slab of ``batch``, with the mesh exchange installed at
        its caps (on every call: the models may have been disabled since)."""
        a = batch["arrays"]
        caps = {"L": a["local_pos"].shape[0], "G": a["ghost_mask"].shape[0], "E": a["edge_mask"].shape[0]}
        for m in {id(m): m for m in (self.model, self.evaluation_model())}.values():
            enable_MeshGhostExchange(m, self.mesh.group(self.graph_axis), caps["L"])
        return Slab(a, caps, self.mesh.group(self.graph_axis), a["local_pos"].device)

    # -- per-rank computation ---------------------------------------------
    def _device_sums(self, model, batch, mgr, with_grads: bool, coeffs=None):
        """Merged masked error sums (and, training, the all-reduced loss
        gradients in the parameters' ``.grad``)."""
        slab = self._slab(batch)
        graph, world = self.mesh.group(self.graph_axis), self.mesh.group((self.dp_axis, self.graph_axis))
        n_dp, n_gr = self.mesh.shape[self.dp_axis], self.mesh.shape[self.graph_axis]
        e_ref, f_ref = batch["e_ref"], batch["f_ref"]
        nf = batch["n_atoms"].to(torch.float64)
        mask3 = slab.local_mask[:, None]
        n_tot = C.all_reduce(slab.local_mask.sum().to(torch.float64), world)

        def sums_of(e_local, fe):
            de_raw = C.all_reduce(e_local, graph) - e_ref
            de_pa = de_raw / nf
            fe = fe.detach()

            def energy_sums(de):
                # a frame's energy sums are the same on each rank of its row:
                # divided by n_graph, the sum over both axes counts it once
                return {"abs": de.abs() / n_gr, "sq": de**2 / n_gr, "count": torch.ones_like(de) / n_gr,
                        "max": de.abs()}

            force_sums = {"abs": fe.abs().sum(), "sq": (fe * fe).sum(),
                          "count": 3.0 * slab.local_mask.sum().to(fe.dtype), "max": fe.abs().max()}
            bs = {}
            for e in mgr.entries:
                if e["mod"].field == _keys.TOTAL_ENERGY_KEY:
                    bs[e["name"]] = energy_sums(de_pa if "per_atom" in e["name"] else de_raw)
                else:
                    bs[e["name"]] = force_sums
            merged = {
                name: {k: C.all_reduce(v, world, op=torch.distributed.ReduceOp.MAX if k == "max" else
                                       torch.distributed.ReduceOp.SUM) for k, v in s.items()}
                for name, s in bs.items()
            }
            return merged, de_raw, de_pa

        if not with_grads:
            with frozen_weights(model):
                e_local, neg_f = slab.energy_and_neg_forces(model, create_graph=False)
            return sums_of(e_local, torch.where(mask3, -neg_f - f_ref, torch.zeros_like(f_ref)))[0]

        c_pa = c_raw = c_f = 0.0
        for c, e in zip(coeffs, mgr.entries):
            if e["mod"].field == _keys.TOTAL_ENERGY_KEY:
                if "per_atom" in e["name"]:
                    c_pa += float(c)
                else:
                    c_raw += float(c)
            else:
                c_f += float(c)
        params = [p for _, p in self.named_trainable()]

        if self.force_grad_mode == "fr":
            # pass 1 first order; the force term's gradient is then -grad_p of
            # a directional derivative of the energy graph along the GLOBAL
            # tangent: the local cotangent v and the other ranks' through the ghosts
            with edge_chunks(model, self.fr_edge_chunks):
                with frozen_weights(model):
                    e0, neg_f0 = slab.energy_and_neg_forces(model, create_graph=False)
                fe0 = torch.where(mask3, -neg_f0 - f_ref, torch.zeros_like(f_ref))
                bs, de_raw, de_pa = sums_of(e0, fe0)
                e_local, d_e = slab.dual_sweep(model, ((2.0 * c_f / (3.0 * n_tot)) * fe0).detach())
                with torch.enable_grad():
                    sur = (c_pa * 2.0 * de_pa / nf + c_raw * 2.0 * de_raw) / n_dp * e_local - d_e
                    grads = torch.autograd.grad(sur, params, allow_unused=True)
        else:
            with torch.enable_grad():
                e_local, neg_f = slab.energy_and_neg_forces(model, create_graph=True)
                fe = torch.where(mask3, -neg_f - f_ref, torch.zeros_like(f_ref))
                bs, de_raw, de_pa = sums_of(e_local.detach(), fe)
                # the exact local terms of the GLOBAL loss's gradient:
                #   loss = c_pa sum_f de_pa^2 / n_dp + c_raw sum_f de_raw^2 / n_dp + c_f sum sse / (3 N_tot)
                sur = ((c_pa * 2.0 * de_pa / nf + c_raw * 2.0 * de_raw) / n_dp * e_local
                       + c_f * (fe * fe).sum() / (3.0 * n_tot))
                grads = torch.autograd.grad(sur, params, allow_unused=True)
        for p, g in zip(params, grads):
            p.grad = None if g is None else g.detach()
        self._all_reduce_grads(world)
        return bs

    # -- steps ---------------------------------------------------------------
    def training_step(self, batch: dict, loss_coeffs: Optional[Sequence[float]] = None, group=None):
        """One step on this rank's slab (``group`` is unused: the mesh's
        groups carry every collective)."""
        self._check_sole_model()
        self.optimizer.zero_grad(set_to_none=True)
        coeffs = self._coeffs(loss_coeffs)
        bs = self._device_sums(self.model, batch, self.loss, with_grads=True, coeffs=coeffs)
        loss, values = self.loss.values(bs, coeffs)  # the merged loss, which the optimizer may read
        return self._apply_update(bs, values, loss.detach())

    def evaluation_step(self, metrics, state, batch: dict, group=None):
        self._check_entries(metrics, is_loss=False)
        return metrics.accumulate(state, self._device_sums(self.evaluation_model(), batch, metrics, False)), None


class EMASpatialTrainModule(SpatialTrainModule, EMATrainModule):
    """2-D training with EMA evaluation weights."""


# ---------------------------------------------------------------------------
# data plumbing: frames -> each rank's slab, through the Trainer loop
# ---------------------------------------------------------------------------
class SpatialFrameLoader:
    """Yields this rank's slab of each step's ``n_dp`` labelled frames.

    Frames carry total_energy and forces labels; the capacities are scanned
    once over the dataset, so every batch has one set of shapes.
    """

    def __init__(self, dataset, mesh: Mesh, r_max: float, shuffle: bool = False, seed: int = 0,
                 dp_axis: str = "dp", graph_axis: str = "graph", device=None):
        self.dataset = dataset
        self.mesh = mesh
        self.r_max = float(r_max)
        self.shuffle = shuffle
        self.seed = int(seed)
        self.dp_axis = dp_axis
        self.graph_axis = graph_axis
        self.device = device
        self.n_dp = mesh.shape[dp_axis]
        self.n_graph = mesh.shape[graph_axis]
        self._epoch = 0
        self._caps = None

    @property
    def caps(self) -> Dict[str, int]:
        if self._caps is None:
            caps = {"L": 1, "G": 1, "E": 1}
            for i in range(len(self.dataset)):
                p = spatial_partition(dict(self.dataset[i]), self.n_graph, self.r_max)
                caps = {k: max(caps[k], p["caps"][k]) for k in caps}
            self._caps = caps
        return self._caps

    def __len__(self) -> int:
        return (len(self.dataset) + self.n_dp - 1) // self.n_dp

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.RandomState(self.seed + self._epoch).permutation(n)
        return np.arange(n)

    def __iter__(self):
        order = self._order()
        for start in range(0, len(order), self.n_dp):
            idx = order[start: start + self.n_dp]
            # a short tail repeats the last frame, whose loss is NOT masked
            # (a spatial batch has no frame mask): keep the dataset size
            # divisible by n_dp for exact semantics
            while len(idx) < self.n_dp:
                idx = np.concatenate([idx, idx[-1:]])
            frames = [self.dataset[i] for i in idx]
            yield prepare_spatial_batch(frames, self.mesh, self.r_max, caps=self.caps, dp_axis=self.dp_axis,
                                        graph_axis=self.graph_axis, device=self.device)[0]
        self._epoch += 1

    def state_dict(self) -> dict:
        return {"epoch": self._epoch}

    def load_state_dict(self, state: dict) -> None:
        self._epoch = int(state["epoch"])


class SpatialFrameDataModule:
    """Minimal data module serving ``SpatialFrameLoader``s to the Trainer."""

    def __init__(self, train_dataset, mesh: Mesh, r_max: float, val_dataset=None, seed: int = 0,
                 shuffle: bool = True, device=None):
        self.mesh = mesh
        self.r_max = r_max
        self.seed = seed
        self._train = SpatialFrameLoader(train_dataset, mesh, r_max, shuffle=shuffle, seed=seed, device=device)
        self._val = [SpatialFrameLoader(val_dataset, mesh, r_max, device=device)] if val_dataset is not None else []

    def setup(self, stage=None) -> None:
        pass

    def train_dataloader(self):
        return self._train

    def val_dataloaders(self):
        return self._val

    def test_dataloaders(self):
        return self._val
