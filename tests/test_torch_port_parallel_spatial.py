"""The port's 2-D (dp x graph) training against the JAX package, float64.

``SpatialTrainModule`` on a (2, 2) mesh of four gloo ranks (spawned
processes, ``torch_port_parallel_ranks``): one epoch through the port's
``Trainer`` over four 64-atom LJ frames (two steps of two frames, each
frame in two slabs), val on the same frames, in rr, in fr and in rr
under ``optax.polyak_sgd`` (whose step reads the loss formed from the sums
merged over the mesh).  Each step's
loss, the epoch's train and val metrics and the parameters after every
step equal those of JAX's ``SpatialTrainModule`` on ``make_2d_mesh(2, 2)``
through its ``Trainer`` to 1e-10 (relative for losses and metrics, of the
tensor's max for parameters), on every rank alike; fr also over 2 edge
slices of each slab (``fr_edge_chunks``; the same numbers).

Tolerance: float64 sums in another order (cross-rank sums, second
derivatives, Adam).
"""

import jax
import numpy as np
import pytest

from nequip_tpu.data.dataset import LJTestDataset as JLJ
from nequip_tpu.data.transforms import ChemicalSpeciesToAtomTypeMapper as JMapper
from nequip_tpu.data.transforms import NeighborListTransform as JNL
from nequip_tpu.model import NequIPGNNModel as JModel
from nequip_tpu.parallel import SpatialFrameDataModule as JSpatialDM
from nequip_tpu.parallel import SpatialTrainModule as JSpatialModule
from nequip_tpu.parallel import make_2d_mesh as j_make_2d_mesh
from nequip_tpu.train import EnergyForceLoss as JLoss
from nequip_tpu.train import EnergyForceMetrics as JMetrics
from nequip_tpu.train import Trainer as JTrainer

from nequip_tpu_torch.data import DataLoader
from nequip_tpu_torch.model import NequIPGNNModel, flatten_tree
from nequip_tpu_torch.parallel import (
    EMASpatialTrainModule, SpatialFrameLoader, disable_MeshGhostExchange, make_2d_mesh,
)
from nequip_tpu_torch.train import EMATrainModule, EnergyForceLoss

from torch_port_parallel_ranks import (
    METRIC_KEYS, MODES, OPT, R_MAX, SPATIAL_MODEL, JaxStepRecorder, close_params, lj_dataset, run_ranks, spatial_checks,
    tensors_np,
)


@pytest.fixture(scope="module")
def jax_fits(tmp_path_factory):
    params = flatten_tree(jax.tree.map(np.asarray, JModel(**SPATIAL_MODEL).init_params()))
    out = {"params": params}
    for mode, (force_grad_mode, optimizer) in MODES.items():
        ds = JLJ(supercell=(4, 2, 2), num_frames=4, seed=3,
                 transforms=[JMapper(chemical_symbols=["Cu"]), JNL(r_max=R_MAX)])
        mesh = j_make_2d_mesh(2, 2)
        module = JSpatialModule(model=JModel(**SPATIAL_MODEL), loss=JLoss(per_atom_energy=True), val_metrics=JMetrics(),
                                optimizer=optimizer, mesh=mesh, force_grad_mode=force_grad_mode)
        rec = JaxStepRecorder()
        trainer = JTrainer(max_epochs=1, callbacks=[rec], ckpt_dir=str(tmp_path_factory.mktemp(mode)))
        trainer.fit(module, JSpatialDM(train_dataset=ds, val_dataset=ds, mesh=mesh, r_max=R_MAX, shuffle=False))
        out[mode] = {"steps": rec.steps, "metrics": trainer._metrics_rows[-1]}
    return out


@pytest.fixture(scope="module")
def ranks(jax_fits, tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial")
    return run_ranks(spatial_checks, 4, root, jax_fits["params"], str(root / "ckpt"))


@pytest.mark.parametrize("mode", ["rr", "fr", "fr2", "polyak"])
def test_2d_mesh_steps_match_jax(jax_fits, ranks, mode):
    want = jax_fits["fr" if mode == "fr2" else mode]
    assert sorted((r["coords"]["dp"], r["coords"]["graph"]) for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for res in ranks:
        got = res[mode]
        assert len(got["steps"]) == len(want["steps"]) == 2
        for g, w in zip(got["steps"], want["steps"]):
            assert g["loss"] == pytest.approx(w["loss"], rel=1e-10)
            close_params(g["params"], w["params"], "step")


@pytest.mark.parametrize("mode", ["rr", "fr", "fr2", "polyak"])
def test_2d_mesh_epoch_metrics_match_jax(jax_fits, ranks, mode):
    want = {k: v for k, v in jax_fits["fr" if mode == "fr2" else mode]["metrics"].items() if k.startswith(METRIC_KEYS)}
    assert len(want) > 4
    for res in ranks:
        got = res[mode]["metrics"]
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-10, abs=1e-14), k


def test_ema_module_on_one_process_matches_the_single_device_module():
    """``EMASpatialTrainModule`` on a (1, 1) mesh in one process (no group:
    the collectives are the identity, the ghosts the frame's own periodic
    images) takes the ``EMATrainModule`` steps: losses, parameters and EMA
    parameters to 1e-10, also when ``disable_MeshGhostExchange`` took the
    exchange out of both models before the second step (the module
    installs it again on every step)."""
    ds = lj_dataset(2, seed=3, supercell=(4, 2, 2))
    mesh = make_2d_mesh(1, 1)
    kw = dict(loss=EnergyForceLoss(per_atom_energy=True), optimizer=OPT, ema_decay=0.9, device="cpu")
    sp = EMASpatialTrainModule(NequIPGNNModel(tp_impl="fused", **SPATIAL_MODEL), mesh=mesh, **kw)
    ref = EMATrainModule(NequIPGNNModel(tp_impl="fused", **SPATIAL_MODEL), **kw)
    for batch, sp_batch in zip(DataLoader(ds, batch_size=1, device="cpu"),
                               SpatialFrameLoader(ds, mesh, R_MAX, device="cpu")):
        want = float(ref.training_step(batch)["train_loss_step/weighted_sum"])
        if sp.ema_step:
            disable_MeshGhostExchange(sp.model)
            disable_MeshGhostExchange(sp.ema_model)
        got = float(sp.training_step(sp_batch)["train_loss_step/weighted_sum"])
        assert got == pytest.approx(want, rel=1e-10)
        close_params(tensors_np(sp.model), tensors_np(ref.model), "params")
        close_params(tensors_np(sp.ema_model), tensors_np(ref.ema_model), "ema")
    assert sp.ema_step == ref.ema_step == 2
