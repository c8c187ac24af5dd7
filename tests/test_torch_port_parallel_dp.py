"""The port's data-parallel training against the JAX package, float64.

``Trainer(devices=2)`` over two gloo ranks (spawned processes,
``torch_port_parallel_ranks``) trains one epoch with batch 1 over three LJ
frames, shuffle off, in rr, in fr and in rr under ``optax.polyak_sgd``
(whose step reads the loss: the one formed from the merged sums): two steps, the second on the third
frame and a fully masked filler.  Each step's loss and parameters, the
epoch's train and val metrics and the final parameters equal those of
JAX's ``Trainer(devices=2)`` (its ``DataParallel`` step on a 2-device mesh)
to 1e-10 (relative for losses, of the tensor's max for parameters); the
parameters are the same bytes on both ranks after every step; only rank 0
writes checkpoints and ``metrics.csv``; ``devices`` other than the world
size raises.  ``group_batches`` groups and fills as JAX's does.  The
training CLI with ``trainer.devices=2`` (batch 2 a rank, one epoch, then
resumed from ``last.ckpt`` for a second) ends where one process at batch
4 ends after two straight epochs (parameters, EMA parameters, metrics).
``ConFIGTrainModule`` under ``Trainer(devices=2)`` takes one process's
steps at batch 2 (the JAX package's data-parallel ConFIG step solves with
each device's own rows, so it is not the reference here).

Tolerance: float64 sums in another order through two layers, their second
derivatives and two Adam steps.
"""

from pathlib import Path

import jax
import numpy as np
import pytest

from nequip_tpu.data import NequIPDataModule as JDataModule
from nequip_tpu.data.dataset import LJTestDataset as JLJ
from nequip_tpu.data.transforms import ChemicalSpeciesToAtomTypeMapper as JMapper
from nequip_tpu.data.transforms import NeighborListTransform as JNL
from nequip_tpu.model import NequIPGNNModel as JModel
from nequip_tpu.train import EnergyForceLoss as JLoss
from nequip_tpu.train import EnergyForceMetrics as JMetrics
from nequip_tpu.train import NequIPTrainModule as JModule
from nequip_tpu.train import Trainer as JTrainer

from nequip_tpu_torch.model import flatten_tree
from nequip_tpu_torch.parallel import DataParallel
from nequip_tpu_torch.parallel.dp import mask_out_batch

from nequip_tpu_torch.scripts.train import main as train_main
from nequip_tpu_torch.train import load_checkpoint

from torch_port_parallel_ranks import (
    DP_MODEL, METRIC_KEYS, MODES, R_MAX, JaxStepRecorder, cli_args, close_params, config_fit, dp_checks,
    run_ranks,
)

N_FRAMES = 3  # odd: the second step's second micro-batch is a masked filler


@pytest.fixture(scope="module")
def jax_fits(tmp_path_factory):
    params = flatten_tree(jax.tree.map(np.asarray, JModel(**DP_MODEL).init_params()))
    out = {"params": params}
    for mode, (force_grad_mode, optimizer) in MODES.items():
        ds = JLJ(num_frames=N_FRAMES, seed=7, transforms=[JMapper(chemical_symbols=["Cu"]), JNL(r_max=R_MAX)])
        dm = JDataModule(seed=0, train_dataset=ds, val_dataset=ds, train_dataloader={"batch_size": 1, "shuffle": False},
                         val_dataloader={"batch_size": 1})
        module = JModule(model=JModel(**DP_MODEL), loss=JLoss(per_atom_energy=True), val_metrics=JMetrics(),
                         optimizer=optimizer, force_grad_mode=force_grad_mode)
        rec = JaxStepRecorder()
        trainer = JTrainer(max_epochs=1, devices=2, callbacks=[rec], ckpt_dir=str(tmp_path_factory.mktemp(mode)))
        trainer.fit(module, dm)
        out[mode] = {"steps": rec.steps, "metrics": trainer._metrics_rows[-1],
                     "params": flatten_tree(jax.tree.map(np.asarray, trainer.state.params))}
    return out


@pytest.fixture(scope="module")
def ranks(jax_fits, tmp_path_factory):
    root = tmp_path_factory.mktemp("dp")
    return run_ranks(dp_checks, 2, root, jax_fits["params"], N_FRAMES, str(root / "ckpt"))


@pytest.mark.parametrize("mode", ["rr", "fr", "polyak"])
def test_dp_trainer_steps_match_jax(jax_fits, ranks, mode):
    want = jax_fits[mode]
    for res in ranks:
        got = res[mode]
        assert len(got["steps"]) == len(want["steps"]) == 2
        for g, w in zip(got["steps"], want["steps"]):
            assert g["loss"] == pytest.approx(w["loss"], rel=1e-10)
            close_params(g["params"], w["params"], "step")
        close_params(got["params"], want["params"], "final")
    for a, b in zip(ranks[0][mode]["steps"], ranks[1][mode]["steps"]):  # replicated: the same bytes
        for k in a["params"]:
            np.testing.assert_array_equal(a["params"][k], b["params"][k])


@pytest.mark.parametrize("mode", ["rr", "fr", "polyak"])
def test_dp_trainer_epoch_metrics_match_jax(jax_fits, ranks, mode):
    want = {k: v for k, v in jax_fits[mode]["metrics"].items() if k.startswith(METRIC_KEYS)}
    assert len(want) > 4
    for res in ranks:
        got = res[mode]["metrics"]
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-10, abs=1e-14), k


def test_dp_config_matches_one_process(jax_fits, ranks, tmp_path):
    """``ConFIGTrainModule`` under ``Trainer(devices=2)`` (the same epoch:
    batch 1 a rank, the tail a masked filler) takes the steps of one
    process at batch 2: losses and parameters after each step to 1e-10, the
    same bytes on both ranks (every rank solves the global batch's system)."""
    want = config_fit(0, jax_fits["params"], N_FRAMES, str(tmp_path), batch_size=2, devices=1)
    assert len(want["steps"]) == 2
    for res in ranks:
        got = res["config"]
        assert len(got["steps"]) == 2
        for g, w in zip(got["steps"], want["steps"]):
            assert g["loss"] == pytest.approx(w["loss"], rel=1e-10)
            close_params(g["params"], w["params"], "step")
        close_params(got["params"], want["params"], "final")
    for a, b in zip(ranks[0]["config"]["steps"], ranks[1]["config"]["steps"]):
        for k in a["params"]:
            np.testing.assert_array_equal(a["params"][k], b["params"][k])


def test_dp_only_rank_zero_writes_and_devices_must_match(ranks):
    assert {"last.ckpt", "best.ckpt", "metrics.csv"} <= set(ranks[0]["rr"]["files"])
    assert ranks[1]["rr"]["files"] == [] and ranks[1]["fr"]["files"] == []
    assert all("trainer.devices=3" in res["devices_3"] for res in ranks)


def test_dp_cli_resumed_matches_one_process(ranks, tmp_path):
    """``nequip-torch-train`` with ``trainer.devices=2`` (batch 2 a rank, one
    epoch, then resumed for a second) ends where one process at batch 4
    ends after two straight epochs: parameters, EMA parameters and the last
    epoch's metrics to 1e-10."""
    single = tmp_path / "single"
    train_main(cli_args(str(single), "++trainer.max_epochs=2", "++data.train_dataloader.batch_size=4"))
    want = load_checkpoint(str(single / "last.ckpt"))
    got = load_checkpoint(str(Path(ranks[0]["cli_dir"]) / "last.ckpt"))
    assert got["meta"]["epoch"] == want["meta"]["epoch"] == 2
    assert got["meta"]["global_step"] == want["meta"]["global_step"]
    for key in ("params", "ema_params"):
        close_params({k: np.asarray(v) for k, v in got["state"][key].items()},
                     {k: np.asarray(v) for k, v in want["state"][key].items()}, key)
    for k, v in want["meta"]["metrics"].items():
        if k.startswith(METRIC_KEYS):
            assert got["meta"]["metrics"][k] == pytest.approx(v, rel=1e-10, abs=1e-14), k


class _Module:
    def training_step(self, batch, loss_coeffs=None, group=None):
        pass


class _Mesh:
    def __init__(self, n, index):
        self.shape, self.coords = {"dp": n}, {"dp": index}

    def group(self, axes):
        return None


def test_group_batches_groups_and_fills_as_jax():
    """Grouped by padded shape, flushed in first-seen order, tails filled
    with masked copies: rank r gets the r-th of each group."""
    def b(n, tag):
        return {"pos": np.zeros((n, 3)) + tag, "node_mask": np.ones(n, bool), "edge_mask": np.ones(4, bool),
                "frame_mask": np.ones(2, bool)}

    stream = [b(8, 0), b(16, 1), b(8, 2), b(16, 3), b(8, 4), b(8, 5), b(16, 6)]
    got = [[float(x["pos"][0, 0]) if x["node_mask"].any() else -1.0
            for x in DataParallel(_Module(), _Mesh(3, r)).group_batches(iter(stream))] for r in range(3)]
    # groups: [0 2 4] (8), [1 3 6] (16), then the tail [5 f f] (8)
    assert got == [[0.0, 1.0, 5.0], [2.0, 3.0, -1.0], [4.0, 6.0, -1.0]]
    filler = mask_out_batch(b(8, 5))
    assert not filler["node_mask"].any() and not filler["edge_mask"].any() and not filler["frame_mask"].any()
    with pytest.raises(NotImplementedError, match="no data-parallel"):
        DataParallel(type("M", (), {"training_step": lambda self, batch: None})(), _Mesh(2, 0))
