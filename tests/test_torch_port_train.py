"""Force-loss (rr) training of the port against the JAX package, float64.

* One rr step on a small model (2 layers, l_max 1, 8 features) and a
  padded batch of two LJ-labelled frames, under ``tp_impl`` ``"torch"``,
  ``"fused"`` and ``"fused_tp"`` (the kernels' plain twins on the CPU): the
  loss (rel 1e-10) and every parameter gradient (1e-8 of its tensor's max
  |grad|) equal the JAX ``NequIPTrainModule`` step's, at the same
  parameters (``load_jax_params``).
* ``Trainer.fit`` for 2 epochs of the port's counterpart of
  ``tests/integration/lj_config.yaml`` (EMA, stats-derived neighbour norm,
  shifts and scales, Adam): per-epoch train and val losses equal the JAX
  trainer's to 1e-8 relative.  The JAX side runs ``tp_impl="xla"``.
  (fr training is held against JAX in ``tests/test_torch_port_fr.py``.)

Tolerances: float64 sums in another order through two layers and their
second derivatives, and for the trainer six Adam steps on top.
"""

import jax
import numpy as np
import pytest

from nequip_tpu.data import DataLoader as JLoader
from nequip_tpu.data import NequIPDataModule as JDataModule
from nequip_tpu.data import CommonDataStatisticsManager as JStats
from nequip_tpu.data.dataset import LJTestDataset as JLJ
from nequip_tpu.data.transforms import ChemicalSpeciesToAtomTypeMapper as JMapper
from nequip_tpu.data.transforms import NeighborListTransform as JNL
from nequip_tpu.model import NequIPGNNModel as JModel
from nequip_tpu.train import EMATrainModule as JEMAModule
from nequip_tpu.train import EnergyForceLoss as JLoss
from nequip_tpu.train import EnergyForceMetrics as JMetrics
from nequip_tpu.train import Trainer as JTrainer

from nequip_tpu_torch.data import CommonDataStatisticsManager, DataLoader, NequIPDataModule
from nequip_tpu_torch.data.dataset import LJTestDataset
from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper, NeighborListTransform
from nequip_tpu_torch.model import NequIPGNNModel, flatten_tree, jax_named_grads, load_jax_params
from nequip_tpu_torch.train import EMATrainModule, EnergyForceLoss, EnergyForceMetrics, NequIPTrainModule, Trainer

SMALL = dict(
    seed=0, model_dtype="float64", type_names=["Cu"], r_max=4.0, num_layers=2, l_max=1, parity=False,
    num_features=8, radial_mlp_width=16, avg_num_neighbors=20.0, per_type_energy_shifts={"Cu": -0.5},
)


def _lj(pkg_lj, mapper, nl, **kw):
    return pkg_lj(num_frames=2, seed=7, transforms=[mapper(["Cu"]), nl(4.0)], **kw)


@pytest.fixture(scope="module")
def jax_step():
    """JAX params, loss and gradients of one rr step on a 2-frame batch."""
    model = JModel(tp_impl="xla", **SMALL)
    params = model.init_params()
    batch = next(iter(JLoader(_lj(JLJ, JMapper, JNL), batch_size=2)))
    loss_mgr = JLoss(type_names=["Cu"])

    def loss_fn(p):
        return loss_mgr.values(loss_mgr.batch_state(model(p, batch), batch), loss_mgr.coeff_vector())[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    flat = lambda t: flatten_tree(jax.tree.map(np.asarray, t))
    return flat(params), float(loss), flat(grads)


@pytest.mark.parametrize("tp_impl", ["torch", "fused", "fused_tp"])
def test_rr_step_matches_jax(jax_step, tp_impl):
    params, want_loss, want_grads = jax_step
    model = load_jax_params(NequIPGNNModel(tp_impl=tp_impl, **SMALL), params)
    module = NequIPTrainModule(model, loss=EnergyForceLoss(type_names=["Cu"]), device="cpu")
    batch = next(iter(DataLoader(_lj(LJTestDataset, ChemicalSpeciesToAtomTypeMapper, NeighborListTransform),
                                 batch_size=2, device="cpu")))
    loss, _, _ = module.compute_loss(batch)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(want_loss, rel=1e-10)
    got = jax_named_grads(model)
    assert set(got) == {k for k, _ in module.named_trainable()}
    assert set(got) | set(module.frozen_paths) == set(want_grads)
    for k, g in got.items():
        scale = float(np.abs(want_grads[k]).max())
        np.testing.assert_allclose(g, want_grads[k], rtol=0, atol=1e-8 * scale, err_msg=k)


def _lj_config_data(LJ, Mapper, NL, DataModule, Stats, **dm_kw):
    """The datamodule, statistics and model arguments of lj_config.yaml,
    built with one package's classes."""
    ds = LJ(num_frames=8, seed=123456, transforms=[Mapper(["Cu"]), NL(4.0)])
    dm = DataModule(seed=456, split_dataset={"dataset": ds, "train": 6, "val": 1, "test": 1},
                    train_dataloader={"batch_size": 2}, val_dataloader={"batch_size": 1},
                    test_dataloader={"batch_size": 1}, stats_manager=Stats(type_names=["Cu"]), **dm_kw)
    stats = dm.get_statistics()
    model_kw = dict(
        seed=123, model_dtype="float64", type_names=["Cu"], r_max=4.0, num_layers=2, l_max=1, parity=False,
        num_features=4, radial_mlp_depth=1, radial_mlp_width=8, avg_num_neighbors=stats["num_neighbors_mean"],
        per_type_energy_shifts=stats["per_atom_energy_mean"], per_type_energy_scales=stats["per_type_forces_rms"],
    )
    return dm, stats, model_kw


def test_trainer_fit_matches_jax_trainer(tmp_path):
    jdm, jstats, jkw = _lj_config_data(JLJ, JMapper, JNL, JDataModule, JStats)
    jmodel = JModel(**jkw)
    jmodule = JEMAModule(model=jmodel, loss=JLoss(per_atom_energy=True, coeffs={"total_energy": 1.0, "forces": 1.0}),
                         val_metrics=JMetrics(), optimizer={"_target_": "optax.adam", "learning_rate": 0.005},
                         ema_decay=0.99)
    jtrainer = JTrainer(max_epochs=2, ckpt_dir=str(tmp_path / "jax"))
    jtrainer.fit(jmodule, jdm)

    dm, stats, kw = _lj_config_data(LJTestDataset, ChemicalSpeciesToAtomTypeMapper, NeighborListTransform,
                                    NequIPDataModule, CommonDataStatisticsManager, device="cpu")
    assert stats["num_neighbors_mean"] == pytest.approx(jstats["num_neighbors_mean"], rel=1e-14)
    assert stats["per_type_forces_rms"]["Cu"] == pytest.approx(jstats["per_type_forces_rms"]["Cu"], rel=1e-12)
    model = load_jax_params(NequIPGNNModel(tp_impl="fused", **kw),
                            flatten_tree(jax.tree.map(np.asarray, jmodel.init_params())))
    module = EMATrainModule(model, loss=EnergyForceLoss(per_atom_energy=True, coeffs={"total_energy": 1.0, "forces": 1.0}),
                            val_metrics=EnergyForceMetrics(), optimizer={"_target_": "optax.adam", "learning_rate": 0.005},
                            ema_decay=0.99, device="cpu")
    trainer = Trainer(max_epochs=2, ckpt_dir=str(tmp_path / "port"))
    trainer.fit(module, dm)

    assert len(trainer.metrics_rows) == len(jtrainer._metrics_rows) == 2
    assert len(trainer.step_seconds) == 6 and (tmp_path / "port" / "metrics.csv").exists()
    for got, want in zip(trainer.metrics_rows, jtrainer._metrics_rows):
        for key in ("train_loss_epoch/weighted_sum", "train_loss_epoch/forces_mse",
                    "train_loss_epoch/per_atom_energy_mse", "val0_epoch/weighted_sum", "val0_epoch/forces_rmse",
                    "val0_epoch/total_energy_rmse", "padding_waste"):
            assert got[key] == pytest.approx(want[key], rel=1e-8), key
        assert got["global_step"] == want["global_step"]
    # a standalone validation at the final weights repeats the last epoch's
    val = trainer.validate(module, dm)
    assert val["val0_epoch/weighted_sum"] == pytest.approx(trainer.metrics_rows[1]["val0_epoch/weighted_sum"], rel=1e-12)


def test_param_groups_and_frozen_paths():
    model = NequIPGNNModel(tp_impl="torch", **SMALL)
    module = NequIPTrainModule(model, loss=EnergyForceLoss(), optimizer={
        "_target_": "optax.adam", "learning_rate": 1e-3,
        "param_groups": [{"paths": ["layer0_convnet"], "learning_rate": 1e-2}],
    }, device="cpu")
    lrs = {id(p): g["lr"] for g in module.optimizer.param_groups for p in g["params"]}
    for path, p in module.named_trainable():
        assert lrs[id(p)] == (1e-2 if path.startswith("layer0_convnet.") else 1e-3), path
    assert "per_type_energy_scale_shift.shifts" in module.frozen_paths
    assert not any(p in dict(module.named_trainable()) for p in module.frozen_paths)


def test_evaluation_runs_the_serving_kernels(monkeypatch):
    """Validation computes forces without the weight-gradient kernels and
    leaves the weights trainable."""
    from nequip_tpu_torch.ops.kernels import tp_scatter as K

    model = NequIPGNNModel(tp_impl="fused", **SMALL)
    module = EMATrainModule(model, loss=EnergyForceLoss(), val_metrics=EnergyForceMetrics(), device="cpu")
    monkeypatch.setattr(K, "conv_bwd_train_plain", lambda *a: pytest.fail("training variant in evaluation"))
    batch = next(iter(DataLoader(_lj(LJTestDataset, ChemicalSpeciesToAtomTypeMapper, NeighborListTransform),
                                 batch_size=2, device="cpu")))
    for m in (module, NequIPTrainModule(model, loss=EnergyForceLoss(), val_metrics=EnergyForceMetrics(), device="cpu")):
        state, out = m.evaluation_step(m.val_metrics, m.val_metrics.init_state(), batch)
        assert np.isfinite(m.val_metrics.compute(state)["weighted_sum"])
    assert all(p.requires_grad for p in model.parameters())
