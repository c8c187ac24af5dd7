"""The port's entry points run on the card unless the caller asks for the CPU.

``NequIPCalculator`` (``__init__`` and ``from_model``), ``DataLoader``,
``NequIPDataModule``, ``MDDriver``, ``NequIPBatchedInference``, the training
modules and the training CLI (``run_config``, ``main``) default to
``device="cuda"``.  Each test decides inside
itself whether there is a card: without one the default raises a clear
``RuntimeError`` (nothing carries on on the CPU); with one the model or the
batches lie on it.
"""

import numpy as np
import pytest
import torch

from nequip_tpu_torch.data import NequIPDataModule
from nequip_tpu_torch.data.dataset import LJTestDataset
from nequip_tpu_torch.data.loader import DataLoader
from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper, NeighborListTransform
from nequip_tpu_torch.integrations import MDDriver, NequIPBatchedInference, NequIPCalculator, VelocityVerlet
from nequip_tpu_torch.model import NequIPGNNModel
from nequip_tpu_torch.scripts import train as train_cli
from nequip_tpu_torch.train import EnergyForceLoss, NequIPTrainModule


def _dataset():
    return LJTestDataset(num_frames=3, seed=1, transforms=[ChemicalSpeciesToAtomTypeMapper(["Cu"]),
                                                           NeighborListTransform(4.0)])


def test_calculator_defaults_to_the_card():
    model = NequIPGNNModel(seed=0, model_dtype="float64", type_names=["Cu"], r_max=4.0, num_layers=1, l_max=1,
                           parity=False, num_features=4, radial_mlp_width=8, avg_num_neighbors=10.0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            NequIPCalculator.from_model(model)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            NequIPCalculator(model, r_max=4.0, type_names=["Cu"])
        return
    calc = NequIPCalculator.from_model(model)
    assert calc.device.type == "cuda"
    assert all(p.is_cuda for p in model.parameters())
    frame = _dataset()[0]
    res = calc.calculate({"pos": frame["pos"], "cell": frame["cell"], "pbc": frame["pbc"],
                          "atomic_numbers": np.full(len(frame["pos"]), 29)})
    assert np.isfinite(res["forces"]).all()


def test_loader_defaults_to_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DataLoader(_dataset(), batch_size=2)
        assert isinstance(next(iter(DataLoader(_dataset(), batch_size=2, device=None)))["pos"], np.ndarray)
        return
    batch = next(iter(DataLoader(_dataset(), batch_size=2)))
    assert all(v.is_cuda for v in batch.values() if isinstance(v, torch.Tensor))


def test_datamodule_defaults_to_the_card():
    split = {"dataset": _dataset(), "train": 2, "val": 1}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            NequIPDataModule(seed=0, split_dataset=split)
        return
    dm = NequIPDataModule(seed=0, split_dataset=split)
    dm.setup("fit")
    batch = next(iter(dm.train_dataloader()))
    assert all(v.is_cuda for v in batch.values() if isinstance(v, torch.Tensor))


def _md_frame():
    frame = _dataset()[0]
    return {"pos": frame["pos"], "cell": frame["cell"], "pbc": frame["pbc"],
            "atom_types": np.zeros(len(frame["pos"]), dtype=int)}


def test_md_driver_and_batched_inference_default_to_the_card():
    model = NequIPGNNModel(seed=0, model_dtype="float64", type_names=["Cu"], r_max=4.0, num_layers=1, l_max=1,
                           parity=False, num_features=4, radial_mlp_width=8, avg_num_neighbors=10.0)
    frame = _md_frame()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MDDriver(model, frame, VelocityVerlet(dt_fs=1.0))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            NequIPBatchedInference(model)
        return
    driver = MDDriver(model, frame, VelocityVerlet(dt_fs=1.0), integration="host")
    assert driver.device.type == "cuda" and all(p.is_cuda for p in model.parameters())
    assert np.isfinite(driver.run(2)["forces"]).all()
    batched = NequIPBatchedInference(model)
    assert batched.device.type == "cuda" and np.isfinite(batched([frame])[0]["forces"]).all()


def test_training_entry_points_default_to_the_card(tmp_path):
    import yaml

    from pathlib import Path

    config_dir = Path(__file__).resolve().parents[1] / "nequip_tpu_torch" / "configs"
    config = yaml.safe_load((config_dir / "minimal_lj.yaml").read_text())
    config["trainer"].update(max_epochs=1, ckpt_dir=str(tmp_path / "ckpt"))
    model = NequIPGNNModel(seed=0, model_dtype="float64", type_names=["Cu"], r_max=4.0, num_layers=1, l_max=1,
                           parity=False, num_features=4, radial_mlp_width=8, avg_num_neighbors=10.0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            NequIPTrainModule(model, loss=EnergyForceLoss())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.run_config(config)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(["-cn", "minimal_lj", "-cp", str(config_dir), "++trainer.max_epochs=1",
                            f"++trainer.ckpt_dir={tmp_path / 'main'}"])
        assert not (tmp_path / "ckpt").exists() and not (tmp_path / "main").exists()
        return
    module = NequIPTrainModule(model, loss=EnergyForceLoss())
    assert module.device.type == "cuda" and all(p.is_cuda for p in model.parameters())
    trainer = train_cli.run_config(config)
    assert trainer.module.device.type == "cuda" and (tmp_path / "ckpt" / "last.ckpt").exists()
