"""The training data path and the loss managers of the port against the JAX
package: the same frames, splits, padded batches in the same order (with
the capacity-bucket ladder on frames of mixed sizes too: the same ladder,
the same bucket for each batch, the same padding waste), statistics and
loss values from the same seeds.

Exact (array-equal) where the computation is the same host numpy code
(padding, shuffles, capacities); float64 tolerances where sums run in another
order or in torch: LJ labels and statistics rel 1e-12, metric values rel
1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nequip_tpu.data import CommonDataStatisticsManager as JCommonStats
from nequip_tpu.data import DataLoader as JLoader
from nequip_tpu.data import EnergyOnlyDataStatisticsManager as JEnergyStats
from nequip_tpu.data import to_device
from nequip_tpu.data.dataset import InMemoryDataset as JInMemory
from nequip_tpu.data.dataset import LJTestDataset as JLJ
from nequip_tpu.data.dataset import RandomSplitDataset as JSplit
from nequip_tpu.data.transforms import ChemicalSpeciesToAtomTypeMapper as JMapper
from nequip_tpu.data.transforms import NeighborListTransform as JNL
from nequip_tpu.train import EnergyForceLoss as JEFLoss
from nequip_tpu.train import EnergyForceStressLoss as JEFSLoss
from nequip_tpu.train import EnergyForceStressMetrics as JEFSMetrics

from nequip_tpu_torch.data import CommonDataStatisticsManager, DataLoader, EnergyOnlyDataStatisticsManager, to_tensors
from nequip_tpu_torch.data.dataset import InMemoryDataset, LJTestDataset, RandomSplitDataset
from nequip_tpu_torch.model import NequIPGNNModel, jax_named_grads
from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper, NeighborListTransform
from nequip_tpu_torch.train import EnergyForceLoss, EnergyForceStressLoss, EnergyForceStressMetrics, NequIPTrainModule

SIZES = dict(num_frames=6, seed=3)


def _datasets():
    """The same LJ dataset from both packages.  The port's neighbour list is
    pinned to the backend of the JAX transform's default (kdtree), so the
    edges come in the same order."""
    return (
        LJTestDataset(transforms=[ChemicalSpeciesToAtomTypeMapper(["Cu"]), NeighborListTransform(4.0, backend="kdtree")],
                      **SIZES),
        JLJ(transforms=[JMapper(["Cu"]), JNL(4.0)], **SIZES),
    )


def test_lj_frames_and_labels_match_jax():
    port, ref = _datasets()
    for i in range(len(ref)):
        a, b = port.get_frame(i), ref.get_frame(i)
        np.testing.assert_array_equal(a["pos"], b["pos"])
        for k in ("total_energy", "forces", "stress", "virial"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-12, atol=1e-14, err_msg=k)


def test_random_split_matches_jax():
    port, ref = _datasets()
    split = {"train": 3, "val": 0.34, "test": 1}
    got, want = RandomSplitDataset(port, split, seed=11), JSplit(ref, split, seed=11)
    assert {k: v.indices for k, v in got.items()} == {k: v.indices for k, v in want.items()}


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(batch_size=2, shuffle=True, seed=5),
        dict(batch_size=4, shuffle=True, seed=1, drop_last=True),
        dict(batch_size=2, shuffle=True, seed=2, num_samples_per_epoch=4),
        dict(batch_size=2, shuffle=False, pad_multiple=16),
    ],
    ids=["shuffle", "drop_last", "partial_epochs", "in_order"],
)
def test_loader_batches_match_jax(kwargs):
    port, ref = _datasets()
    got_loader, want_loader = DataLoader(port, device=None, **kwargs), JLoader(ref, device=False, **kwargs)
    assert len(got_loader) == len(want_loader)
    assert got_loader.capacity == want_loader.capacity
    for _ in range(3):  # epochs: the shuffle and the sampler advance alike
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert set(a) == set(b)
            for k in ("pos", "edge_index", "edge_cell_shift", "batch", "num_atoms", "node_mask",
                      "edge_mask", "frame_mask", "atom_types"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            np.testing.assert_allclose(a["forces"], b["forces"], rtol=1e-12, atol=1e-14)
    assert got_loader.padding_waste() == pytest.approx(want_loader.padding_waste(), rel=1e-15)
    assert got_loader._epoch == want_loader.state_dict()["epoch"] == 3


@pytest.mark.parametrize("managers", ["common", "energy_only"])
def test_statistics_match_jax(managers):
    port, ref = _datasets()
    pm, jm = {
        "common": (CommonDataStatisticsManager, JCommonStats),
        "energy_only": (EnergyOnlyDataStatisticsManager, JEnergyStats),
    }[managers]
    got = pm(type_names=["Cu"]).get_statistics(DataLoader(port, batch_size=4, device="cpu"))
    want = jm(type_names=["Cu"]).get_statistics(JLoader(ref, batch_size=4))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12), k


@pytest.mark.parametrize("manager", ["ef_loss_per_type", "efs_loss", "efs_metrics"])
def test_loss_values_match_jax(manager):
    """Loss and metric values on a padded batch with random predictions
    (NaN stress targets masked where the manager ignores NaNs)."""
    batch = next(iter(JLoader(_datasets()[1], batch_size=3, device=False)))
    r = np.random.RandomState(8)
    pred = {k: batch[k] + r.normal(0, 0.1, batch[k].shape) for k in ("total_energy", "forces", "stress")}
    pred["num_atoms"] = batch["num_atoms"]
    target = dict(batch)
    target["stress"] = batch["stress"].copy()
    target["stress"][1, 0, 0] = np.nan
    pm, jm = {
        "ef_loss_per_type": (lambda: EnergyForceLoss(per_type_forces_coeffs={"Cu": 1.0}, type_names=["Cu"]),
                             lambda: JEFLoss(per_type_forces_coeffs={"Cu": 1.0}, type_names=["Cu"])),
        "efs_loss": (EnergyForceStressLoss, JEFSLoss),
        "efs_metrics": (EnergyForceStressMetrics, JEFSMetrics),
    }[manager]
    got_mgr, want_mgr = pm(), jm()
    _, got = got_mgr(to_tensors(pred), to_tensors(target))
    _, want = want_mgr({k: jnp.asarray(v) for k, v in to_device(pred).items()}, to_device(target))
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-12), k
    # epoch accumulation over two batches
    got_state = got_mgr.update_state(got_mgr.update_state(got_mgr.init_state(), to_tensors(pred), to_tensors(target)),
                                     to_tensors(pred), to_tensors(target))
    jt, jp = to_device(target), to_device(pred)
    want_state = want_mgr.update_state(want_mgr.update_state(want_mgr.init_state(), jp, jt), jp, jt)
    g, w = got_mgr.compute(got_state), want_mgr.compute(want_state)
    assert g == pytest.approx(w, rel=1e-12)
    assert all(torch.isfinite(torch.as_tensor(v)) for v in g.values())


BATCH_KEYS = ("pos", "edge_index", "edge_cell_shift", "batch", "num_atoms", "node_mask", "edge_mask", "frame_mask",
              "atom_types", "cell")


def _mixed_datasets():
    """The same frames of 8, 16 and 32 atoms (LJ supercells) in both
    packages, in an interleaved order."""
    frames = [f for cells in ((1, 1, 2), (1, 2, 2), (2, 2, 2))
              for f in (JLJ(supercell=cells, num_frames=3, seed=sum(cells)).get_frame(i) for i in range(3))]
    frames = [frames[i] for i in np.random.RandomState(0).permutation(len(frames))]
    return (InMemoryDataset(frames, transforms=[ChemicalSpeciesToAtomTypeMapper(["Cu"]),
                                                NeighborListTransform(4.0, backend="kdtree")]),
            JInMemory(frames, transforms=[JMapper(["Cu"]), JNL(4.0)]))


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(batch_size=1, shuffle=True, seed=5, n_buckets=3),
        dict(batch_size=2, shuffle=True, seed=1, n_buckets=2, pad_multiple=16),
        dict(batch_size=2, shuffle=True, seed=3, n_buckets=4, num_samples_per_epoch=6),
        dict(batch_size=3, shuffle=False, capacity={"n_nodes": 128, "n_edges": 4096, "n_frames": 4}),
    ],
    ids=["three_buckets", "two_buckets_pad16", "partial_epochs", "fixed_capacity"],
)
def test_bucket_ladder_matches_jax(kwargs):
    port, ref = _mixed_datasets()
    got_loader, want_loader = DataLoader(port, device=None, **kwargs), JLoader(ref, device=False, **kwargs)
    assert got_loader.buckets == want_loader.buckets
    assert len(got_loader.buckets) == kwargs.get("n_buckets", 1)
    sizes = set()
    for _ in range(2):
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert set(a) == set(b)
            for k in BATCH_KEYS:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            np.testing.assert_allclose(a["forces"], b["forces"], rtol=1e-12, atol=1e-14)
            sizes.add((a["pos"].shape[0], a["edge_index"].shape[1]))
    assert len(sizes) == len(got_loader.buckets)  # every bucket is used
    for need in ((9, 100), (33, 1500), (70, 3000)):
        assert got_loader._pick_bucket(*need) == want_loader._pick_bucket(*need)
    assert got_loader.padding_waste() == pytest.approx(want_loader.padding_waste(), rel=1e-15)


def test_bucket_ladder_cuts_the_padding():
    port, _ = _mixed_datasets()
    waste = {}
    for n_buckets in (1, 3):
        loader = DataLoader(port, batch_size=1, n_buckets=n_buckets, device=None)
        list(loader)
        waste[n_buckets] = loader.padding_waste()
    assert waste[3] < 0.5 * waste[1]


def test_bucketed_loader_resumes_from_its_state():
    port, _ = _mixed_datasets()
    kwargs = dict(batch_size=2, shuffle=True, seed=7, n_buckets=3, num_samples_per_epoch=4)
    straight = DataLoader(port, device=None, **kwargs)
    list(straight)
    state = straight.state_dict()
    want = list(straight)
    resumed = DataLoader(port, device=None, **kwargs)
    resumed.load_state_dict(state)
    got = list(resumed)
    assert resumed.buckets == straight.buckets and len(got) == len(want) == 2
    for a, b in zip(got, want):
        for k in BATCH_KEYS:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_training_steps_do_not_depend_on_the_bucket():
    """The fused kernels' training path keeps nothing per shape: each batch's
    loss and gradients at its bucket equal those at the worst-case capacity,
    over sizes that alternate (bigger, smaller, bigger) twice."""
    port, _ = _mixed_datasets()
    model = NequIPGNNModel(seed=2, model_dtype="float64", type_names=["Cu"], r_max=4.0, num_layers=2, l_max=1,
                           parity=False, num_features=4, radial_mlp_width=8, avg_num_neighbors=15.0,
                           tp_impl="fused")
    module = NequIPTrainModule(model, loss=EnergyForceLoss(), device="cpu")
    loaders = [DataLoader(port, batch_size=1, n_buckets=n, device="cpu") for n in (3, 1)]
    for _ in range(2):
        for bucketed, padded in zip(*loaders):
            assert bucketed["pos"].shape[0] <= padded["pos"].shape[0]
            result = []
            for batch in (bucketed, padded):
                model.zero_grad(set_to_none=True)
                loss, _, _ = module.compute_loss(batch)
                loss.backward()
                result.append((float(loss.detach()), jax_named_grads(model)))
            assert result[0][0] == pytest.approx(result[1][0], rel=1e-12)
            for k, g in result[1][1].items():
                np.testing.assert_allclose(result[0][1][k], g, rtol=0, atol=1e-12 * float(np.abs(g).max()), err_msg=k)
