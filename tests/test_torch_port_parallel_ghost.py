"""The port's sharded-graph path against the JAX package, float64 on the CPU.

* ``spatial_partition`` equals JAX's array for array, exactly, on the
  64-atom LJ frame of ``tests/unit/parallel`` and on a frame whose slabs
  hold unequal atom counts.
* Over two gloo ranks (spawned processes, ``torch_port_parallel_ranks``):
  sharded ``evaluate`` under ``tp_impl="torch"`` and ``"fused"`` (the
  kernels' plain twins here) against JAX's single-device energy (rel 1e-10)
  and forces (1e-8 of max |F|); ``loss_and_grad`` in rr and fr against
  JAX's ``ShardedGraphEvaluator.loss_and_grad`` on a 2-device mesh (loss
  rel 1e-10, every gradient 1e-8 of its max), fr also over 2 edge slices
  of each rank's stream (``fr_edge_chunks``; the same numbers).
* A request after ``disable_MeshGhostExchange`` on the evaluator's model
  gives the first request's bytes (the evaluator installs the exchange
  on every request).
* The no-op ghost exchange leaves the models' outputs bitwise unchanged
  and is called in every layer but the first (on the tangent too).
* The loader's ``process_index`` slicing is JAX's, index for index; a
  single process needs no process group.

Tolerances: float64 sums in another order (cross-rank sums, the second
derivatives of two layers).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from nequip_tpu.data import DataLoader as JLoader
from nequip_tpu.data import batched_from_list as j_batched, compute_neighborlist_ as j_nl, from_dict as j_from_dict
from nequip_tpu.data import pad_batch as j_pad, to_device as j_to_device
from nequip_tpu.data._cpp_nl import get_lib as j_cpp_lib
from nequip_tpu.data.dataset import LJTestDataset as JLJ
from nequip_tpu.model import NequIPGNNModel as JModel
from nequip_tpu.parallel import make_mesh as j_make_mesh
from nequip_tpu.parallel.ghost import ShardedGraphEvaluator as JEvaluator
from nequip_tpu.parallel.ghost import spatial_partition as j_partition

from nequip_tpu_torch.data import DataLoader, batched_from_list, compute_neighborlist_, from_dict, pad_batch
from nequip_tpu_torch.data import to_tensors
from nequip_tpu_torch.data.dataset import LJTestDataset
from nequip_tpu_torch.data.neighborlist import neighbor_list
from nequip_tpu_torch.model import NequIPGNNModel, flatten_tree
from nequip_tpu_torch.nn.ghost_exchange import NoOpGhostExchange
from nequip_tpu_torch.nn.interaction_block import InteractionBlock
from nequip_tpu_torch.parallel import device_count, ghost, init_distributed, make_mesh, spatial_partition
from nequip_tpu_torch.train import Trainer

from torch_port_parallel_ranks import GHOST_MODEL, R_MAX, run_ranks, sharded_checks

E_REF, CE, CF = -20.0, 1.0, 0.7


def _frame(shift_atoms: int = 0) -> dict:
    lj = JLJ(supercell=(4, 2, 2), num_frames=1, seed=12).frames[0]
    pos, cell = np.array(lj["pos"], dtype=np.float64), np.asarray(lj["cell"]).reshape(3, 3)
    if shift_atoms:  # move some atoms a quarter cell along the slab axis: unequal slabs
        axis = int(np.argmax(np.linalg.norm(cell, axis=1)))
        pos[:shift_atoms] += 0.25 * cell[axis]
    return {"pos": pos, "cell": cell, "pbc": np.array([True] * 3), "atom_types": np.zeros(len(pos), dtype=np.int64)}


@pytest.mark.parametrize("shift_atoms", [0, 5])
@pytest.mark.parametrize("n_devices", [2, 3])
def test_spatial_partition_is_jax_exactly(shift_atoms, n_devices, monkeypatch):
    if j_cpp_lib() is None:  # JAX's "auto" neighbour list then runs its kdtree backend: the port's the same
        monkeypatch.setattr(ghost, "neighbor_list", functools.partial(neighbor_list, backend="kdtree"))
    frame = _frame(shift_atoms)
    want = j_partition(dict(frame), n_devices, R_MAX)
    got = spatial_partition(dict(frame), n_devices, R_MAX)
    if shift_atoms:
        counts = want["local_mask"].sum(axis=1)
        assert len(set(counts.tolist())) > 1, counts
    assert set(got) == set(want) and got["caps"] == want["caps"]
    for k, v in want.items():
        if k == "caps":
            continue
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX model's parameters, single-device E/F, and the sharded
    ``loss_and_grad`` in rr and fr on a 2-device mesh."""
    frame = _frame()
    f_ref = np.random.RandomState(5).standard_normal((64, 3))
    model = JModel(**GHOST_MODEL)
    params = model.init_params()
    data = j_to_device(j_pad(j_batched([j_nl(j_from_dict(dict(frame)), R_MAX)]), 128, 4096, 2))
    out = jax.jit(lambda p, d: model(p, d))(params, data)
    refs = {"params": flatten_tree(jax.tree.map(np.asarray, params)), "frame": frame, "f_ref": f_ref,
            "energy": float(out["total_energy"][0, 0]), "forces": np.asarray(out["forces"])[:64]}
    for mode in ("rr", "fr"):
        ev = JEvaluator(JModel(**GHOST_MODEL), params, mesh=j_make_mesh((2,), ("graph",)), axis_name="graph",
                        force_grad_mode=mode)
        loss, grads = ev.loss_and_grad(dict(frame), E_REF, f_ref, energy_coeff=CE, force_coeff=CF)
        refs[f"loss_{mode}"] = float(loss)
        refs[f"grads_{mode}"] = flatten_tree(jax.tree.map(np.asarray, grads))
    return refs


@pytest.fixture(scope="module")
def ranks(jax_refs, tmp_path_factory):
    r = jax_refs
    return run_ranks(sharded_checks, 2, tmp_path_factory.mktemp("ghost"), r["frame"], r["params"], E_REF, r["f_ref"])


@pytest.mark.parametrize("tp_impl", ["torch", "fused"])
def test_sharded_evaluate_matches_jax_single_device(jax_refs, ranks, tp_impl):
    for res in ranks:  # every rank gets the global energy and forces
        energy, forces = res[f"evaluate_{tp_impl}"]
        assert energy == pytest.approx(jax_refs["energy"], rel=1e-10)
        scale = np.abs(jax_refs["forces"]).max()
        np.testing.assert_allclose(forces, jax_refs["forces"], rtol=0, atol=1e-8 * scale)
        # after disable_MeshGhostExchange the next request refreshes the ghosts again: the same bytes
        again_e, again_f = res[f"evaluate_{tp_impl}_after_disable"]
        assert again_e == energy
        np.testing.assert_array_equal(again_f, forces)
    assert ranks[0]["exchanges"] == ["MeshGhostExchange"] * 2
    assert all(res["threads"] == 1 for res in ranks)


@pytest.mark.parametrize("mode", ["rr", "fr", "fr2"])
def test_sharded_loss_and_grad_matches_jax_mesh(jax_refs, ranks, mode):
    want = jax_refs[f"grads_{mode[:2]}"]
    for res in ranks:
        assert res[f"loss_{mode}"] == pytest.approx(jax_refs[f"loss_{mode[:2]}"], rel=1e-10)
        got = res[f"grads_{mode}"]
        assert set(got) <= set(want) and len(got) > 0
        for k, g in got.items():
            np.testing.assert_allclose(g, want[k], rtol=0, atol=1e-8 * np.abs(want[k]).max(), err_msg=k)
    for k in ranks[0][f"grads_{mode}"]:  # the all-reduced gradients are the same bytes on every rank
        np.testing.assert_array_equal(ranks[0][f"grads_{mode}"][k], ranks[1][f"grads_{mode}"][k])


class _Counting(NoOpGhostExchange):
    calls = 0

    def forward(self, data):
        _Counting.calls += 1
        return data


@pytest.mark.parametrize("tp_impl", ["torch", "fused", "fused_tp"])
def test_noop_ghost_exchange_leaves_models_bitwise_unchanged(tp_impl):
    kw = dict(GHOST_MODEL, num_layers=3)
    model = NequIPGNNModel(tp_impl=tp_impl, **kw)
    frame = compute_neighborlist_(from_dict(dict(_frame())), R_MAX)
    batch = to_tensors(pad_batch(batched_from_list([frame]), 128, 4096, 2), "cpu")
    blocks = [m for m in model.modules() if isinstance(m, InteractionBlock)]
    assert [type(b.ghost_exchange) for b in blocks] == [NoOpGhostExchange] * 3
    t_pos = torch.as_tensor(np.random.RandomState(1).standard_normal(batch["pos"].shape))

    def run():
        out = model(batch)
        net = model.model.func
        _, t_out = net.jvp(model._inputs(batch), {"pos": t_pos})
        return [out["total_energy"], out["forces"], t_out["total_energy"]]

    want = run()
    for b in blocks:
        b.ghost_exchange = _Counting(field="node_features")
    _Counting.calls = 0
    got = run()
    # forward, the force backward does not call it again, jvp: features and tangent, layers 1 and 2
    assert _Counting.calls == 2 + 4
    for g, w in zip(got, want):
        assert torch.equal(g.detach(), w.detach())


def test_loader_process_slices_are_jax():
    jds, ds = JLJ(num_frames=10, seed=2), LJTestDataset(num_frames=10, seed=2)
    for count in (1, 3, 4):
        for index in range(count):
            kw = dict(batch_size=2, shuffle=True, seed=3, process_index=index, process_count=count)
            jl, tl = JLoader(jds, device=False, **kw), DataLoader(ds, device=None, **kw)
            np.testing.assert_array_equal(tl._order(), jl._order())
            assert len(tl) == len(jl)
    with pytest.raises(ValueError, match="process_index"):
        DataLoader(ds, batch_size=1, process_index=2, process_count=2, device=None)


def test_single_process_needs_no_group(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "SLURM_PROCID", "SLURM_NTASKS"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() is False and not torch.distributed.is_initialized()
    mesh = make_mesh()
    assert device_count() == 1 and mesh.shape == {"dp": 1} and mesh.coords == {"dp": 0} and mesh.group("dp") is None
    with pytest.raises(ValueError, match="trainer.devices=2"):
        Trainer(devices=2)._setup_data_parallel(None)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh((2, 2), ("dp", "graph"))
