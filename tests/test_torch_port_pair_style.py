"""The port's MD-engine pair style against the JAX package, in float64 on the CPU.

Twins of ``tests/unit/nn/test_pair_style_branch.py``: edge forces summed
onto atoms rebuild the position-branch forces (energy rel 1e-10, forces
atol 1e-10), and an engine's two-domain split with ghost atoms reproduces
the undivided periodic energy and forces (1e-9); both for the plain conv
and the fused kernels' twins (whose stream is put into kernel order and
whose edge forces come back in the engine's order).  The JAX and the port
wrappers agree on one JAX-written pair file (energy rel 1e-10, edge forces
1e-8), and a port-written file loads in the JAX package with the same
answers.  ``nequip-torch-prepare-pair-style`` and ``nequip-torch-compile
--target pair_nequip`` run on a checkpoint of the port's training CLI; the
``pair_nequip`` program equals the eager wrapper (1e-12).
"""

import itertools
import pickle

import numpy as np
import pytest
import torch

from nequip_tpu.integrations.pair_style import NequIPPairStyleWrapper as JaxPairStyleWrapper
from nequip_tpu.model import NequIPGNNModel as JaxNequIPGNNModel

from nequip_tpu_torch.data import _keys, batched_from_list, compute_neighborlist_, from_dict, pad_batch, to_tensors
from nequip_tpu_torch.integrations import NequIPPairStyleWrapper
from nequip_tpu_torch.model import NequIPGNNModel, load_compiled_model, load_saved_model, save_compiled_model
from nequip_tpu_torch.model import validate_artifact
from nequip_tpu_torch.ops.kernels.tp_scatter import relayout_edge_stream
from nequip_tpu_torch.scripts import compile as port_compile
from nequip_tpu_torch.scripts import prepare_pair_style
from nequip_tpu_torch.scripts import train as port_train

SMALL = dict(seed=11, model_dtype="float64", type_names=["Cu"], r_max=4.0, num_layers=2, l_max=1, parity=False,
             num_features=4, radial_mlp_width=8, avg_num_neighbors=10.0, per_type_energy_shifts={"Cu": -0.4})
IMPLS = ["torch", "fused"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many tiny ops: one intra-op thread keeps them fast beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _edge_force_sum(n, dst, src, edge_forces):
    f = np.zeros((n, 3))
    np.add.at(f, dst, edge_forces)
    np.subtract.at(f, src, edge_forces)
    return f


@pytest.mark.parametrize("tp_impl", IMPLS)
def test_edge_forces_match_position_forces(tp_impl):
    model = NequIPGNNModel(tp_impl=tp_impl, **SMALL)
    r = np.random.RandomState(0)
    n = 12
    pos = r.uniform(0, 6, (n, 3))
    frame = compute_neighborlist_(from_dict({_keys.POSITIONS_KEY: pos, _keys.ATOM_TYPE_KEY: np.zeros(n, int)}), 4.0)
    ei = frame[_keys.EDGE_INDEX_KEY]
    out = model(to_tensors(pad_batch(batched_from_list([frame]), 128, 1024, 2)))
    f_pos = out[_keys.FORCE_KEY][:n].detach().numpy()
    e_pos = float(out[_keys.TOTAL_ENERGY_KEY][0, 0].detach())

    wrapper = NequIPPairStyleWrapper(model, device="cpu")
    res = wrapper.compute(pos[ei[1]] - pos[ei[0]], ei[0], ei[1], np.zeros(n, int), n_local=n)
    np.testing.assert_allclose(res["total_energy"], e_pos, rtol=1e-10)
    np.testing.assert_allclose(_edge_force_sum(n, ei[0], ei[1], res["edge_forces"]), f_pos, atol=1e-10)


@pytest.mark.parametrize("tp_impl", IMPLS)
def test_engine_spatial_decomposition(tp_impl):
    """Two x-slab domains with ghosts out to num_layers * r_max: per-domain
    local energies sum to the periodic energy and the engine's force
    accumulation (with the ghosts' rows sent home) to its forces."""
    r_max, a = 3.0, 3.61
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]) * a
    pos = np.concatenate([base + np.array([i, j, k]) * a for i in range(4) for j in range(2) for k in range(2)])
    pos = pos + np.random.RandomState(4).normal(0, 0.05, pos.shape)
    cell = np.diag([4 * a, 2 * a, 2 * a])
    n = len(pos)
    model = NequIPGNNModel(tp_impl=tp_impl, **{**SMALL, "seed": 2, "r_max": r_max,
                                                "per_type_energy_shifts": {"Cu": -2.0}})
    frame = compute_neighborlist_(from_dict({_keys.POSITIONS_KEY: pos, _keys.CELL_KEY: cell,
                                             _keys.PBC_KEY: np.array([True] * 3),
                                             _keys.ATOM_TYPE_KEY: np.zeros(n, dtype=int)}), r_max)
    out = model(to_tensors(pad_batch(batched_from_list([frame]), 128, 4096, 2)))
    e_full = float(out[_keys.TOTAL_ENERGY_KEY][0, 0].detach())
    f_full = out[_keys.FORCE_KEY][:n].detach().numpy()

    wrapper = NequIPPairStyleWrapper(model, pad_multiple=64, device="cpu")
    comm_cut = 2 * r_max
    frac_x = (pos @ np.linalg.inv(cell))[:, 0] % 1.0
    domain_of = (frac_x >= 0.5).astype(int)
    shifts = np.array(list(itertools.product([-1, 0, 1], repeat=3)), dtype=float)
    e_sum, f_acc = 0.0, np.zeros((n, 3))
    for d in (0, 1):
        local_idx = np.nonzero(domain_of == d)[0]
        nodes, owners = [pos[local_idx]], [local_idx]
        for s in shifts:
            img = pos + s @ cell
            dmin = np.min(np.linalg.norm(img[:, None, :] - pos[local_idx][None, :, :], axis=-1), axis=1)
            keep = (dmin < comm_cut + 1e-9) & ~((np.abs(s).sum() == 0) & (domain_of == d))
            nodes.append(img[keep])
            owners.append(np.nonzero(keep)[0])
        nodes, owners = np.concatenate(nodes), np.concatenate(owners)
        diff = nodes[None, :, :] - nodes[:, None, :]  # [dst, src]
        dist = np.linalg.norm(diff, axis=-1)
        dst, src = np.nonzero((dist < r_max) & (dist > 1e-9))
        res = wrapper.compute(diff[dst, src], dst, src, np.zeros(len(nodes), dtype=int), n_local=len(local_idx))
        e_sum += res["total_energy"]
        np.add.at(f_acc, owners, _edge_force_sum(len(nodes), dst, src, res["edge_forces"]))
    np.testing.assert_allclose(e_sum, e_full, rtol=1e-9)
    np.testing.assert_allclose(f_acc, f_full, atol=1e-9)


def _pairs(n=12, seed=0):
    pos = np.random.RandomState(seed).uniform(0, 6, (n, 3))
    frame = compute_neighborlist_(from_dict({_keys.POSITIONS_KEY: pos, _keys.ATOM_TYPE_KEY: np.zeros(n, int)}), 4.0)
    ei = frame[_keys.EDGE_INDEX_KEY]
    return pos[ei[1]] - pos[ei[0]], ei[0], ei[1], np.zeros(n, int), n


@pytest.mark.parametrize("jax_impl", ["xla", "pallas_fused"])
def test_wrappers_agree_on_a_pair_file_both_ways(jax_impl, tmp_path):
    jmodel = JaxNequIPGNNModel(tp_impl=jax_impl, **SMALL)
    jw = JaxPairStyleWrapper(jmodel, jmodel.init_params())
    args = _pairs()
    want = jw.compute(*args)
    path = str(tmp_path / "jax.nequip_tpu.pair.pkl")
    jw.save(path)
    port = NequIPPairStyleWrapper.load(path, device="cpu")
    assert port.model.model_config["tp_impl"] == {"xla": "torch", "pallas_fused": "fused"}[jax_impl]
    got = port.compute(*args)
    np.testing.assert_allclose(got["total_energy"], want["total_energy"], rtol=1e-10)
    np.testing.assert_allclose(got["atomic_energies"], want["atomic_energies"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(got["edge_forces"], want["edge_forces"], rtol=0, atol=1e-8)

    back = str(tmp_path / "port.nequip_tpu.pair.pkl")
    port.save(back)
    with open(back, "rb") as f:
        assert pickle.load(f)["model_config"]["_target_"].startswith("nequip_tpu.model.")
    again = JaxPairStyleWrapper.load(back).compute(*args)
    np.testing.assert_allclose(again["total_energy"], want["total_energy"], rtol=1e-12)
    np.testing.assert_allclose(again["edge_forces"], want["edge_forces"], rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="pair-style file"):
        with open(back, "wb") as f:
            pickle.dump({"format": "something else"}, f)
        NequIPPairStyleWrapper.load(back, device="cpu")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """One epoch of the port's minimal_lj.yaml on the CPU, tp_impl "fused"."""
    tmp = tmp_path_factory.mktemp("pair")
    port_train.main(["-cn", "minimal_lj", "-cp", str(port_train.__file__).rsplit("/scripts/", 1)[0] + "/configs",
                     "--device", "cpu", "++trainer.max_epochs=1", f"++trainer.ckpt_dir={tmp}",
                     "++training_module.model.tp_impl=fused"])
    return tmp / "best.ckpt"


def test_prepare_pair_style_cli(ckpt, tmp_path, monkeypatch):
    out = str(tmp_path / "m.nequip_tpu.pair.pkl")
    prepare_pair_style.main([str(ckpt), out, "--device", "cpu"])
    args = _pairs(seed=5)
    got = NequIPPairStyleWrapper.load(out, device="cpu").compute(*args)
    want = NequIPPairStyleWrapper(load_saved_model(str(ckpt)), device="cpu").compute(*args)
    assert got["total_energy"] == want["total_energy"]
    np.testing.assert_array_equal(got["edge_forces"], want["edge_forces"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_pair_style.main([str(ckpt), out])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NequIPPairStyleWrapper.load(out)


def test_pair_nequip_program_matches_eager(ckpt, tmp_path):
    """The pair_nequip program, exported from a wrapper's padded batch and
    through the CLI, against the eager wrapper; called on a batch without
    the layout, the loader returns the edge forces in the batch's order."""
    wrapper = NequIPPairStyleWrapper(load_saved_model(str(ckpt)), device="cpu")
    assert wrapper.model.uses_fused_kernels
    args = _pairs(seed=6)
    want = wrapper.compute(*args)
    batch = wrapper.padded_batch(*args)
    path = str(tmp_path / "pair.zip")
    meta = save_compiled_model(path, wrapper.model, [relayout_edge_stream(batch)], target="pair_nequip")
    assert meta["output_fields"] == [_keys.TOTAL_ENERGY_KEY, _keys.PER_ATOM_ENERGY_KEY, _keys.EDGE_FORCE_KEY]
    assert meta["input_fields"][0] == _keys.EDGE_VECTORS_KEY and _keys.POSITIONS_KEY not in meta["input_fields"]
    validate_artifact(path)
    out = load_compiled_model(path, device="cpu")(batch)
    n_pairs = len(args[1])
    np.testing.assert_allclose(out[_keys.EDGE_FORCE_KEY][:n_pairs].numpy(), want["edge_forces"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(out[_keys.TOTAL_ENERGY_KEY].reshape(-1)[0]), want["total_energy"], rtol=1e-12)

    cli = str(tmp_path / "cli.zip")
    port_compile.main([str(ckpt), cli, "--target", "pair_nequip", "--device", "cpu"])  # with its self-check
    assert load_compiled_model(cli, device="cpu").metadata["target"] == "pair_nequip"
    with pytest.raises(ValueError, match="takes edge vectors"):
        save_compiled_model(str(tmp_path / "x.zip"), wrapper.model,
                            [{k: v for k, v in relayout_edge_stream(batch).items() if k != _keys.EDGE_VECTORS_KEY}],
                            target="pair_nequip")
