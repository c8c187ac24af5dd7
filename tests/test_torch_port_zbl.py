"""The ZBL and Lennard-Jones pair potentials of the port against the JAX
package, in float64 on the CPU.

* ZBL against the LAMMPS golden table of the upstream tests where that
  table is present (the JAX package's ``test_zbl_golden.py`` case), and
  always against the ZBL formula and its derivative written out in numpy
  (LAMMPS ``pair_zbl_const.h`` constants) at 1e-12;
* ``ZBLPairPotential`` and ``LennardJones`` (as a NequIP model's
  ``pair_potential``) against JAX at 1e-12 on a two-species periodic frame
  with close pairs and padding;
* a narrow NequIP model with ZBL under every ``tp_impl``: energy rel
  1e-10, forces and stress 1e-8 of their max;
* one rr force+stress-loss step against JAX (loss rel 1e-10, gradients
  1e-8 of max, the tolerance of ``test_torch_port_train.py``) and the fr
  step against rr (rel 1e-10 and 1e-10 of max |grad|), chunked too;
* the edge-vector (pair style) branch with ZBL: edge forces in the
  caller's order under the fused kernels' re-layout;
* ``model_config`` rebuilds a ZBL model with equal tensors and outputs,
  and its exported program (``save_compiled_model``, traced by
  ``make_fx``) equals the eager model (1e-12).
"""

import importlib.util
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from nequip_tpu.data import batched_from_list as j_batched
from nequip_tpu.data import compute_neighborlist_ as j_nl
from nequip_tpu.data import from_dict as j_from_dict
from nequip_tpu.data import pad_batch as j_pad
from nequip_tpu.data import to_device
from nequip_tpu.model import NequIPGNNModel as JModel
from nequip_tpu.model import ZBLPairPotential as JZBLPairPotential
from nequip_tpu.train import EnergyForceStressLoss as JLoss

from nequip_tpu_torch.data import _keys, batched_from_list, compute_neighborlist_, from_dict, pad_batch, to_tensors
from nequip_tpu_torch.integrations import NequIPPairStyleWrapper
from nequip_tpu_torch.model import NequIPGNNModel, ZBLPairPotential, flatten_tree, jax_named_grads, load_jax_params
from nequip_tpu_torch.model import load_compiled_model, save_compiled_model
from nequip_tpu_torch.nn.pair_potential import ZBL
from nequip_tpu_torch.ops.kernels.tp_scatter import relayout_edge_stream
from nequip_tpu_torch.train import EnergyForceStressLoss, NequIPTrainModule
from nequip_tpu_torch.utils.config import instantiate, retarget

ROOT = Path(__file__).resolve().parents[1]
_SPECIES = ["H", "C", "N", "O", "Cu", "Au"]
_Z = {"H": 1, "C": 6, "N": 7, "O": 8, "Cu": 29, "Au": 79}
ZBL_CFG = {"_target_": "nequip_tpu.nn.pair_potential.ZBL", "units": "metal", "chemical_species": ["Cu", "H"]}
LJ_CFG = {"_target_": "nequip_tpu.nn.pair_potential.LennardJones", "lj_sigma": {"Cu": 2.2, "Cu,H": 1.6, "H": 1.0},
          "lj_epsilon": 0.05, "polynomial_cutoff_p": 8.0}
SMALL = dict(seed=3, model_dtype="float64", type_names=["Cu", "H"], r_max=4.0, num_layers=2, l_max=1, parity=False,
             num_features=4, radial_mlp_width=8, avg_num_neighbors=12.0,
             per_type_energy_shifts={"Cu": -3.5, "H": -1.0}, per_type_energy_scales={"Cu": 0.5, "H": 0.3},
             per_edge_type_cutoff={"Cu": 4.0, "H": {"Cu": 3.5, "H": 3.0}})
OUTPUTS = (_keys.TOTAL_ENERGY_KEY, _keys.FORCE_KEY, _keys.STRESS_KEY, _keys.PER_ATOM_ENERGY_KEY)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many tiny ops: one intra-op thread keeps them fast beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame(seed=0, n=14):
    """Two species in a periodic 6 A box, with close pairs (r < 1 A) where ZBL dominates."""
    r = np.random.RandomState(seed)
    pos = r.uniform(0, 6, (n, 3))
    pos[1] = pos[0] + [0.45, 0.1, 0.0]
    pos[3] = pos[2] + [0.0, 0.8, 0.3]
    types = r.randint(0, 2, n)
    types[:4] = [0, 1, 0, 0]
    return {"pos": pos, "cell": np.eye(3) * 6.0, "pbc": np.ones(3, bool), "atom_types": types,
            "total_energy": r.standard_normal((1, 1)), "forces": r.standard_normal((n, 3)),
            "stress": r.standard_normal((1, 3, 3)) * 0.1}


def _batches(frame, n_nodes=32, n_edges=1024):
    j = j_pad(j_batched([j_nl(j_from_dict(dict(frame)), 4.0, backend="kdtree")]), n_nodes, n_edges, 2)
    p = pad_batch(batched_from_list([compute_neighborlist_(from_dict(dict(frame)), 4.0, backend="kdtree")]),
                  n_nodes, n_edges, 2)
    return j, p


def _close(got, want, rel_to_max, key=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel_to_max * float(np.abs(want).max()),
                               err_msg=key)


# --- ZBL alone ---------------------------------------------------------------------
def _pair_batch(r, zi, zj, nl_radius):
    f = from_dict({"pos": np.array([[0.0, 0.0, 0.0], [r, 0.0, 0.0]]),
                   "atom_types": np.array([_SPECIES.index(zi), _SPECIES.index(zj)])})
    return to_tensors(pad_batch(batched_from_list([compute_neighborlist_(f, nl_radius)]), 4, 4, 2))


def _golden_path() -> str:
    """The LAMMPS table the JAX package's test_zbl_golden.py reads (from the upstream checkout)."""
    spec = importlib.util.spec_from_file_location(
        "jax_zbl_golden", ROOT / "tests" / "unit" / "model" / "test_zbl_golden.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module._GOLDEN


_GOLDEN = _golden_path()


@pytest.mark.skipif(not os.path.exists(_GOLDEN), reason="the LAMMPS golden table is not present")
def test_zbl_matches_lammps_golden():
    model = ZBLPairPotential(seed=123, model_dtype="float64", r_max=9.0, polynomial_cutoff_p=80, type_names=_SPECIES,
                             chemical_species=_SPECIES, units="metal")
    inv = {z: s for s, z in _Z.items()}
    checked = 0
    for r, zi, zj, pe, fxi, fxj in np.load(_GOLDEN):
        if r >= 8.0:
            continue
        out = model(_pair_batch(r, inv[int(zi)], inv[int(zj)], 8.0))
        forces = out[_keys.FORCE_KEY][:2].detach().numpy()
        np.testing.assert_allclose(forces[0, 0], fxi, atol=1e-5)
        np.testing.assert_allclose(forces[1, 0], fxj, atol=1e-5)
        np.testing.assert_allclose(float(out[_keys.TOTAL_ENERGY_KEY][0, 0].detach()), pe, atol=1e-4)
        checked += 1
    assert checked > 1000


def _zbl_numpy(r, zi, zj, r_max, p, qqr2e):
    """ZBL pair energy times the polynomial cutoff, and its r-derivative."""
    a = (zi**0.23 + zj**0.23) / 0.46850
    c = np.array([0.02817, 0.28022, 0.50986, 0.18175])
    d = np.array([-0.20162, -0.40290, -0.94229, -3.19980])
    psi, dpsi = (c * np.exp(d * a * r)).sum(), (c * d * a * np.exp(d * a * r)).sum()
    e = qqr2e * zi * zj / r * psi
    de = qqr2e * zi * zj * (dpsi / r - psi / r**2)
    x = r / r_max
    f = 1 - (p + 1) * (p + 2) / 2 * x**p + p * (p + 2) * x ** (p + 1) - p * (p + 1) / 2 * x ** (p + 2)
    df = (-(p + 1) * (p + 2) / 2 * p * x ** (p - 1) + p * (p + 2) * (p + 1) * x**p
          - p * (p + 1) / 2 * (p + 2) * x ** (p + 1)) / r_max
    return e * f, de * f + e * df


@pytest.mark.parametrize("units", ["metal", "real"])
def test_zbl_matches_the_formula(units):
    qqr2e = {"metal": 14.399645, "real": 332.06371}[units]
    model = ZBLPairPotential(seed=0, model_dtype="float64", r_max=5.0, polynomial_cutoff_p=6, type_names=_SPECIES,
                             chemical_species=_SPECIES, units=units)
    for zi, zj in [("H", "H"), ("C", "O"), ("Cu", "Au"), ("N", "Cu")]:
        for r in (0.1, 0.5, 1.3, 2.7, 4.6):
            out = model(_pair_batch(r, zi, zj, 5.0))
            e, de = _zbl_numpy(r, _Z[zi], _Z[zj], 5.0, 6.0, qqr2e)
            assert float(out[_keys.TOTAL_ENERGY_KEY][0, 0].detach()) == pytest.approx(e, rel=1e-12)
            forces = out[_keys.FORCE_KEY][:2, 0].detach().numpy()
            np.testing.assert_allclose(forces, [de, -de], rtol=1e-12, atol=1e-12 * abs(de))


def test_zbl_pair_potential_matches_jax():
    species = ["Cu", "H"]
    kw = dict(seed=0, model_dtype="float64", r_max=4.0, type_names=species, chemical_species=species, units="metal")
    jm = JZBLPairPotential(**kw)
    jb, pb = _batches(_frame())
    want = jax.jit(jm)(jm.init_params(), to_device(jb))
    got = ZBLPairPotential(**kw)(to_tensors(pb))
    for k in OUTPUTS:
        _close(got[k].detach().numpy(), want[k], 1e-12, k)
    assert abs(float(got[_keys.TOTAL_ENERGY_KEY][0, 0])) > 10.0  # the close pairs' repulsion


# --- in a NequIP model ---------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_ref():
    """JAX params and outputs of the small model with ZBL and with LJ."""
    jb, pb = _batches(_frame())
    out = {}
    for name, pp in (("zbl", ZBL_CFG), ("lj", LJ_CFG)):
        jm = JModel(tp_impl="xla", pair_potential=pp, **SMALL)
        params = jm.init_params()
        res = jax.jit(jm)(params, to_device(jb))
        out[name] = (flatten_tree(jax.tree.map(np.asarray, params)), {k: np.asarray(res[k]) for k in OUTPUTS})
    return out, pb


@pytest.mark.parametrize("tp_impl", ["torch", "fused", "fused_tp"])
@pytest.mark.parametrize("pp", ["zbl", "lj"])
def test_model_with_pair_potential_matches_jax(jax_ref, pp, tp_impl):
    ref, pb = jax_ref
    params, want = ref[pp]
    model = load_jax_params(NequIPGNNModel(tp_impl=tp_impl, pair_potential=retarget({"zbl": ZBL_CFG, "lj": LJ_CFG}[pp]),
                                           **SMALL), params)
    got = model(to_tensors(pb))
    e, e_ref = got[_keys.TOTAL_ENERGY_KEY].detach().numpy(), want[_keys.TOTAL_ENERGY_KEY]
    np.testing.assert_allclose(e, e_ref, rtol=1e-10, atol=0)
    for k in (_keys.FORCE_KEY, _keys.STRESS_KEY):
        _close(got[k].detach().numpy(), want[k], 1e-8, k)
    assert isinstance(model.model.func.pair_potential, ZBL if pp == "zbl" else object)


def test_model_config_rebuilds_a_zbl_model(jax_ref):
    _, pb = jax_ref
    model = NequIPGNNModel(tp_impl="fused", pair_potential=retarget(ZBL_CFG), **SMALL)
    cfg = json.loads(json.dumps(model.model_config))
    assert cfg["pair_potential"] == retarget(ZBL_CFG)
    assert retarget(JModel(tp_impl="pallas_fused", pair_potential=ZBL_CFG, **SMALL).model_config) == cfg
    rebuilt = instantiate(cfg, _recursive_=False)
    for (name, a), (_, b) in zip(model.jax_named_tensors(), rebuilt.jax_named_tensors()):
        assert torch.equal(a, b), name
    a, b = model(to_tensors(pb)), rebuilt(to_tensors(pb))
    for k in OUTPUTS:
        assert torch.equal(a[k], b[k]), k


def test_compiled_zbl_model_matches_eager(jax_ref, tmp_path):
    _, pb = jax_ref
    model = NequIPGNNModel(tp_impl="fused", pair_potential=retarget(ZBL_CFG), **SMALL)
    batch = relayout_edge_stream(to_tensors(pb))
    eager = model(batch)
    art = str(tmp_path / "zbl.nequip_tpu_torch.zip")
    save_compiled_model(art, model, batch)
    got = load_compiled_model(art, device="cpu")(batch)
    for k in (_keys.TOTAL_ENERGY_KEY, _keys.FORCE_KEY, _keys.STRESS_KEY):
        _close(got[k].detach().numpy(), eager[k].detach().numpy(), 1e-12, k)


# --- training --------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_step():
    """JAX params, loss and gradients of one rr energy+forces+stress step."""
    jm = JModel(tp_impl="xla", pair_potential=ZBL_CFG, **SMALL)
    params = jm.init_params()
    jb, pb = _batches(_frame(seed=4), n_edges=768)
    batch = to_device(jb)
    loss_mgr = JLoss()

    def loss_fn(p):
        return loss_mgr.values(loss_mgr.batch_state(jm(p, batch), batch), loss_mgr.coeff_vector())[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    flat = lambda t: flatten_tree(jax.tree.map(np.asarray, t))  # noqa: E731
    return flat(params), float(loss), flat(grads), pb


def _port_step(jax_step, tp_impl, mode, n_chunks=0):
    params, _, _, pb = jax_step
    model = load_jax_params(NequIPGNNModel(tp_impl=tp_impl, pair_potential=retarget(ZBL_CFG), **SMALL), params)
    module = NequIPTrainModule(model, loss=EnergyForceStressLoss(), force_grad_mode=mode, fr_edge_chunks=n_chunks,
                               device="cpu")
    batch = to_tensors(pb)
    if mode == "fr":
        loss, _, _ = module.compute_grads_fr(batch)
    else:
        loss, _, _ = module.compute_loss(batch)
        loss.backward()
    return float(loss.detach()), jax_named_grads(model)


@pytest.mark.parametrize("tp_impl", ["torch", "fused"])
def test_rr_step_with_zbl_matches_jax(jax_step, tp_impl):
    _, want_loss, want_grads, _ = jax_step
    loss, grads = _port_step(jax_step, tp_impl, "rr")
    assert loss == pytest.approx(want_loss, rel=1e-10)
    assert grads
    for k, g in grads.items():
        _close(g, want_grads[k], 1e-8, k)


@pytest.mark.parametrize("tp_impl,n_chunks", [("torch", 0), ("fused", 0), ("fused", 3)])
def test_fr_step_with_zbl_matches_rr(jax_step, tp_impl, n_chunks):
    rr_loss, rr = _port_step(jax_step, tp_impl, "rr")
    fr_loss, fr = _port_step(jax_step, tp_impl, "fr", n_chunks)
    assert fr_loss == pytest.approx(rr_loss, rel=1e-10)
    assert set(fr) == set(rr)
    for k, g in fr.items():
        _close(g, rr[k], 1e-10, k)


# --- the pair style's edge branch -----------------------------------------------------
def test_edge_forces_with_zbl_follow_the_callers_order():
    """The fused model re-lays the edges out for its kernels; ZBL reads them
    in that order and the edge forces come back in the engine's order,
    equal to the plain model's."""
    frame = _frame(seed=6)
    n = len(frame["pos"])
    data = compute_neighborlist_(from_dict({"pos": frame["pos"], "atom_types": frame["atom_types"]}), 4.0)
    ei = data[_keys.EDGE_INDEX_KEY]
    perm = np.random.RandomState(1).permutation(ei.shape[1])  # an engine's own pair order
    dst, src = ei[0][perm], ei[1][perm]
    vec = frame["pos"][src] - frame["pos"][dst]
    res = {}
    for impl in ("torch", "fused"):
        model = NequIPGNNModel(tp_impl=impl, pair_potential=retarget(ZBL_CFG), **SMALL)
        res[impl] = NequIPPairStyleWrapper(model, device="cpu").compute(vec, dst, src, frame["atom_types"], n_local=n)
    np.testing.assert_allclose(res["fused"]["total_energy"], res["torch"]["total_energy"], rtol=1e-12)
    _close(res["fused"]["edge_forces"], res["torch"]["edge_forces"], 1e-12)
    assert float(np.abs(res["torch"]["edge_forces"]).max()) > 1.0  # the close pairs' ZBL forces
