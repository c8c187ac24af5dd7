"""fr (reverse-over-forward) force-loss training of the port against the JAX
package and against the port's own rr step, float64.

The model and frame are those of ``tests/unit/train/test_fr_chunked.py``:
2 layers, l_max 1, 4 features, two atom types, 150 atoms at random
positions padded to 256 nodes and 4,096 edge slots, at the JAX parameters
(``load_jax_params``).  The JAX side runs ``tp_impl="pallas"`` with its
Pallas kernels in interpret mode and its chunked sweep switched by
``NEQUIP_FR_EDGE_CHUNKS``, each reference jitted as one program.

* each module's ``jvp`` along the energy graph against the JAX module's
  (values and tangents; per-edge fields matched by (dst, src) pair);
* ``loss_surrogate``'s value and parameter gradients for C in {0, 2, 3}
  and every ``tp_impl`` against JAX fr and against the port's rr;
* one fr Adam step of ``EMATrainModule`` against the JAX fr train step;
* a 2-epoch ``Trainer.fit`` in fr against rr;
* the kernels each fr form runs (plain twins on the CPU), bitwise repeatable
  chunked gradients, and the configurations that raise.

Tolerances: 1e-12 of max(1, max |ref|) for the module values and tangents,
1e-10 of max |grad| (and rel 1e-10 for the surrogate) for gradients:
float64 sums in another order through two layers and one reverse pass;
1e-12 absolute for the parameters after one Adam step (lr 1e-3).
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nequip_tpu.data import _keys as jkeys
from nequip_tpu.data.atomic_data_dict import batched_from_list, from_dict, pad_batch
from nequip_tpu.data.transforms.neighborlist import NeighborListTransform as JNL
from nequip_tpu.model import NequIPGNNModel as JModel
from nequip_tpu.ops.pallas.tp_scatter import relayout_edge_stream as jrelayout
from nequip_tpu.train import EMATrainModule as JEMAModule
from nequip_tpu.train import EnergyForceLoss as JLoss

from nequip_tpu_torch.data import NequIPDataModule, _keys, to_tensors
from nequip_tpu_torch.data.dataset import LJTestDataset
from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper, NeighborListTransform
from nequip_tpu_torch.model import NequIPGNNModel, flatten_tree, jax_named_grads, load_jax_params
from nequip_tpu_torch.ops.kernels import tp_scatter as K
from nequip_tpu_torch.train import EMATrainModule, EnergyForceLoss, EnergyForceMetrics, NequIPTrainModule, Trainer
from nequip_tpu_torch.train.training_module import edge_chunks

CFG = dict(seed=11, model_dtype="float64", type_names=["Cu", "H"], r_max=4.0, num_layers=2, l_max=1, parity=False,
           num_features=4, radial_mlp_width=8, avg_num_neighbors=12.0, per_type_energy_shifts={"Cu": -0.4, "H": -0.1})
NODE_FIELDS = (jkeys.NODE_FEATURES_KEY, jkeys.NODE_ATTRS_KEY, jkeys.PER_ATOM_ENERGY_KEY, jkeys.TOTAL_ENERGY_KEY)
EDGE_FIELDS = (jkeys.EDGE_ATTRS_KEY, jkeys.EDGE_EMBEDDING_KEY, jkeys.EDGE_LENGTH_KEY)
CHUNKS = (0, 2, 3)


@contextlib.contextmanager
def _jax_chunks(n_chunks: int):
    """The JAX package's trace-time chunk switch, restored afterwards."""
    old = os.environ.get("NEQUIP_FR_EDGE_CHUNKS")
    os.environ.pop("NEQUIP_FR_EDGE_CHUNKS", None)
    if n_chunks:
        os.environ["NEQUIP_FR_EDGE_CHUNKS"] = str(n_chunks)
    try:
        yield
    finally:
        os.environ.pop("NEQUIP_FR_EDGE_CHUNKS", None)
        if old is not None:
            os.environ["NEQUIP_FR_EDGE_CHUNKS"] = old


@pytest.fixture(scope="module")
def s():
    jmodel = JModel(tp_impl="pallas", **CFG)
    params = jmodel.init_params()
    r = np.random.RandomState(5)
    n = 150
    pos = r.standard_normal((n, 3)) * 3.0
    frame = JNL(r_max=4.0)(from_dict({jkeys.POSITIONS_KEY: pos, jkeys.ATOM_TYPE_KEY: r.randint(0, 2, n)}))
    batch = {k: np.asarray(v) for k, v in pad_batch(batched_from_list([frame]), n_nodes=256, n_edges=4096).items()}
    r = np.random.RandomState(7)
    v = {jkeys.FORCE_KEY: r.standard_normal(batch[jkeys.POSITIONS_KEY].shape),
         jkeys.TOTAL_ENERGY_KEY: r.standard_normal((1, 1))}
    r = np.random.RandomState(2)
    labels = {jkeys.TOTAL_ENERGY_KEY: r.standard_normal((1, 1)),
              jkeys.FORCE_KEY: r.standard_normal(batch[jkeys.POSITIONS_KEY].shape)}

    fso = jmodel.model
    inputs = jrelayout({k: batch[k] for k in jmodel.input_fields if k in batch})
    jv = {k: jnp.asarray(a) for k, a in v.items()}
    surrogate = {}
    for c in CHUNKS:
        with _jax_chunks(c):
            val, grads = jax.jit(jax.value_and_grad(lambda p, i: fso.loss_surrogate(p, i, jv)))(params, inputs)
        surrogate[c] = (float(val), flatten_tree(jax.tree.map(np.asarray, grads)))
    return dict(jmodel=jmodel, params=params, flat=flatten_tree(jax.tree.map(np.asarray, params)), batch=batch,
                v=v, labels=labels, inputs=inputs, surrogate=surrogate)


def _port_model(s, tp_impl):
    return load_jax_params(NequIPGNNModel(tp_impl=tp_impl, **CFG), s["flat"])


def _port_batch(s, labels=False):
    return to_tensors(dict(s["batch"], **(s["labels"] if labels else {})), "cpu")


def _port_v(s):
    return {k: torch.as_tensor(a) for k, a in s["v"].items()}


def _grads_close(got, want, err=""):
    assert set(got) <= set(want) and got
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], rtol=0, atol=1e-10 * float(np.abs(want[k]).max()), err_msg=f"{err} {k}")


def _close(got, want, msg):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-12 * max(1.0, float(np.abs(want).max())),
                               err_msg=msg)


@pytest.mark.parametrize("tp_impl,n_chunks", [("torch", 0), ("fused", 0), ("fused", 2), ("fused", 3),
                                              ("fused_tp", 0), ("fused_tp", 2), ("fused_tp", 3)])
def test_loss_surrogate_matches_jax_fr_and_port_rr(s, tp_impl, n_chunks):
    model = _port_model(s, tp_impl)
    batch, v = _port_batch(s), _port_v(s)
    with edge_chunks(model, n_chunks):
        surrogate = model.loss_surrogate(batch, v)
    surrogate.backward()
    fr = jax_named_grads(model)
    want_val, want = s["surrogate"][n_chunks]
    assert float(surrogate.detach()) == pytest.approx(want_val, rel=1e-10)
    _grads_close(fr, want, "vs JAX fr")

    # rr: the same inner product through the force VJP, differentiated again
    model.zero_grad(set_to_none=True)
    out = model(batch)
    rr_val = sum((v[k] * out[k]).sum() for k in v)
    rr_val.backward()
    assert float(rr_val.detach()) == pytest.approx(want_val, rel=1e-10)
    _grads_close(fr, jax_named_grads(model), "vs port rr")


@pytest.mark.parametrize("n_chunks", [0, 2])
def test_module_jvps_match_jax(s, n_chunks):
    """Each module of the energy graph, one dual-number step after the
    other, from the same positions tangent."""
    jmodel, params = s["jmodel"], s["params"]
    t_pos = -s["v"][jkeys.FORCE_KEY]

    def sweep(params, data, tangents):
        snaps = []
        for name, m in jmodel.model.func.module_dict.items():
            data, tangents = m.jvp(params.get(name, {}), data, tangents)
            keep = NODE_FIELDS + EDGE_FIELDS
            snaps.append(({k: data[k] for k in keep if k in data}, {k: tangents[k] for k in keep if k in tangents}))
        return snaps

    with _jax_chunks(n_chunks):
        want = jax.jit(sweep)(params, s["inputs"], {jkeys.POSITIONS_KEY: jnp.asarray(t_pos)})

    model = _port_model(s, "fused_tp")
    data = model._inputs(_port_batch(s))
    tangents = {_keys.POSITIONS_KEY: torch.as_tensor(t_pos)}
    jei = np.asarray(s["inputs"][jkeys.EDGE_INDEX_KEY])
    jslot = {(int(d), int(e)): i for i, (d, e, m) in enumerate(zip(*jei, np.asarray(s["inputs"][jkeys.EDGE_MASK_KEY])))
             if m}
    n_real = data[K.LAYOUT_KEY].n_real
    rows = [jslot[(int(d), int(e))] for d, e in data[_keys.EDGE_INDEX_KEY][:, :n_real].T.tolist()]
    names = list(jmodel.model.func.module_dict)
    modules = list(model.model.func.children())
    assert len(names) == len(modules)
    with torch.no_grad(), edge_chunks(model, n_chunks):
        for name, m, (jd, jt) in zip(names, modules, want):
            data, tangents = m.jvp(data, tangents)
            for k in NODE_FIELDS + EDGE_FIELDS:
                if k not in jd:
                    continue
                sel = (lambda a: np.asarray(a)[rows]) if k in EDGE_FIELDS else np.asarray
                _close(data[k].numpy()[:n_real] if k in EDGE_FIELDS else data[k].numpy(), sel(jd[k]),
                       f"{name} {k}")
                if k in tangents:
                    got = tangents[k].numpy()
                    _close(got[:n_real] if k in EDGE_FIELDS else got, sel(jt[k]), f"{name} tangent {k}")
                elif k in jt:  # no tangent here: JAX's is a dense zero
                    assert not np.asarray(jt[k]).any(), f"{name} tangent {k}"


def test_fr_adam_step_matches_jax(s):
    """One fr step (edge-chunked, C = 2) of EMATrainModule with Adam against
    the JAX fr train step at the same parameters."""
    jmodule = JEMAModule(model=s["jmodel"], loss=JLoss(type_names=["Cu", "H"]),
                         optimizer={"_target_": "optax.adam", "learning_rate": 1e-3},
                         force_grad_mode="fr", fr_edge_chunks=2)
    with _jax_chunks(2):
        state = jmodule.init_state().replace(params=s["params"])
        step = jax.jit(jmodule.make_train_step())
        data = {k: jnp.asarray(a) for k, a in dict(s["batch"], **s["labels"]).items()}
        state, logs = step(state, data, jmodule.loss.coeff_vector())
    want = flatten_tree(jax.tree.map(np.asarray, state.params))

    model = _port_model(s, "fused")
    module = EMATrainModule(model, loss=EnergyForceLoss(type_names=["Cu", "H"]),
                            optimizer={"_target_": "optax.adam", "learning_rate": 1e-3},
                            force_grad_mode="fr", fr_edge_chunks=2, device="cpu")
    values = module.training_step(_port_batch(s, labels=True))
    assert float(values["train_loss_step/weighted_sum"]) == pytest.approx(
        float(logs["train_loss_step/weighted_sum"]), rel=1e-12)
    for k, t in model.jax_named_tensors():
        np.testing.assert_allclose(t.detach().numpy(), want[k], rtol=0, atol=1e-12, err_msg=k)


def _lj_datamodule():
    ds = LJTestDataset(num_frames=5, seed=3, transforms=[ChemicalSpeciesToAtomTypeMapper(["Cu"]),
                                                         NeighborListTransform(4.0)])
    return NequIPDataModule(seed=1, split_dataset={"dataset": ds, "train": 4, "val": 1},
                            train_dataloader={"batch_size": 2}, val_dataloader={"batch_size": 1}, device="cpu")


def test_fr_trainer_fit_matches_rr(tmp_path):
    """Two epochs of Trainer.fit with fr over 3 edge slices against rr, from
    the same weights: the same losses per epoch."""
    cfg = dict(seed=4, model_dtype="float64", type_names=["Cu"], r_max=4.0, num_layers=2, l_max=1, parity=False,
               num_features=4, radial_mlp_width=8, avg_num_neighbors=15.0)
    rows = {}
    for mode, n_chunks in (("rr", 0), ("fr", 3)):
        module = NequIPTrainModule(NequIPGNNModel(tp_impl="fused_tp", **cfg), loss=EnergyForceLoss(),
                                   val_metrics=EnergyForceMetrics(),
                                   optimizer={"_target_": "optax.adam", "learning_rate": 5e-3},
                                   force_grad_mode=mode, fr_edge_chunks=n_chunks, device="cpu")
        trainer = Trainer(max_epochs=2, ckpt_dir=str(tmp_path / mode))
        trainer.fit(module, _lj_datamodule())
        rows[mode] = trainer.metrics_rows
    assert len(rows["fr"]) == 2
    for got, want in zip(rows["fr"], rows["rr"]):
        for key in ("train_loss_epoch/weighted_sum", "train_loss_epoch/forces_mse", "val0_epoch/weighted_sum"):
            assert got[key] == pytest.approx(want[key], rel=1e-10), key


@pytest.mark.parametrize("n_chunks", [0, 3])
def test_fr_runs_the_expected_kernels(s, n_chunks, monkeypatch):
    """Unchunked fr runs the serving kernels in pass 1 and K1/K2-train/K4/K5
    in pass 2; chunked fr runs K4/K4-acc, K5, K6, K7 and K3, and no K1/K2
    (the plain twins stand for the kernels on the CPU)."""
    calls = set()
    names = ("conv_fwd_plain", "conv_bwd_plain", "conv_bwd_train_plain", "tri_fwd_plain", "tri_bwd_plain",
             "jvp_fwd_plain", "jvp_bwd_plain", "scatter_rows_plain")
    for name in names:
        orig = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _o=orig, _n=name: calls.add(_n) or _o(*a))
    model = _port_model(s, "fused")
    module = NequIPTrainModule(model, loss=EnergyForceLoss(type_names=["Cu", "H"]), force_grad_mode="fr",
                               fr_edge_chunks=n_chunks, device="cpu")
    module.compute_grads_fr(_port_batch(s, labels=True))
    if n_chunks:
        assert calls == {"tri_fwd_plain", "tri_bwd_plain", "jvp_fwd_plain", "jvp_bwd_plain", "scatter_rows_plain"}
    else:
        assert calls == {"conv_fwd_plain", "conv_bwd_plain", "conv_bwd_train_plain", "tri_fwd_plain",
                         "tri_bwd_plain", "scatter_rows_plain"}
    assert all(b.fr_edge_chunks == 0 for b in model.modules() if hasattr(b, "fr_edge_chunks"))


def test_chunked_fr_grads_are_bitwise_repeatable(s):
    model = _port_model(s, "fused")
    module = NequIPTrainModule(model, loss=EnergyForceLoss(type_names=["Cu", "H"]), force_grad_mode="fr",
                               fr_edge_chunks=3, device="cpu")
    runs = []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        module.compute_grads_fr(_port_batch(s, labels=True))
        runs.append(jax_named_grads(model))
    for k in runs[0]:
        np.testing.assert_array_equal(runs[0][k], runs[1][k], err_msg=k)


@pytest.mark.parametrize("kwargs,tp_impl", [
    (dict(force_grad_mode="fr", fr_edge_chunks=1), "fused"),
    (dict(force_grad_mode="fr", fr_edge_chunks=-2), "fused"),
    (dict(force_grad_mode="fr", fr_edge_chunks=2.0), "fused"),
    (dict(force_grad_mode="rr", fr_edge_chunks=2), "fused"),
    (dict(force_grad_mode="fr", fr_edge_chunks=2), "torch"),
    (dict(force_grad_mode="rf"), "fused"),
])
def test_bad_fr_configurations_raise(kwargs, tp_impl):
    model = NequIPGNNModel(tp_impl=tp_impl, **CFG)
    with pytest.raises(ValueError):
        NequIPTrainModule(model, loss=EnergyForceLoss(type_names=["Cu", "H"]), device="cpu", **kwargs)


def test_more_slices_than_edges_raise(s):
    module = NequIPTrainModule(_port_model(s, "fused_tp"), loss=EnergyForceLoss(type_names=["Cu", "H"]),
                               force_grad_mode="fr", fr_edge_chunks=10**6, device="cpu")
    with pytest.raises(ValueError, match="fr_edge_chunks"):
        module.compute_grads_fr(_port_batch(s, labels=True))
