"""The model builder's options in the port against the JAX builder, float64.

Each case builds the same config with both builders (the JAX side at
``tp_impl="xla"``, the port at ``"fused"``: the kernels' plain twins on the
CPU, K1's route or, for a radial MLP K1 does not take, K4's), loads the JAX
tree into the port (``load_jax_params``: the new leaves ``embed_<field>``,
trainable scales, shifts and Bessel frequencies included) and compares on
a 32-atom, two-species fcc frame: E rel 1e-10, F and stress 1e-8.

For the trainable leaves and the remat modes, the gradients of a force
loss (rr: reverse over reverse) match ``jax.grad`` at 1e-8 of max |grad|,
and the port's set of trainable parameters is the JAX tree minus its
frozen leaves.  One fr case (``loss_surrogate``) runs with
``remat_conv=True`` on both sides.  The modules that the options build
are held against their JAX counterparts one by one.

``parametrization``: ``spectral_norm`` and ``orthogonal`` compute in
float32 whatever the model dtype, in JAX and in the port alike, so they
are held at a float32 tolerance (1e-5); ``weight_norm`` at 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nequip_tpu.data import _key_registry as jreg
from nequip_tpu.data import atomic_data_dict as jadd
from nequip_tpu.data import batched_from_list as j_batched
from nequip_tpu.data import compute_neighborlist_ as j_nl
from nequip_tpu.data import from_dict as j_from_dict
from nequip_tpu.data import modifier as jmod
from nequip_tpu.data import pad_batch as j_pad
from nequip_tpu.data import to_device
from nequip_tpu.model import NequIPGNNModel as JModel
from nequip_tpu.model import PresetNequIPGNNModel as JPreset
from nequip_tpu.nn import atomwise as jatom
from nequip_tpu.nn import misc as jmisc
from nequip_tpu.nn.embedding import AppendVectorFieldEmbed as JAppend
from nequip_tpu.nn.embedding import utils as jemb_utils
from nequip_tpu.ops import gate as jgate
from nequip_tpu.ops import mlp as jmlp
from nequip_tpu.ops import scatter as jscatter

from nequip_tpu_torch.data import _key_registry as reg
from nequip_tpu_torch.data import (
    EdgeLengths,
    MappedFieldModifier,
    batched_from_list,
    compute_neighborlist_,
    deregister_fields,
    from_dict,
    pad_batch,
    register_fields,
    to_tensors,
    without_nodes,
)
from nequip_tpu_torch.model import NequIPGNNModel, PresetNequIPGNNModel, flatten_tree, jax_named_grads, load_jax_params
from nequip_tpu_torch.model.modify_utils import modify
from nequip_tpu_torch.nn import AtomwiseLinear, AtomwiseOperation, Concat, SaveForOutput, replace_submodules
from nequip_tpu_torch.nn.embedding import AppendVectorFieldEmbed, cutoff_matrix_to_dict
from nequip_tpu_torch.nn.interaction_block import InteractionBlock
from nequip_tpu_torch.ops import gate, scatter
from nequip_tpu_torch.ops.kernels.tp_scatter import relayout_edge_stream
from nequip_tpu_torch.ops.mlp import ScalarMLP
from nequip_tpu_torch.train.training_module import edge_chunks

BASE = dict(seed=5, model_dtype="float64", type_names=["Cu", "H"], r_max=4.0, num_layers=2, l_max=1, parity=False,
            num_features=4, radial_mlp_width=8, avg_num_neighbors=12.0,
            per_type_energy_shifts={"Cu": -3.0, "H": -1.0}, per_type_energy_scales={"Cu": 0.7, "H": 1.3})
LABEL = "charge_state"  # a per-frame integer label for the categorical embedding
CATEGORICAL = [{"field": LABEL, "min": -1, "max": 1, "num_features": 3}]
CASES = {
    "base": {},
    "categorical": dict(categorical_graph_field_embed=CATEGORICAL),
    "bessel_trainable": dict(bessel_trainable=True),
    "scales_trainable": dict(per_type_energy_scales_trainable=True),
    "shifts_trainable": dict(per_type_energy_shifts_trainable=True),
    "learnable_shift": dict(learnable_shift=True),
    "norm_gate": dict(convnet_nonlinearity_type="norm"),
    "remat_conv": dict(remat_conv=True),
    "remat_save_tp": dict(remat_conv="save_tp"),
    "remat_force": dict(remat_force=True),
    "depth2_mlp": dict(radial_mlp_depth=2),
    "preset_S": dict(preset="S", num_features=[4, 2], radial_mlp_width=8, type_embed_num_features=4),
}
GRAD_CASES = ("base", "bessel_trainable", "scales_trainable", "shifts_trainable", "remat_conv", "remat_save_tp",
              "remat_force", "categorical")
OUTPUTS = ("total_energy", "forces", "stress")
# remat and a trainable flag change neither the JAX tree's values nor its
# gradients (jax.grad differentiates frozen leaves too): these cases reuse
# the base model's compiled JAX program, with their own frozen leaves
SAME_AS_BASE = ("bessel_trainable", "remat_conv", "remat_save_tp", "remat_force")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many tiny ops: one intra-op thread keeps them fast beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def label_field():
    """The categorical label as a registered integer graph field in both
    packages, deregistered afterwards."""
    for r in (reg, jreg):
        r.register_fields(graph_fields=[LABEL], long_fields=[LABEL])
    yield
    for r in (reg, jreg):
        r.deregister_fields(LABEL)
    assert LABEL not in reg._GRAPH_FIELDS and LABEL not in reg._LONG_FIELDS


def _frame():
    r = np.random.RandomState(3)
    a = 3.61
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]) * a
    pos = np.concatenate([base + np.array([i, j, k]) * a for i in range(2) for j in range(2) for k in range(2)])
    return {"pos": pos + r.normal(0, 0.1, pos.shape), "cell": np.diag([2 * a] * 3), "pbc": np.ones(3, bool),
            "atom_types": r.randint(0, 2, len(pos)), LABEL: np.array([1])}


def _batch(nl, batched, pad, mod):
    data = nl(mod(_frame()), 4.0)
    return pad(batched([data]), 40, ((data["edge_index"].shape[1] + 63) // 64) * 64, 2)


@pytest.fixture(scope="module")
def batches(label_field):
    jb = _batch(lambda d, r: j_nl(d, r, backend="kdtree"), j_batched, j_pad, j_from_dict)
    pb = _batch(compute_neighborlist_, batched_from_list, pad_batch, from_dict)
    return {k: np.asarray(v) for k, v in jb.items()}, pb


def _builders(case):
    cfg = dict(BASE, **CASES[case])
    if "preset" in cfg:
        for k in ("num_layers", "l_max", "parity"):
            cfg.pop(k)
        return cfg, JPreset, PresetNequIPGNNModel
    return cfg, JModel, NequIPGNNModel


@pytest.fixture(scope="module")
def jax_runs(batches):
    """Per case: the JAX tree, its outputs and its rr loss gradients."""
    jb, _ = batches
    out = {}
    labels = _labels(jb)
    for case in CASES:
        cfg, jbuild, _ = _builders(case)
        model = jbuild(tp_impl="xla", **cfg)
        frozen = set(_frozen_paths(model))
        if case in SAME_AS_BASE:
            out[case] = dict(out["base"], frozen=frozen)
            continue
        params = model.init_params()
        entry = {"params": flatten_tree(jax.tree.map(np.asarray, params)), "frozen": frozen}
        if case in GRAD_CASES:  # outputs and gradients from one compiled program

            def loss(p, model=model):
                res = model(p, to_device(jb))
                return _loss(res, labels, jnp), res

            (_, res), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
            entry["grads"] = flatten_tree(jax.tree.map(np.asarray, grads))
        else:
            res = jax.jit(model)(params, to_device(jb))
        entry["out"] = {k: np.asarray(res[k]) for k in OUTPUTS}
        out[case] = entry
    return out


def _frozen_paths(model):
    """Dotted paths of the JAX model's frozen leaves."""
    return model.frozen_param_paths() if hasattr(model, "frozen_param_paths") else set()


def _labels(jb):
    r = np.random.RandomState(9)
    return {"total_energy": r.standard_normal((2, 1)), "forces": r.standard_normal(jb["pos"].shape),
            "stress": r.standard_normal((2, 3, 3))}


def _loss(out, labels, xp):
    return sum(xp.sum((out[k] - labels[k]) ** 2) for k in OUTPUTS)


def _port(case, jax_runs, tp_impl="fused"):
    cfg, _, build = _builders(case)
    model = build(tp_impl=tp_impl, **cfg)
    return load_jax_params(model, jax_runs[case]["params"])


def _inputs(model, pb):
    data = to_tensors(pb)
    return relayout_edge_stream(data) if model.uses_fused_kernels else data


def _check_outputs(out, want):
    assert float(out["total_energy"][0, 0]) == pytest.approx(float(want["total_energy"][0, 0]), rel=1e-10)
    for k in ("forces", "stress"):
        np.testing.assert_allclose(out[k].detach().numpy(), want[k], rtol=0, atol=1e-8, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_option_matches_jax(case, jax_runs, batches):
    model = _port(case, jax_runs).requires_grad_(False)
    _check_outputs(model(_inputs(model, batches[1])), jax_runs[case]["out"])
    routes = {m.route for m in model.modules() if isinstance(m, InteractionBlock)}
    assert routes == ({"fused_tp"} if case == "depth2_mlp" else {"fused"})
    assert model.model_config["_target_"].endswith("PresetNequIPGNNModel" if "preset" in case else "NequIPGNNModel")


@pytest.mark.parametrize("case", GRAD_CASES)
def test_option_gradients_match_jax(case, jax_runs, batches):
    """rr force-loss gradients of every trainable leaf against jax.grad; the
    trainable set is the JAX tree minus its frozen leaves."""
    model = _port(case, jax_runs)
    labels = {k: torch.as_tensor(v) for k, v in _labels(batches[0]).items()}
    _loss(model(_inputs(model, batches[1])), labels, torch).backward()
    got, want = jax_named_grads(model), jax_runs[case]["grads"]
    assert set(got) == set(want) - jax_runs[case]["frozen"]
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], rtol=0, atol=1e-8 * float(np.abs(want[k]).max()), err_msg=k)


def test_fr_with_remat_matches_jax(batches):
    """The fr surrogate's gradients with ``remat_conv=True`` (one checkpoint
    of each layer's dual sweep, K6/K7's twins over 2 edge slices) against
    the JAX surrogate with its per-layer ``jax.checkpoint``."""
    jb, pb = batches
    cfg = dict(BASE, remat_conv=True)
    jmodel = JModel(tp_impl="xla", **cfg)
    params = jmodel.init_params()
    r = np.random.RandomState(4)
    v = {"forces": r.standard_normal(jb["pos"].shape), "total_energy": r.standard_normal((2, 1))}
    jv = {k: jnp.asarray(a) for k, a in v.items()}
    inputs = {k: jb[k] for k in jmodel.input_fields if k in jb}
    grads = jax.jit(jax.grad(lambda p: jmodel.model.loss_surrogate(p, to_device(inputs), jv)))(params)
    want = flatten_tree(jax.tree.map(np.asarray, grads))
    model = load_jax_params(NequIPGNNModel(tp_impl="fused", **cfg), flatten_tree(jax.tree.map(np.asarray, params)))
    with edge_chunks(model, 2):
        model.loss_surrogate(_inputs(model, pb), {k: torch.as_tensor(a) for k, a in v.items()}).backward()
    got = jax_named_grads(model)
    assert got
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], rtol=0, atol=1e-8 * float(np.abs(want[k]).max()), err_msg=k)


def test_remat_keeps_outputs_and_gradients(jax_runs, batches):
    """Remat changes neither outputs nor gradients against the run without
    it (the same weights), and the preset records its preset."""
    labels = {k: torch.as_tensor(v) for k, v in _labels(batches[0]).items()}
    grads = {}
    for remat in (False, True, "save_tp"):
        model = load_jax_params(NequIPGNNModel(tp_impl="fused", remat_conv=remat, remat_force=bool(remat), **BASE),
                                jax_runs["remat_conv"]["params"])
        _loss(model(_inputs(model, batches[1])), labels, torch).backward()
        grads[remat] = jax_named_grads(model)
    for remat in (True, "save_tp"):
        for k, g in grads[False].items():
            np.testing.assert_allclose(grads[remat][k], g, rtol=0, atol=1e-12 * float(np.abs(g).max()), err_msg=k)


def test_modify_trainable_scale_shift(jax_runs, batches):
    """``modify_PerTypeScaleShift(..., *_trainable=True)`` makes per-type
    parameters of the new values, which then take gradients."""
    model = _port("remat_conv", jax_runs)
    model = modify(model, [{"modifier": "modify_PerTypeScaleShift", "shifts": {"H": -2.0}, "scales": 2.0,
                            "shifts_trainable": True, "scales_trainable": True}])
    names = dict(model.named_parameters())
    shift = next(t for k, t in names.items() if k.endswith("shifts"))
    scale = next(t for k, t in names.items() if k.endswith("scales"))
    assert shift.detach().reshape(-1).tolist() == [-3.0, -2.0] and scale.detach().reshape(-1).tolist() == [2.0, 2.0]
    assert model.model_config["per_type_energy_shifts_trainable"] is True
    model(_inputs(model, batches[1]))["total_energy"].sum().backward()
    assert shift.grad is not None and scale.grad is not None


# --- the modules the options build, one by one --------------------------------
@pytest.mark.parametrize("parametrization, shape", [(None, (5, 7)), ("weight_norm", (7, 5)),
                                                    ("spectral_norm", (7, 5)), ("orthogonal", (5, 7)),
                                                    ("orthogonal", (7, 5))])
def test_mlp_parametrization_matches_jax(parametrization, shape):
    """As ``tests/unit/ops/test_mlp.py``: values and input/weight gradients
    of a depth-1 MLP with bias under each parametrization."""
    jm = jmlp.ScalarMLP(shape[0], 3, hidden_layers_depth=1, hidden_layers_width=shape[1], bias=True,
                        forward_weight_init=False, parametrization=parametrization)
    params = jax.tree.map(lambda a: np.asarray(a, np.float64), jm.init(jax.random.PRNGKey(1)))
    params = {k: v + (0.1 if k.startswith("b") else 0.0) for k, v in params.items()}
    x = np.random.RandomState(0).standard_normal((6, shape[0]))
    want, (gp, gx) = jax.value_and_grad(lambda p, xx: jnp.sum(jnp.sin(jm(p, xx))), argnums=(0, 1))(params, x)
    m = ScalarMLP(shape[0], 3, hidden_layers_depth=1, hidden_layers_width=shape[1], bias=True,
                  forward_weight_init=False, parametrization=parametrization).double()
    with torch.no_grad():
        for k, p in m.named_parameters():
            p.copy_(torch.as_tensor(params[k]))
    xt = torch.as_tensor(x).requires_grad_(True)
    got = torch.sin(m(xt)).sum()
    got.backward()
    tol = 1e-5 if parametrization in ("spectral_norm", "orthogonal") else 1e-12
    assert float(got) == pytest.approx(float(want), rel=tol, abs=tol)
    np.testing.assert_allclose(xt.grad.numpy(), gx, rtol=0, atol=tol)
    for k, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), gp[k], rtol=0, atol=tol * max(1.0, np.abs(gp[k]).max()))
    assert m.alphas == pytest.approx(jm.alphas, rel=1e-15) and set(dict(m.named_parameters())) == set(params)


def test_norm_activation_matches_jax():
    irreps = "3x0e+2x1o+1x2e"
    x = np.random.RandomState(1).standard_normal((5, 3 + 6 + 5))
    x[0, 3:9] = 0.0  # a zero channel: the epsilon floor
    want = np.asarray(jgate.NormActivation(irreps)(jnp.asarray(x)))
    np.testing.assert_allclose(gate.NormActivation(irreps)(torch.as_tensor(x)).numpy(), want, rtol=0, atol=1e-14)


def test_atomwise_linear_and_its_jvp_match_jax():
    irreps = {"node_features": "2x0e+2x1o"}
    jl = jatom.AtomwiseLinear(out_field="out", irreps_in=irreps, irreps_out="3x0e+1x1o")
    params = jax.tree.map(np.asarray, jl.init(jax.random.PRNGKey(2)))
    r = np.random.RandomState(2)
    x, tx = r.standard_normal((4, 8)), r.standard_normal((4, 8))
    jout, jt = jl.jvp(params, {"node_features": jnp.asarray(x)}, {"node_features": jnp.asarray(tx)})
    pl = AtomwiseLinear(out_field="out", irreps_in=irreps, irreps_out="3x0e+1x1o").double()
    load_jax_params(pl, params)
    out, t = pl.jvp({"node_features": torch.as_tensor(x)}, {"node_features": torch.as_tensor(tx)})
    np.testing.assert_allclose(out["out"].detach().numpy(), np.asarray(jout["out"]), rtol=0, atol=1e-14)
    np.testing.assert_allclose(t["out"].detach().numpy(), np.asarray(jt["out"]), rtol=0, atol=1e-14)
    op = AtomwiseOperation(gate.NormActivation("2x0e+2x1o"), "node_features", irreps_in=irreps)
    jop = jatom.AtomwiseOperation(jgate.NormActivation("2x0e+2x1o"), "node_features", irreps_in=irreps)
    np.testing.assert_allclose(op({"node_features": torch.as_tensor(x)})["node_features"].numpy(),
                               np.asarray(jop({}, {"node_features": jnp.asarray(x)})["node_features"]), atol=1e-14)


def test_concat_save_and_vector_embed_match_jax():
    register_fields(node_fields=["spin_vec"])
    jreg.register_fields(node_fields=["spin_vec"])
    try:
        irreps = {"node_features": "2x0e", "node_attrs": "3x0e", "spin_vec": "1x1e"}
        r = np.random.RandomState(3)
        data = {"node_features": r.standard_normal((4, 2)), "node_attrs": r.standard_normal((4, 3)),
                "spin_vec": r.standard_normal((4, 3))}
        data["spin_vec"][1] = 0.0
        jdata = {k: jnp.asarray(v) for k, v in data.items()}
        tdata = {k: torch.as_tensor(v) for k, v in data.items()}
        for port_mod, jax_mod, key in (
            (Concat(["node_features", "node_attrs"], "cat", irreps_in=irreps),
             jmisc.Concat(["node_features", "node_attrs"], "cat", irreps_in=irreps), "cat"),
            (SaveForOutput("node_attrs", "saved", irreps_in=irreps),
             jmisc.SaveForOutput("node_attrs", "saved", irreps_in=irreps), "saved"),
            (AppendVectorFieldEmbed("spin_vec", lmax=2, axial=True, irreps_in=irreps),
             JAppend("spin_vec", lmax=2, axial=True, irreps_in=irreps), "node_features"),
        ):
            assert port_mod.irreps_out[key] == type(port_mod.irreps_out[key])(str(jax_mod.irreps_out[key]))
            np.testing.assert_allclose(port_mod(tdata)[key].numpy(), np.asarray(jax_mod({}, jdata)[key]), atol=1e-14)
    finally:
        deregister_fields("spin_vec")
        jreg.deregister_fields("spin_vec")
    assert "spin_vec" not in reg._NODE_FIELDS
    with pytest.raises(ValueError, match="built-in"):
        deregister_fields("pos")


def test_data_helpers_match_jax(batches):
    jb, pb = batches
    frame = j_nl(j_from_dict(_frame()), 4.0, backend="kdtree")
    pframe = compute_neighborlist_(from_dict(_frame()), 4.0, backend="kdtree")
    for k, v in jadd.without_nodes(frame, [0, 5, 7]).items():
        np.testing.assert_array_equal(without_nodes(pframe, [0, 5, 7])[k], np.asarray(v), err_msg=k)
    np.testing.assert_allclose(EdgeLengths()(pframe), jmod.EdgeLengths()(frame), rtol=0, atol=1e-14)
    assert MappedFieldModifier("forces", "pos")(pframe) is pframe["pos"]
    r = np.random.RandomState(6)
    src, idx, mask = r.standard_normal((10, 3)), r.randint(0, 4, 10), r.rand(10) > 0.3
    np.testing.assert_allclose(
        scatter.scatter_mean(torch.as_tensor(src), torch.as_tensor(idx), 5, torch.as_tensor(mask)).numpy(),
        np.asarray(jscatter.scatter_mean(jnp.asarray(src), jnp.asarray(idx), 5, jnp.asarray(mask))), atol=1e-14)
    np.testing.assert_array_equal(scatter.masked_gather(torch.as_tensor(src), torch.as_tensor(idx)).numpy(),
                                  np.asarray(jscatter.masked_gather(jnp.asarray(src), jnp.asarray(idx))))
    mat = np.array([[3.0, 3.5], [3.5, 4.0]])
    assert cutoff_matrix_to_dict(mat, ["Cu", "H"]) == jemb_utils.cutoff_matrix_to_dict(mat, ["Cu", "H"])


def test_replace_submodules(jax_runs):
    model = _port("remat_conv", jax_runs)
    n_before = sum(isinstance(m, InteractionBlock) for m in model.modules())
    seen = []
    replace_submodules(model, InteractionBlock, lambda old: seen.append(old) or SaveForOutput(
        "node_features", "kept", irreps_in=old.irreps_in))
    assert len(seen) == n_before == 2 and not any(isinstance(m, InteractionBlock) for m in model.modules())


@pytest.mark.parametrize("reduce", ["sum", "mean", "normalized_sum"])
def test_atomwise_reduce_matches_jax(reduce):
    from nequip_tpu_torch.nn import AtomwiseReduce

    r = np.random.RandomState(8)
    data = {"atomic_energy": r.standard_normal((7, 1)), "batch": np.array([0, 0, 0, 1, 1, 1, 1]),
            "num_atoms": np.array([3, 2, 0]), "node_mask": np.array([1, 1, 1, 1, 1, 0, 0], bool)}
    kw = dict(field="atomic_energy", reduce=reduce, avg_num_atoms=2.5 if reduce == "normalized_sum" else None,
              irreps_in={"atomic_energy": "1x0e"})
    want = jatom.AtomwiseReduce(**kw)({}, {k: jnp.asarray(v) for k, v in data.items()})
    got = AtomwiseReduce(**kw)({k: torch.as_tensor(v) for k, v in data.items()})
    key = "sum_atomic_energy" if reduce != "mean" else "mean_atomic_energy"
    np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-14)
