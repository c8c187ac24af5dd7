"""The port's e3nn import/export against the JAX package.

``nequip_tpu_torch/model/e3nn_import.py`` re-lays reference (e3nn)
state-dict weights into a port model.  Held here, in float64 on the CPU:

* the JAX package's ``export_to_e3nn_npz`` of a JAX model, imported by the
  port into a port model of the same config (other random weights), gives
  the JAX model's energy and forces at 1e-10 relative;
* the port's export of the same parameters equals the JAX export key for
  key, bitwise (dtype included);
* the round trip, the wrapper-prefix stripping, the missing-key and the
  shape-drift errors of ``tests/unit/model/test_e3nn_import.py``;
* ``tests/unit/model/test_e3nn_layout_golden.py``'s hand-built layout
  goldens (flat ``o3.Linear``, the conv ``uvu`` weight vector, the
  self-connection's flat blocks, the radial MLP's transposes and alphas),
  on the port's modules.
"""

import jax
import numpy as np
import pytest
import torch

from nequip_tpu.data import _keys as jkeys
from nequip_tpu.data import batched_from_list as j_batched
from nequip_tpu.data import compute_neighborlist_ as j_nl
from nequip_tpu.data import from_dict as j_from_dict
from nequip_tpu.data import pad_batch as j_pad
from nequip_tpu.data import to_device
from nequip_tpu.model import NequIPGNNModel as JModel
from nequip_tpu.model.e3nn_import import export_to_e3nn_npz as j_export

from nequip_tpu_torch.data import batched_from_list, compute_neighborlist_, from_dict, pad_batch, to_tensors
from nequip_tpu_torch.model import NequIPGNNModel, jax_params_tree, load_jax_params
from nequip_tpu_torch.model.e3nn_import import _split_linear, export_to_e3nn_npz, import_e3nn_npz
from nequip_tpu_torch.ops import Irreps, Linear, TensorProduct, fully_connected_tensor_product, uvu_instructions
from nequip_tpu_torch.ops.cg import cg_component_normalized
from nequip_tpu_torch.ops.mlp import ScalarMLP

# tests/unit/model/test_e3nn_import.py's model
CONFIG = dict(
    model_dtype="float64", type_names=["Cu", "H"], r_max=4.0, num_layers=2, l_max=2, parity=True,
    num_features=4, radial_mlp_width=8, avg_num_neighbors=10.0,
    per_type_energy_shifts={"Cu": -3.0, "H": -1.0}, per_type_energy_scales={"Cu": 0.5, "H": 0.7},
    bessel_trainable=True,
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_model():
    model = JModel(seed=42, tp_impl="xla", **CONFIG)
    return model, jax.tree.map(np.asarray, model.init_params())


def _frame():
    rng = np.random.RandomState(0)
    return {
        "pos": rng.uniform(0, 6.0, (12, 3)), "cell": np.diag([6.0] * 3), "pbc": np.array([True] * 3),
        "atom_types": rng.randint(0, 2, 12),
    }


def _jax_probe(model, params):
    f = j_nl(j_from_dict(_frame()), 4.0, backend="kdtree")
    out = jax.jit(model)(params, to_device(j_pad(j_batched([f]), 16, 512, 2)))
    return np.asarray(out[jkeys.TOTAL_ENERGY_KEY][0, 0]), np.asarray(out[jkeys.FORCE_KEY][:12])


def _port_probe(model):
    f = compute_neighborlist_(from_dict(_frame()), 4.0, backend="kdtree")
    out = model(to_tensors(pad_batch(batched_from_list([f]), 16, 512, 2)))
    return out["total_energy"][0, 0].detach().numpy(), out["forces"][:12].detach().numpy()


def _port_model(tp_impl="fused", seed=7):
    return NequIPGNNModel(seed=seed, tp_impl=tp_impl, **CONFIG)


@pytest.mark.parametrize("tp_impl", ["torch", "fused"])
def test_import_of_the_jax_export_gives_the_jax_model(jax_model, tmp_path, tp_impl):
    jmodel, params = jax_model
    npz = str(tmp_path / "ref_weights.npz")
    j_export(jmodel, params, npz)
    port = _port_model(tp_impl)
    assert import_e3nn_npz(npz, port) is port
    e_want, f_want = _jax_probe(jmodel, params)
    e_got, f_got = _port_probe(port)
    np.testing.assert_allclose(e_got, e_want, rtol=1e-10, atol=0)
    np.testing.assert_allclose(f_got, f_want, rtol=1e-10, atol=1e-10 * np.abs(f_want).max())


def test_export_equals_the_jax_export_bitwise(jax_model):
    jmodel, params = jax_model
    want = j_export(jmodel, params)
    port = load_jax_params(_port_model(), params)
    got = export_to_e3nn_npz(port)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_roundtrip_exact(tmp_path):
    model = _port_model(seed=42)
    npz = str(tmp_path / "ref_weights.npz")
    exported = export_to_e3nn_npz(model, npz)
    assert exported["layer0_convnet.conv.linear_1.weight"].ndim == 1  # e3nn flat
    for key in ("per_type_energy_scale_shift.shifts", "type_embed.embed_module.weight",
                "bessel_encode.bessel_weights"):
        assert key in exported
    assert any(k.startswith("per_atom_energy_readout.mlp.") for k in exported)
    fresh = import_e3nn_npz(npz, _port_model(seed=3))
    want, got = jax_params_tree(model), jax_params_tree(fresh)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                jax.tree_util.tree_flatten_with_path(want)[0]):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_port_probe(fresh), _port_probe(model)):
        np.testing.assert_array_equal(a, b)


def test_wrapper_prefix_stripping():
    """state dicts of the wrapped torch GraphModel carry a 'model.func.' prefix."""
    model = _port_model(seed=42)
    prefixed = {f"model.func.{k}": v for k, v in export_to_e3nn_npz(model).items()}
    fresh = import_e3nn_npz(prefixed, _port_model(seed=3))
    for a, b in zip(jax.tree.leaves(jax_params_tree(fresh)), jax.tree.leaves(jax_params_tree(model))):
        np.testing.assert_array_equal(a, b)


def test_missing_key_error_is_actionable():
    exported = export_to_e3nn_npz(_port_model())
    exported.pop("layer0_convnet.conv.linear_1.weight")
    with pytest.raises(KeyError, match="architecture"):
        import_e3nn_npz(exported, _port_model())


def test_shape_drift_fails_loudly():
    exported = export_to_e3nn_npz(_port_model())
    w = exported["layer0_convnet.conv.linear_1.weight"]
    exported["layer0_convnet.conv.linear_1.weight"] = np.concatenate([w, w])
    with pytest.raises(ValueError, match="numel mismatch"):
        import_e3nn_npz(exported, _port_model())


# ---------------------------------------------------------------------------
# hand-built layout goldens (tests/unit/model/test_e3nn_layout_golden.py)
# ---------------------------------------------------------------------------
def _linear(irreps_in, irreps_out, flat):
    lin = Linear(irreps_in, irreps_out).double()
    with torch.no_grad():
        for k, v in _split_linear(flat, lin).items():
            getattr(lin, k).copy_(torch.as_tensor(v))
    return lin


def test_linear_flat_layout_and_element_alphas():
    """Two scalar input chunks feeding one output chunk: the flat vector is
    [W00 (2x4 row-major), W10 (3x4)], both paths scaled by 1/sqrt(2+3)."""
    assert Linear("2x0e+3x0e", "4x0e").instructions == [(0, 0), (1, 0)]
    rng = np.random.RandomState(0)
    W00, W10 = rng.standard_normal((2, 4)), rng.standard_normal((3, 4))
    x = rng.standard_normal((5, 5))
    expected = (x[:, :2] @ W00 + x[:, 2:] @ W10) / np.sqrt(5.0)
    lin = _linear("2x0e+3x0e", "4x0e", np.concatenate([W00.reshape(-1), W10.reshape(-1)]))
    np.testing.assert_allclose(lin(torch.as_tensor(x)).detach().numpy(), expected, rtol=1e-12)


def test_linear_vector_chunk_no_m_mixing():
    """1e -> 1e: W is (mul_in, mul_out), applied identically per m component
    (ir_mul layout: the chunk reshapes to (2l+1, mul))."""
    rng = np.random.RandomState(1)
    W = rng.standard_normal((2, 3))
    x = rng.standard_normal((4, 6))
    expected = (x.reshape(4, 3, 2) @ W / np.sqrt(2.0)).reshape(4, 9)
    lin = _linear("2x1e", "3x1e", W.reshape(-1))
    np.testing.assert_allclose(lin(torch.as_tensor(x)).detach().numpy(), expected, rtol=1e-12)


def test_uvu_tp_weight_vector_layout():
    """The conv TP takes per-edge weights as per-instruction (mul1, mul2)
    blocks in instruction order, instructions input-major, one output
    chunk per path (path_weight 1), output chunks sorted by (l, p)."""
    feats = Irreps("2x0e+2x1o")
    sh = Irreps.spherical_harmonics(1)
    mid, ins = uvu_instructions(feats, sh, feats)
    tp = TensorProduct(feats, sh, mid, ins, shared_weights=False)
    assert [(i.i_in1, i.i_in2) for i in tp.instructions] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [(mid[i.i_out].ir.l, mid[i.i_out].ir.p) for i in tp.instructions] == [(0, 1), (1, -1), (1, -1), (0, 1)]
    assert tp.weight_numel == 4 * 2

    rng = np.random.RandomState(2)
    E = 7
    x1, x2 = rng.standard_normal((E, feats.dim)), rng.standard_normal((E, sh.dim))
    w = rng.standard_normal((E, tp.weight_numel))
    sl1, sl2, sl3 = feats.slices(), sh.slices(), mid.slices()
    expected = np.zeros((E, mid.dim))
    for p_idx, i in enumerate(tp.instructions):
        mi1, mi2, mi3 = feats[i.i_in1], sh[i.i_in2], mid[i.i_out]
        cg = np.asarray(cg_component_normalized(mi1.ir.l, mi2.ir.l, mi3.ir.l))
        c1 = x1[:, sl1[i.i_in1]].reshape(E, mi1.ir.dim, mi1.mul)
        c2 = x2[:, sl2[i.i_in2]].reshape(E, mi2.ir.dim)
        out = np.einsum("ijk,eiu,ej,eu->eku", cg, c1, c2, w[:, 2 * p_idx: 2 * p_idx + 2])
        assert abs(i.path_weight - 1.0) < 1e-12
        expected[:, sl3[i.i_out]] += out.reshape(E, mi3.dim)
    got = tp(torch.as_tensor(x1), torch.as_tensor(x2), torch.as_tensor(w))
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-10, atol=1e-12)


def test_fully_connected_tp_flat_layout():
    """Self-connection weights: flat per-path (mul1, mul2, mul_out) blocks in
    (in1, in2, out) triple-loop order, element fan mul1*mul2 per output."""
    fc = fully_connected_tensor_product("2x0e+1x1e", "3x0e", "2x0e+2x1e")
    assert fc.weight_numel == 12 + 6
    rng = np.random.RandomState(3)
    N = 4
    x1, x2 = rng.standard_normal((N, 5)), rng.standard_normal((N, 3))
    flat = rng.standard_normal(fc.weight_numel)
    W0, W1 = flat[:12].reshape(2, 3, 2), flat[12:].reshape(1, 3, 2)
    cg000 = float(np.asarray(cg_component_normalized(0, 0, 0))[0, 0, 0])
    cg101 = np.asarray(cg_component_normalized(1, 0, 1))
    expected = np.zeros((N, 8))
    expected[:, 0:2] = cg000 * np.einsum("eu,ev,uvw->ew", x1[:, :2], x2, W0) / np.sqrt(6.0)
    c1, c2 = x1[:, 2:5].reshape(N, 3, 1), x2.reshape(N, 1, 3)
    expected[:, 2:8] = (np.einsum("ijk,eiu,ejv,uvw->ekw", cg101, c1, c2, W1) / np.sqrt(3.0)).reshape(N, 6)
    got = fc(torch.as_tensor(x1), torch.as_tensor(x2), torch.as_tensor(flat))
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-10, atol=1e-12)


def test_scalar_mlp_torch_transpose_and_alphas():
    """torch nn.Linear stores (out, in); the import transposes to (in, out);
    run-time alphas gain/sqrt(fan_in) on both sides."""
    mlp = ScalarMLP(4, 3, hidden_layers_depth=1, hidden_layers_width=6, bias=False, nonlinearity="silu").double()
    assert mlp.dims == [4, 6, 3]
    rng = np.random.RandomState(4)
    Wt0, Wt1 = rng.standard_normal((6, 4)), rng.standard_normal((3, 6))
    x = rng.standard_normal((5, 4))
    a0, a1 = mlp.alphas
    np.testing.assert_allclose(a0, 1.0 / np.sqrt(4.0), rtol=1e-12)
    h = (x @ Wt0.T) * a0
    expected = ((h / (1.0 + np.exp(-h))) @ Wt1.T) * a1
    with torch.no_grad():
        mlp.w0.copy_(torch.as_tensor(Wt0.T))
        mlp.w1.copy_(torch.as_tensor(Wt1.T))
    np.testing.assert_allclose(mlp(torch.as_tensor(x)).detach().numpy(), expected, rtol=1e-10)
