"""The whole energy+forces+stress slice of the port against the JAX package.

A flagship-shaped model at small width (3 layers, l_max=2, 8 features,
radial MLP width 16) with the JAX package's parameters loaded through
``load_jax_params``, on a 108-atom jittered fcc Cu frame padded to 128
nodes; and a two-species variant that takes the builder's other paths
(parity, resnet, per-type shifts/scales/neighbour norms, per-edge-type
cutoffs).  float64 on the CPU; the port's ``fused`` path runs the kernels'
plain twins through the same autograd Function as on the card.
Tolerances: energy rel 1e-10, forces and stress atol 1e-9 (float64 sums in
another order through 3 layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nequip_tpu.data import _keys as jkeys
from nequip_tpu.data import batched_from_list as j_batched
from nequip_tpu.data import compute_neighborlist_ as j_nl
from nequip_tpu.data import from_dict as j_from_dict
from nequip_tpu.data import pad_batch as j_pad
from nequip_tpu.data import to_device
from nequip_tpu.integrations.calculator import NequIPCalculator as JCalculator
from nequip_tpu.model import NequIPGNNModel as JModel

from nequip_tpu_torch.data import batched_from_list, compute_neighborlist_, from_dict, pad_batch, to_tensors
from nequip_tpu_torch.integrations import NequIPCalculator
from nequip_tpu_torch.model import NequIPGNNModel, load_jax_params

CONFIG = dict(
    seed=0, model_dtype="float64", type_names=["Cu"], r_max=4.0, num_layers=3, l_max=2,
    parity=False, num_features=8, radial_mlp_width=16, avg_num_neighbors=18.0,
    per_type_energy_shifts={"Cu": -3.5}, per_type_energy_scales={"Cu": 0.5},
)
TWO_SPECIES = dict(
    CONFIG, type_names=["Cu", "Au"], num_layers=2, l_max=1, parity=True, convnet_resnet=True,
    avg_num_neighbors={"Cu": 16.0, "Au": 20.0},
    per_type_energy_shifts={"Cu": -3.5, "Au": -3.8}, per_type_energy_scales={"Cu": 0.5, "Au": 0.7},
    per_edge_type_cutoff={"Cu": 3.6, "Au": {"Cu": 3.8, "Au": 4.0}},
)
CONFIGS = {"flagship": CONFIG, "two_species": TWO_SPECIES}
OUTPUTS = (jkeys.TOTAL_ENERGY_KEY, jkeys.FORCE_KEY, jkeys.STRESS_KEY, jkeys.PER_ATOM_ENERGY_KEY)


def _frame(seed=0, n_types=1):
    r = np.random.RandomState(seed)
    a = 3.61
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]) * a
    pos = np.concatenate([base + np.array([i, j, k]) * a for i in range(3) for j in range(3) for k in range(3)])
    types = r.randint(0, n_types, len(pos))
    return {
        "pos": pos + r.normal(0, 0.1, pos.shape),
        "cell": np.diag([3 * a] * 3),
        "pbc": np.array([True] * 3),
        "atomic_numbers": np.array([29, 79])[types],
        "atom_types": types,
    }


def _padded(frame, nl, batched, pad, mod):
    data = nl(mod(dict(frame)), 4.0)
    n_edges = data["edge_index"].shape[1]
    return pad(batched([data]), 128, ((n_edges + 255) // 256) * 256, 2)


def _jax_outputs(config, n_types):
    """JAX params + outputs of the xla and pallas_fused models on one frame."""
    frame = _frame(n_types=n_types)
    batch = _padded(frame, lambda d, r: j_nl(d, r, backend="kdtree"), j_batched, j_pad, j_from_dict)
    out = {}
    params = None
    for impl in ("xla", "pallas_fused"):
        model = JModel(tp_impl=impl, **config)
        params = model.init_params() if params is None else params
        res = jax.jit(model)(params, to_device(batch))
        out[impl] = {k: np.asarray(res[k]) for k in OUTPUTS}
    return jax.tree.map(np.asarray, params), frame, out


@pytest.fixture(scope="module")
def jax_reference():
    return _jax_outputs(CONFIG, n_types=1)


@pytest.fixture(scope="module")
def jax_two_species():
    return _jax_outputs(TWO_SPECIES, n_types=2)


def _port_model(tp_impl, params, config=CONFIG):
    model = NequIPGNNModel(tp_impl=tp_impl, **config)
    load_jax_params(model, params)
    return model.requires_grad_(False)


def _check(got, want):
    e, we = got[jkeys.TOTAL_ENERGY_KEY][0, 0], want[jkeys.TOTAL_ENERGY_KEY][0, 0]
    assert e == pytest.approx(we, rel=1e-10)
    for k in (jkeys.FORCE_KEY, jkeys.STRESS_KEY):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("jax_impl", ["xla", "pallas_fused"])
@pytest.mark.parametrize("tp_impl", ["torch", "fused", "fused_tp"])
def test_model_matches_jax(request, config, tp_impl, jax_impl):
    fixture = {"flagship": "jax_reference", "two_species": "jax_two_species"}[config]
    params, frame, want = request.getfixturevalue(fixture)
    batch = _padded(frame, compute_neighborlist_, batched_from_list, pad_batch, from_dict)
    out = _port_model(tp_impl, params, CONFIGS[config])(to_tensors(batch))
    _check({k: out[k].numpy() for k in OUTPUTS}, want[jax_impl])
    # padded nodes carry no force and the padded frame no energy
    assert not out[jkeys.FORCE_KEY][108:].any() and out[jkeys.TOTAL_ENERGY_KEY][1, 0] == 0


@pytest.mark.parametrize("tp_impl", ["torch", "fused"])
def test_calculator_matches_jax_calculator(jax_reference, tp_impl):
    params, _, _ = jax_reference
    frame = _frame(seed=3)
    frame.pop("atom_types")
    jmodel = JModel(tp_impl="xla", **CONFIG)
    jparams = jax.tree.map(jnp.asarray, params)
    jfwd = jax.jit(jmodel)
    want = JCalculator(predictor=lambda d: jfwd(jparams, to_device(d)), r_max=4.0, type_names=["Cu"]).calculate(frame)
    got = NequIPCalculator.from_model(_port_model(tp_impl, params), device="cpu").calculate(frame)
    assert got["energy"] == pytest.approx(want["energy"], rel=1e-10)
    for k in ("forces", "stress", "energies", "stress_voigt"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9, err_msg=k)


def test_jax_param_loader_checks_keys_and_shapes(jax_reference):
    params, _, _ = jax_reference
    model = NequIPGNNModel(tp_impl="torch", **CONFIG)
    missing = {k: v for k, v in params.items() if k != "type_embed"}
    with pytest.raises(KeyError, match="type_embed"):
        load_jax_params(model, missing)
    bad = dict(params, type_embed={"type_embed": np.zeros((2, 8))})
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(model, bad)


def test_fused_model_needs_frozen_weights(jax_reference):
    """Frozen weights are no longer needed: with trainable weights the fused
    model gives the frozen model's outputs, differentiable for a force loss."""
    params, frame, _ = jax_reference
    batch = to_tensors(_padded(frame, compute_neighborlist_, batched_from_list, pad_batch, from_dict))
    model = NequIPGNNModel(tp_impl="fused", **CONFIG)
    load_jax_params(model, params)
    out = model(batch)
    frozen = _port_model("fused", params)(batch)
    for k in OUTPUTS:
        torch.testing.assert_close(out[k].detach(), frozen[k], rtol=0, atol=1e-12)
    assert out[jkeys.FORCE_KEY].requires_grad and not frozen[jkeys.FORCE_KEY].requires_grad


def test_metadata_names_the_model():
    model = NequIPGNNModel(tp_impl="fused", **CONFIG)
    md = model.metadata
    assert md["r_max"] == "4.0" and md["type_names"] == "Cu" and md["model_dtype"] == "float64"
    assert model.uses_fused_kernels and NequIPGNNModel(tp_impl="fused_tp", **CONFIG).uses_fused_kernels
    assert not NequIPGNNModel(tp_impl="torch", **CONFIG).uses_fused_kernels
    assert all(p.dtype == torch.float64 for p in model.parameters())
