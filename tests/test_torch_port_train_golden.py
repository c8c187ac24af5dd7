"""The training golden file that ``chip_smoke.py`` holds the GPU run against.

``test_train_golden_file_is_fresh`` rewrites the data with the JAX package
and requires the stored file to be unchanged.  ``test_port_matches_train_golden``
runs the golden-training check of the GPU smoke run on the CPU (the kernels'
plain twins): the port's rr loss of the flagship (rel 1e-10) and every
parameter gradient (1e-8 of its tensor's max |grad|), float64.
"""

import numpy as np
import pytest
import torch
from test_torch_port_golden import _params
from torch_port_golden import GOLDEN
from torch_port_train_golden import TRAIN_GOLDEN, make_train_golden

from nequip_tpu_torch.data import batched_from_list, compute_neighborlist_, from_dict, pad_batch, round_up, to_tensors
from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper
from nequip_tpu_torch.model import NequIPGNNModel, jax_named_grads, load_jax_params
from nequip_tpu_torch.train import EnergyForceLoss, NequIPTrainModule

EXACT = ("pos", "cell", "pbc", "atomic_numbers")


def test_train_golden_file_is_fresh():
    stored = np.load(TRAIN_GOLDEN)
    fresh = make_train_golden()
    assert sorted(stored.files) == sorted(fresh)
    for k, v in fresh.items():
        if k in EXACT:
            np.testing.assert_array_equal(stored[k], v, err_msg=k)
        else:
            # recomputed values: float64 on the CPU, reduction order only
            np.testing.assert_allclose(stored[k], v, rtol=1e-12, atol=1e-14, err_msg=k)


@pytest.mark.parametrize("tp_impl", ["torch", "fused"])
def test_port_matches_train_golden(tp_impl):
    z, params = np.load(TRAIN_GOLDEN), _params(np.load(GOLDEN))
    model = NequIPGNNModel(
        seed=0, model_dtype="float64", type_names=["Cu"], r_max=4.0, num_layers=3, l_max=2,
        parity=False, num_features=32, avg_num_neighbors=18.0,
        per_type_energy_shifts={"Cu": -3.5}, per_type_energy_scales={"Cu": 0.5}, tp_impl=tp_impl,
    )
    load_jax_params(model, params)
    frame = {k: z[k] for k in EXACT + ("total_energy", "forces")}
    data = compute_neighborlist_(ChemicalSpeciesToAtomTypeMapper(["Cu"])(from_dict(frame)), 4.0)
    n_edges = data["edge_index"].shape[1]
    batch = to_tensors(pad_batch(batched_from_list([data]), 128, round_up(n_edges, 256), 2))
    module = NequIPTrainModule(model, loss=EnergyForceLoss(type_names=["Cu"]), device="cpu")
    loss, _, _ = module.compute_loss(batch)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(z["loss"]), rel=1e-10)
    got = jax_named_grads(model)
    assert set(got) == {k for k, _ in module.named_trainable()}
    for k, g in got.items():
        want = z[f"grads/{k}"]
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-8 * float(np.abs(want).max()), err_msg=k)
    assert torch.isfinite(loss)
