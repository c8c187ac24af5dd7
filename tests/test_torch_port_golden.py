"""The golden file that ``chip_smoke.py`` holds the GPU run against.

``test_golden_file_is_fresh`` rewrites the golden data with the JAX package
and requires the stored file to be unchanged, so it cannot go stale.
``test_port_matches_golden`` runs the same check as the GPU smoke run's
phase 3 on the CPU (plain kernel twins), at the same tolerances: energy
rel 1e-10, forces and stress atol 1e-8 (float64 sums in another order,
over 3 layers of a 32-wide model).
"""

import numpy as np
import pytest

from torch_port_golden import GOLDEN, make_golden

from nequip_tpu_torch.integrations import NequIPCalculator
from nequip_tpu_torch.model import NequIPGNNModel, load_jax_params

EXACT = ("pos", "cell", "pbc", "atomic_numbers")


def _params(z):
    """The stored parameter tree, flat by dotted path."""
    return {k[len("params/"):]: z[k] for k in z.files if k.startswith("params/")}


def test_golden_file_is_fresh():
    stored = np.load(GOLDEN)
    fresh = make_golden()
    assert sorted(stored.files) == sorted(fresh)
    for k, v in fresh.items():
        if k.startswith("params/") or k in EXACT:
            np.testing.assert_array_equal(stored[k], v, err_msg=k)
        else:
            # recomputed outputs: float64 XLA on the CPU, reduction order only
            np.testing.assert_allclose(stored[k], v, rtol=1e-12, atol=1e-14, err_msg=k)


@pytest.mark.parametrize("tp_impl", ["torch", "fused"])
def test_port_matches_golden(tp_impl):
    z = np.load(GOLDEN)
    model = NequIPGNNModel(
        seed=0, model_dtype="float64", type_names=["Cu"], r_max=4.0, num_layers=3, l_max=2,
        parity=False, num_features=32, avg_num_neighbors=18.0,
        per_type_energy_shifts={"Cu": -3.5}, per_type_energy_scales={"Cu": 0.5}, tp_impl=tp_impl,
    )
    load_jax_params(model, _params(z))
    calc = NequIPCalculator.from_model(model, device="cpu")
    res = calc.calculate({k: z[k] for k in EXACT})
    assert res["energy"] == pytest.approx(float(z["energy"]), rel=1e-10)
    np.testing.assert_allclose(res["forces"], z["forces"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(res["stress"], z["stress"], rtol=0, atol=1e-8)
