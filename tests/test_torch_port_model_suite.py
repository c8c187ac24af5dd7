"""The port's shipped model suite (``nequip_tpu_torch.utils.unittests``),
run as a downstream package runs it, on the CPU (the kernels' plain twins).

The configs are those of ``tests/unit/model/test_shipped_suite.py``,
retargeted to the port at ``tp_impl="fused"`` (K1's route), one that turns
on the norm nonlinearity, a categorical graph-field embedding,
``learnable_shift`` and every trainable leaf together (at ``tp_impl=
"fused_tp"``, K4's route), and the ZBL pair-potential model.
"""

import pytest
import torch

import numpy as np

from nequip_tpu_torch.data import _keys
from nequip_tpu_torch.utils.config import retarget
from nequip_tpu_torch.utils.unittests import BaseEnergyModelTests

SHIPPED = dict(_target_="nequip_tpu.model.NequIPGNNModel", seed=17, model_dtype="float64", type_names=["Cu", "H"],
               r_max=4.0, num_layers=2, l_max=1, parity=True, num_features=4, radial_mlp_width=8,
               avg_num_neighbors=12.0, per_type_energy_shifts={"Cu": -3.0, "H": -1.0}, tp_impl="pallas_fused")
# the frames' total charge, a built-in integer graph field, is the categorical embedding's label
CHARGE_EMBED = [{"field": _keys.TOTAL_CHARGE_KEY, "min": -1, "max": 1, "num_features": 2}]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many tiny ops: one intra-op thread keeps them fast beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TestNequIPGNN(BaseEnergyModelTests):
    @pytest.fixture(
        scope="class",
        params=[
            retarget(SHIPPED),
            retarget(dict(SHIPPED, seed=18, num_layers=1, l_max=2, parity=False)),
        ],
        ids=["l1_parity", "l2_noparity"],
    )
    def model_config(self, request):
        return request.param


class TestNequIPGNNOptions(BaseEnergyModelTests):
    """Norm nonlinearity, a categorical embedding of the frame's charge,
    learnable shift and trainable leaves together."""

    @pytest.fixture(scope="class")
    def frame_fields(self):
        return {_keys.TOTAL_CHARGE_KEY: np.array([1])}

    @pytest.fixture(scope="class")
    def model_config(self):
        return retarget(dict(SHIPPED, tp_impl="pallas", convnet_nonlinearity_type="norm", learnable_shift=True,
                             categorical_graph_field_embed=CHARGE_EMBED, bessel_trainable=True,
                             per_type_energy_scales={"Cu": 0.8, "H": 1.1}, per_type_energy_scales_trainable=True,
                             per_type_energy_shifts_trainable=True))


class TestZBLModel(BaseEnergyModelTests):
    @pytest.fixture(scope="class")
    def model_config(self):
        return dict(_target_="nequip_tpu_torch.model.ZBLPairPotential", seed=3, model_dtype="float64",
                    type_names=["Cu", "H"], chemical_species=["Cu", "H"], units="metal", r_max=4.0)
