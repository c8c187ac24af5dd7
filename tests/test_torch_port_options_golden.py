"""The options golden file that ``chip_smoke.py`` (phase 14a) holds the card
against: ``test_options_golden_file_is_fresh`` rewrites it with the JAX
package and requires the stored file to be unchanged; the port check runs
phase 14a's comparison on the CPU (the kernels' plain twins, each model's
config retargeted at ``tp_impl="fused"``), at phase 3's tolerances: E rel
1e-10, F and stress 1e-8, with the route of every layer (K1 for the
depth-1 radial MLPs, K4 for the depth-2 one).
"""

import json

import numpy as np
import pytest
import torch

from torch_port_options_golden import GOLDEN, MODELS, make_golden

from nequip_tpu_torch.data import batched_from_list, compute_neighborlist_, from_dict, pad_batch, to_tensors
from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper
from nequip_tpu_torch.model import load_jax_params
from nequip_tpu_torch.nn.interaction_block import InteractionBlock
from nequip_tpu_torch.utils.config import instantiate, retarget

FRAME = ("pos", "cell", "pbc", "atomic_numbers", "charge")
ROUTES = {"options": "fused", "depth2": "fused_tp", "preset_m": "fused"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many tiny ops: one intra-op thread keeps them fast beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_options_golden_file_is_fresh():
    stored = np.load(GOLDEN)
    fresh = make_golden()
    assert sorted(stored.files) == sorted(fresh)
    for k, v in fresh.items():
        if k.endswith(("/energy", "/forces", "/stress")):
            # recomputed outputs: float64 XLA on the CPU, reduction order only
            np.testing.assert_allclose(stored[k], v, rtol=1e-12, atol=1e-14, err_msg=k)
        else:
            np.testing.assert_array_equal(stored[k], v, err_msg=k)


@pytest.mark.parametrize("name", list(MODELS))
def test_port_matches_options_golden(name):
    z = np.load(GOLDEN)
    cfg = dict(retarget(json.loads(str(z[f"{name}/config"]))), tp_impl="fused")
    model = instantiate(cfg, _recursive_=False)
    prefix = f"{name}/params/"
    load_jax_params(model, {k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)})
    assert {b.route for b in model.modules() if isinstance(b, InteractionBlock)} == {ROUTES[name]}
    frame = compute_neighborlist_(ChemicalSpeciesToAtomTypeMapper(["Cu"])(from_dict({k: z[k] for k in FRAME})), 4.0)
    n_edges = frame["edge_index"].shape[1]
    out = model.requires_grad_(False)(to_tensors(pad_batch(batched_from_list([frame]), 128, n_edges, 1)))
    assert float(out["total_energy"][0, 0]) == pytest.approx(float(z[f"{name}/energy"]), rel=1e-10)
    np.testing.assert_allclose(out["forces"][:108].numpy(), z[f"{name}/forces"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(out["stress"][0].numpy(), z[f"{name}/stress"], rtol=0, atol=1e-8)
