"""The port's CUDA kernels on the card (marked ``cuda``; they skip elsewhere).

The GPU machine has no JAX, and ``tests/conftest.py`` imports it, so run
these without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -m cuda

Each kernel is held against its plain PyTorch twin on the same CUDA
tensors: f32 rtol 1e-4 with atol 1e-5 max|ref|, f64 rtol/atol 1e-10
(sums in another order).  The whole model with ``tp_impl="fused"`` is held
against ``tp_impl="torch"`` on the card in f64 (energy rel 1e-10, forces
and stress 1e-9).
"""

import numpy as np
import pytest
import torch

from nequip_tpu_torch.data import (
    _keys, batched_from_list, compute_neighborlist_, from_dict, pad_batch, round_up, to_tensors,
)
from nequip_tpu_torch.ops.irreps import Irreps
from nequip_tpu_torch.ops.kernels import tp_scatter as K
from nequip_tpu_torch.ops.mlp import ScalarMLP
from nequip_tpu_torch.ops.tensor_product import TensorProduct, uvu_instructions

N_NODES, N_REAL, N_SLOTS = 128, 300, 512


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _tol(dtype, ref):
    scale = float(ref.abs().max())
    return (1e-4, 1e-5 * scale) if dtype == torch.float32 else (1e-10, 1e-10 * scale)


def _problem(device, dtype):
    r = np.random.RandomState(0)
    feats, sh = "8x0e+8x1o+8x2e", "1x0e+1x1o+1x2e"
    mid, ins = uvu_instructions(Irreps(feats), Irreps(sh), Irreps(feats) + Irreps("8x1e+8x2o"))
    plan = K.TPPlan(TensorProduct(feats, sh, mid, ins))
    mlp = ScalarMLP(8, plan.weight_numel, hidden_layers_depth=1, hidden_layers_width=16)
    ei = np.stack([r.randint(0, 100, N_SLOTS), r.randint(0, 100, N_SLOTS)])
    data = K.relayout_edge_stream({
        _keys.POSITIONS_KEY: torch.zeros(N_NODES, 3, device=device),
        _keys.EDGE_INDEX_KEY: torch.as_tensor(ei, device=device),
        _keys.EDGE_MASK_KEY: torch.as_tensor(r.rand(N_SLOTS) < N_REAL / N_SLOTS, device=device),
    })
    t = lambda *shape: torch.as_tensor(r.standard_normal(shape), dtype=dtype, device=device)
    args = (plan, t(N_NODES, plan.dim_in), t(N_SLOTS, plan.sh_dim), t(N_SLOTS, 8), t(8, 16),
            t(16, plan.weight_numel), *mlp.alphas, data[K.LAYOUT_KEY])
    return args, t(N_NODES, plan.mid_dim), t(N_SLOTS, 24)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["conv_fwd", "conv_bwd", "scatter_rows"])
def test_cuda_kernel_matches_plain(cuda, name, dtype):
    args, g, v = _problem(cuda, dtype)
    lay = args[-1]
    before = K.KERNELS[name].launches
    if name == "conv_fwd":
        got, want = K.conv_fwd(*args), K.conv_fwd_plain(*args)
    elif name == "conv_bwd":
        got, want = K.conv_bwd(*args, g), K.conv_bwd_plain(*args, g)
    else:
        got, want = K.scatter_rows(v, lay.src_perm, lay.src_ptr), K.scatter_rows_plain(v, lay.src_perm, lay.src_ptr)
    torch.cuda.synchronize()
    assert K.KERNELS[name].launches == before + 1
    for a, b in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        rtol, atol = _tol(dtype, b)
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_cuda_fused_model_matches_torch_model(cuda):
    from nequip_tpu_torch.model import NequIPGNNModel

    cfg = dict(seed=0, model_dtype="float64", type_names=["Cu"], r_max=4.0, num_layers=3, l_max=2,
               parity=False, num_features=8, radial_mlp_width=16, avg_num_neighbors=18.0)
    r = np.random.RandomState(0)
    a = 3.61
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]) * a
    pos = np.concatenate([base + np.array([i, j, k]) * a for i in range(3) for j in range(3) for k in range(3)])
    frame = compute_neighborlist_(from_dict({
        "pos": pos + r.normal(0, 0.1, pos.shape), "cell": np.diag([3 * a] * 3),
        "pbc": np.array([True] * 3), "atom_types": np.zeros(len(pos), dtype=int),
    }), 4.0)
    n_edges = frame[_keys.EDGE_INDEX_KEY].shape[1]
    batch = to_tensors(pad_batch(batched_from_list([frame]), 128, round_up(n_edges, 256), 2), cuda)
    outs = []
    for impl in ("torch", "fused"):
        model = NequIPGNNModel(tp_impl=impl, **cfg).to(cuda).requires_grad_(False)
        outs.append(model(batch))
    ref, got = outs
    torch.testing.assert_close(got[_keys.TOTAL_ENERGY_KEY], ref[_keys.TOTAL_ENERGY_KEY], rtol=1e-10, atol=0)
    for k in (_keys.FORCE_KEY, _keys.STRESS_KEY):
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=1e-9)
