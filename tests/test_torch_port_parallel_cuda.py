"""The port's sharded-graph path on one card (marked ``cuda``; skips elsewhere).

Two gloo ranks on ``cuda:0`` (spawned processes; gloo by name, since NCCL
refuses two ranks on one card) run sharded ``evaluate`` of the float64
model, which takes the registered ops (K1, K2's inference variant, K3),
and rr ``loss_and_grad``, which takes the autograd Functions (K1, K2's
training variant, the dW reduction, K3, K4, K5), against the same model
on one device: E rel 1e-10, F 1e-8 of max |F|, loss rel 1e-10, gradients
1e-8 of their max.  ``init_distributed`` with NCCL and two ranks on one
card raises on both ranks, naming ``backend="gloo"``.  No JAX: the GPU
machine has none.
"""

import numpy as np
import pytest
import torch

from torch_port_parallel_ranks import cuda_sharded, nccl_refusal, run_ranks


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
def test_sharded_routes_on_one_card_match_one_device(cuda, tmp_path):
    ranks = run_ranks(cuda_sharded, 2, tmp_path, device="cuda:0", backend="gloo", threads=4, deadline_s=600)
    for res in ranks:
        energy, forces = res["evaluate"]
        assert energy == pytest.approx(res["ref_energy"], rel=1e-10)
        np.testing.assert_allclose(forces, res["ref_forces"], rtol=0, atol=1e-8 * np.abs(res["ref_forces"]).max())
        assert res["loss"] == pytest.approx(res["ref_loss"], rel=1e-10)
        assert set(res["grads"]) == set(res["ref_grads"])
        for k, g in res["grads"].items():
            want = res["ref_grads"][k]
            np.testing.assert_allclose(g, want, rtol=0, atol=1e-8 * np.abs(want).max(), err_msg=k)
        assert {"conv_fwd", "conv_bwd", "scatter_rows"} <= set(res["evaluate_launches"])
        assert "conv_bwd_train" not in res["evaluate_launches"]
        assert {"conv_fwd", "conv_bwd_train", "dw_reduce", "scatter_rows"} <= set(res["loss_launches"])


@pytest.mark.cuda
def test_nccl_refuses_two_ranks_on_one_card(cuda, tmp_path):
    errors = run_ranks(nccl_refusal, 2, tmp_path, tmp_path, init=False, deadline_s=300)
    assert all('backend="gloo"' in e or "backend='gloo'" in e for e in errors), errors
