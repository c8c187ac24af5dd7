"""The fused-convolution kernels (K1, K2, K3) of the port.

On the CPU the wrappers run their plain PyTorch twins; these are held
against the JAX package's Pallas kernels, run in interpret mode exactly as
``tests/unit/ops/test_pallas_tp_scatter.py`` runs them: float64, one TP at
small width (``8x0e+8x1o+8x2e`` x SH(2)), 128 nodes, 300 real edges of 512
slots.  Tolerances: forward 1e-10 and gradients 1e-9, as the JAX kernel
tests hold their kernels against XLA (sums in another order, float64);
the row scatter 1e-12 (one sum per output).

The CUDA kernels themselves are held against these twins on the card in
``tests/test_torch_port_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nequip_tpu.ops import Irreps as JIrreps
from nequip_tpu.ops import TensorProduct as JTP
from nequip_tpu.ops import uvu_instructions as j_uvu
from nequip_tpu.ops.mlp import ScalarMLP as JScalarMLP
from nequip_tpu.ops.pallas.tp_scatter import fused_tp_scatter_mlp as j_fused
from nequip_tpu.ops.pallas.tp_scatter import pallas_scatter_sum

from nequip_tpu_torch.data import _keys
from nequip_tpu_torch.ops.irreps import Irreps
from nequip_tpu_torch.ops.kernels import tp_scatter as K
from nequip_tpu_torch.ops.tensor_product import TensorProduct, uvu_instructions

N_NODES, N_REAL, N_SLOTS, N_EMB, HIDDEN = 128, 300, 512, 8, 16


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _problem(unsorted: bool):
    r = np.random.RandomState(0)
    feats, sh = "8x0e+8x1o+8x2e", "1x0e+1x1o+1x2e"
    target = Irreps(feats) + Irreps("8x1e+8x2o")
    mid, ins = uvu_instructions(Irreps(feats), Irreps(sh), target)
    jmid, jins = j_uvu(JIrreps(feats), JIrreps(sh), JIrreps(str(target)))
    tp, jtp = TensorProduct(feats, sh, mid, ins), JTP(feats, sh, str(jmid), jins)
    dst = np.sort(r.randint(0, 100, N_REAL))
    src = r.randint(0, 100, N_REAL)
    pad = np.full(N_SLOTS - N_REAL, N_NODES - 1)
    edge_index = np.stack([np.concatenate([dst, pad]), np.concatenate([src, pad])])
    mask = np.arange(N_SLOTS) < N_REAL
    if unsorted:
        perm = np.random.RandomState(1).permutation(N_SLOTS)
        edge_index, mask = edge_index[:, perm], mask[perm]
    mlp = JScalarMLP(input_dim=N_EMB, output_dim=tp.weight_numel, hidden_layers_depth=1,
                     hidden_layers_width=HIDDEN, nonlinearity="silu", bias=False)
    mlp_params = jax.tree.map(np.asarray, mlp.init(jax.random.PRNGKey(2)))
    return dict(
        tp=tp, jtp=jtp, mlp=mlp, mlp_params=mlp_params, edge_index=edge_index, mask=mask,
        x=r.standard_normal((N_NODES, tp.irreps_in1.dim)),
        sh=r.standard_normal((N_SLOTS, tp.irreps_in2.dim)),
        emb=r.standard_normal((N_SLOTS, N_EMB)),
    )


def _port_stream(p):
    """The port's kernel-order stream; returns (data, order) with
    data[k] == original[order] for every per-edge field."""
    data = {
        _keys.POSITIONS_KEY: torch.zeros(N_NODES, 3, dtype=torch.float64),
        _keys.EDGE_INDEX_KEY: torch.as_tensor(p["edge_index"], dtype=torch.int64),
        _keys.EDGE_MASK_KEY: torch.as_tensor(p["mask"]),
        _keys.EDGE_ATTRS_KEY: _t(p["sh"]),
        _keys.EDGE_EMBEDDING_KEY: _t(p["emb"]),
    }
    out = K.relayout_edge_stream(data)
    ei = p["edge_index"]
    order = np.argsort(np.where(p["mask"], ei[0], N_NODES), kind="stable")
    np.testing.assert_array_equal(out[_keys.EDGE_INDEX_KEY].numpy(), ei[:, order])
    np.testing.assert_array_equal(out[_keys.EDGE_ATTRS_KEY].numpy(), p["sh"][order])
    return out, order


def _port_call(p, data, x=None):
    plan = K.TPPlan(p["tp"])
    a0, a1 = p["mlp"].alphas
    x = _t(p["x"]) if x is None else x
    return K.fused_tp_scatter_mlp(
        plan, x, data[_keys.EDGE_ATTRS_KEY], data[_keys.EDGE_EMBEDDING_KEY],
        _t(p["mlp_params"]["w0"]), _t(p["mlp_params"]["w1"]), a0, a1, data[K.LAYOUT_KEY],
    )


def _jax_call(p, x, sh, emb):
    ei = jnp.asarray(p["edge_index"], dtype=jnp.int32)
    return j_fused(p["jtp"], p["mlp"], x, sh, emb, jax.tree.map(jnp.asarray, p["mlp_params"]),
                   ei[0], ei[1], jnp.asarray(p["mask"]), N_NODES)


@pytest.mark.parametrize("unsorted", [False, True])
def test_fused_forward_matches_jax_pallas(unsorted):
    p = _problem(unsorted)
    data, _ = _port_stream(p)
    got = _port_call(p, data).numpy()
    want = np.asarray(_jax_call(p, jnp.asarray(p["x"]), jnp.asarray(p["sh"]), jnp.asarray(p["emb"])))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("unsorted", [False, True])
def test_fused_gradients_match_jax_pallas(unsorted):
    """dx through K2 + K3, dsh and demb through K2, against jax.grad of the
    JAX fused call (its K2 kernel)."""
    p = _problem(unsorted)
    data, order = _port_stream(p)
    g = np.random.RandomState(9).standard_normal((N_NODES, p["tp"].irreps_out.dim))
    x = _t(p["x"]).requires_grad_(True)
    sh = data[_keys.EDGE_ATTRS_KEY].requires_grad_(True)
    emb = data[_keys.EDGE_EMBEDDING_KEY].requires_grad_(True)
    out = _port_call(p, data, x=x)
    dx, dsh, demb = torch.autograd.grad(out, (x, sh, emb), _t(g))

    def loss(x_, sh_, emb_):
        return jnp.sum(_jax_call(p, x_, sh_, emb_) * g)

    jdx, jdsh, jdemb = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(p["x"]), jnp.asarray(p["sh"]), jnp.asarray(p["emb"])
    )
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=0, atol=1e-9)
    np.testing.assert_allclose(dsh.numpy(), np.asarray(jdsh)[order], rtol=0, atol=1e-9)
    np.testing.assert_allclose(demb.numpy(), np.asarray(jdemb)[order], rtol=0, atol=1e-9)


def test_scatter_rows_matches_pallas_scatter_sum():
    r = np.random.RandomState(3)
    M, D, num_rows = 1000, 96, 256
    vals = r.standard_normal((M, D))
    idx = r.randint(0, num_rows, M)
    mask = r.rand(M) > 0.2
    real = np.nonzero(mask)[0]
    perm = real[np.argsort(idx[real], kind="stable")]
    ptr = np.concatenate([[0], np.cumsum(np.bincount(idx[real], minlength=num_rows))])
    got = K.scatter_rows(_t(vals), _t(perm, torch.int32), _t(ptr, torch.int32)).numpy()
    want = pallas_scatter_sum(
        jnp.asarray(vals), jnp.asarray(idx, dtype=jnp.int32), num_rows, mask=jnp.asarray(mask)
    )
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-12)


def test_poisoned_masked_slots_change_nothing():
    p = _problem(unsorted=True)
    data, _ = _port_stream(p)
    n_real = data[K.LAYOUT_KEY].n_real

    def run(d):
        sh = d[_keys.EDGE_ATTRS_KEY].clone().requires_grad_(True)
        emb = d[_keys.EDGE_EMBEDDING_KEY].clone().requires_grad_(True)
        d = dict(d, **{_keys.EDGE_ATTRS_KEY: sh, _keys.EDGE_EMBEDDING_KEY: emb})
        x = _t(p["x"]).requires_grad_(True)
        out = _port_call(p, d, x=x)
        return (out,) + torch.autograd.grad(out.sum(), (x, sh, emb))

    clean = run(data)
    bad = dict(data)
    for k, v in ((_keys.EDGE_ATTRS_KEY, float("nan")), (_keys.EDGE_EMBEDDING_KEY, 1e6)):
        t = data[k].clone()
        t[n_real:] = v
        bad[k] = t
    for a, b in zip(clean, run(bad)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_layout_csr_matches_numpy():
    p = _problem(unsorted=True)
    data, order = _port_stream(p)
    lay = data[K.LAYOUT_KEY]
    ei, mask = p["edge_index"][:, order], p["mask"][order]
    n_real = int(p["mask"].sum())
    assert lay.n_real == n_real and mask[:n_real].all() and not mask[n_real:].any()
    assert (np.diff(ei[0, :n_real]) >= 0).all()
    np.testing.assert_array_equal(
        lay.dst_ptr.numpy(), np.concatenate([[0], np.cumsum(np.bincount(ei[0, :n_real], minlength=N_NODES))])
    )
    src = ei[1, :n_real]
    np.testing.assert_array_equal(lay.src_perm.numpy(), np.argsort(src, kind="stable"))
    assert K.relayout_edge_stream(data) is data  # already in kernel order


def test_layout_rejects_unordered_stream():
    ei = torch.tensor([[3, 1, 2], [0, 0, 0]])
    with pytest.raises(ValueError, match="kernel order"):
        K.build_edge_layout(ei, torch.ones(3, dtype=torch.bool), 4)


def test_weight_gradients_raise():
    p = _problem(unsorted=False)
    data, _ = _port_stream(p)
    plan = K.TPPlan(p["tp"])
    w0 = _t(p["mlp_params"]["w0"]).requires_grad_(True)
    out = K.fused_tp_scatter_mlp(
        plan, _t(p["x"]), data[_keys.EDGE_ATTRS_KEY], data[_keys.EDGE_EMBEDDING_KEY],
        w0, _t(p["mlp_params"]["w1"]), *p["mlp"].alphas, data[K.LAYOUT_KEY],
    )
    with pytest.raises(NotImplementedError, match="radial-MLP weight gradients"):
        out.sum().backward()


def test_wrappers_raise_on_devices_without_a_kernel():
    v = torch.zeros(4, 8, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device"):
        K.scatter_rows(v, torch.zeros(4, dtype=torch.int32), torch.zeros(5, dtype=torch.int32))


def test_plan_tables_cover_every_column():
    p = _problem(unsorted=False)
    plan = K.TPPlan(p["tp"])
    t = plan._tables
    groups = t["fwd_groups"]
    # every output column's group starts at or before it and spans the path's channels
    cols = np.arange(plan.mid_dim)
    assert ((groups[t["fwd_col"], 0] <= cols) & (cols < groups[t["fwd_col"], 0] + 8)).all()
    assert len(t["path_coef"]) == len(t["fwd_coef"]) == len(t["dx_coef"]) == sum(
        len(q["terms"]) for q in plan.paths
    )
