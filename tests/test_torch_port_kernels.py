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
from test_torch_port_cuda import DENSE_TILE_CASES

N_NODES, N_REAL, N_SLOTS, N_EMB, HIDDEN = 128, 300, 512, 8, 16


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _problem(unsorted: bool, degrees=None):
    """The test TP on 128 nodes with 300 real edges of 512 slots, or, given
    destination degrees, on a stream of real edges with those degrees
    (random sources) and 37 masked slots, over whole 128-row node tiles of
    the JAX kernel."""
    r = np.random.RandomState(0)
    feats, sh = "8x0e+8x1o+8x2e", "1x0e+1x1o+1x2e"
    target = Irreps(feats) + Irreps("8x1e+8x2o")
    mid, ins = uvu_instructions(Irreps(feats), Irreps(sh), target)
    jmid, jins = j_uvu(JIrreps(feats), JIrreps(sh), JIrreps(str(target)))
    tp, jtp = TensorProduct(feats, sh, mid, ins), JTP(feats, sh, str(jmid), jins)
    if degrees is None:
        n_nodes, n_slots = N_NODES, N_SLOTS
        dst = np.sort(r.randint(0, 100, N_REAL))
        src = r.randint(0, 100, N_REAL)
        pad = np.full(N_SLOTS - N_REAL, N_NODES - 1)
        edge_index = np.stack([np.concatenate([dst, pad]), np.concatenate([src, pad])])
        mask = np.arange(N_SLOTS) < N_REAL
    else:
        n_real = int(np.sum(degrees))
        n_nodes, n_slots = -(-len(degrees) // 128) * 128, n_real + 37
        dst = np.concatenate([np.repeat(np.arange(len(degrees)), degrees), r.randint(0, n_nodes, 37)])
        edge_index = np.stack([dst, r.randint(0, n_nodes, n_slots)])
        mask = np.arange(n_slots) < n_real
    if unsorted:
        perm = np.random.RandomState(1).permutation(n_slots)
        edge_index, mask = edge_index[:, perm], mask[perm]
    mlp = JScalarMLP(input_dim=N_EMB, output_dim=tp.weight_numel, hidden_layers_depth=1,
                     hidden_layers_width=HIDDEN, nonlinearity="silu", bias=False)
    mlp_params = jax.tree.map(np.asarray, mlp.init(jax.random.PRNGKey(2)))
    return dict(
        tp=tp, jtp=jtp, mlp=mlp, mlp_params=mlp_params, edge_index=edge_index, mask=mask, n_nodes=n_nodes,
        x=r.standard_normal((n_nodes, tp.irreps_in1.dim)),
        sh=r.standard_normal((n_slots, tp.irreps_in2.dim)),
        emb=r.standard_normal((n_slots, N_EMB)),
    )


def _port_stream(p):
    """The port's kernel-order stream; returns (data, order) with
    data[k] == original[order] for every per-edge field."""
    data = {
        _keys.POSITIONS_KEY: torch.zeros(p["n_nodes"], 3, dtype=torch.float64),
        _keys.EDGE_INDEX_KEY: torch.as_tensor(p["edge_index"], dtype=torch.int64),
        _keys.EDGE_MASK_KEY: torch.as_tensor(p["mask"]),
        _keys.EDGE_ATTRS_KEY: _t(p["sh"]),
        _keys.EDGE_EMBEDDING_KEY: _t(p["emb"]),
    }
    out = K.relayout_edge_stream(data)
    ei = p["edge_index"]
    order = np.argsort(np.where(p["mask"], ei[0], p["n_nodes"]), kind="stable")
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
                   ei[0], ei[1], jnp.asarray(p["mask"]), p["n_nodes"])


# the small degree patterns of K1/K2's dense-tile cases on the card
DEGREE_CASES = {case: degrees for case, (kind, degrees) in DENSE_TILE_CASES.items() if kind == "small"}


@pytest.mark.parametrize("unsorted,case", [(False, None), (True, None)] + [(False, c) for c in DEGREE_CASES],
                         ids=["False", "True", *DEGREE_CASES])
def test_fused_forward_matches_jax_pallas(unsorted, case):
    """The port's fused forward against the JAX K1 (interpret mode), also on
    streams whose 32-edge tiles split destinations in every way the card's
    K1 meets: a segment longer than a tile, degrees 0 and 1, fewer real
    edges than a tile, a ragged last tile, every slot masked."""
    p = _problem(unsorted, None if case is None else DEGREE_CASES[case])
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


def _tile_split_sum(dst_ptr, msg, tile, acc=None):
    """Segment sums of ``msg`` in the order of conv_fwd.cu (K1), tri_fwd.cu
    and jvp_fwd.cu (K4, K6; cg_fwd.cuh), modelled in numpy: each tile of
    ``tile`` real slots sums every segment in edge order and writes it where
    it ends in the tile, to the tile's carry row if the segment continues
    into the next tile, else to ``out`` (added onto ``acc``, the
    accumulating forms); then, per node, zero rows where no edge ends (with
    ``acc``: left as they are) and carry[t0] + ... + carry[t1 - 1] + out[n]
    where the node's edges span tiles t0 < t1."""
    n_nodes, n_real = len(dst_ptr) - 1, int(dst_ptr[-1])
    out = np.full((n_nodes, msg.shape[1]), np.nan) if acc is None else acc.copy()
    carry = np.full((K.conv_fwd_carry_rows(n_real, tile), msg.shape[1]), np.nan)
    dst = np.searchsorted(dst_ptr, np.arange(n_real), side="right") - 1  # find_dst
    for t in range(carry.shape[0]):
        base = t * tile
        cnt = min(tile, n_real - base)
        run = np.zeros(msg.shape[1])
        for e in range(cnt):
            run = run + msg[base + e]
            d = dst[base + e]
            if e == cnt - 1 or dst[base + e + 1] != d:
                if e == cnt - 1 and dst_ptr[d + 1] > base + cnt:
                    carry[t] = run
                else:
                    out[d] = run if acc is None else out[d] + run
                run = np.zeros(msg.shape[1])
    for n in range(n_nodes):
        b, e = dst_ptr[n], dst_ptr[n + 1]
        if b == e:
            if acc is None:
                out[n] = 0.0
            continue
        t0, t1 = b // tile, (e - 1) // tile
        if t0 != t1:
            v = carry[t0]
            for t in range(t0 + 1, t1):
                v = v + carry[t]
            out[n] = v + out[n]
    return out


@pytest.mark.parametrize("tile", [8, 16, 32])
@pytest.mark.parametrize("case", list(DENSE_TILE_CASES))
def test_conv_fwd_tile_split_sums_every_segment(case, tile):
    """K1's split of destinations across tiles (the carry rows the wrapper
    sizes with ``conv_fwd_carry_rows``, the order of the second launch)
    writes every node's row once, with the sum of its segment."""
    degrees = np.asarray(DENSE_TILE_CASES[case][1] + [0] * 3)
    dst_ptr = np.concatenate([[0], np.cumsum(degrees)])
    msg = np.random.RandomState(4).standard_normal((int(dst_ptr[-1]), 5))
    want = np.zeros((len(degrees), 5))
    np.add.at(want, np.repeat(np.arange(len(degrees)), degrees), msg)
    got = _tile_split_sum(dst_ptr, msg, tile)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("tile", [4, 8, 16, 32])
@pytest.mark.parametrize("case", list(DENSE_TILE_CASES))
def test_tri_fwd_acc_tile_split_sums_every_segment(case, tile):
    """K4-acc's and K6-acc's split of destinations across tiles (K1's, with
    the last part of each node added onto the accumulator and the rows of
    nodes without an edge left as they are) adds every node's segment sum
    onto its row once; the untouched rows keep their values bitwise."""
    degrees = np.asarray(DENSE_TILE_CASES[case][1] + [0] * 3)
    dst_ptr = np.concatenate([[0], np.cumsum(degrees)])
    r = np.random.RandomState(4)
    msg = r.standard_normal((int(dst_ptr[-1]), 5))
    acc = r.standard_normal((len(degrees), 5))
    want = acc.copy()
    np.add.at(want, np.repeat(np.arange(len(degrees)), degrees), msg)
    got = _tile_split_sum(dst_ptr, msg, tile, acc)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got[degrees == 0], acc[degrees == 0])


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
    """Asking for the radial-MLP weight gradients no longer raises: K2's
    training variant gives them, equal to plain autograd through the
    unfused conv."""
    p = _problem(unsorted=False)
    data, _ = _port_stream(p)
    plan = K.TPPlan(p["tp"])
    a0, a1 = p["mlp"].alphas
    ws = [_t(p["mlp_params"][k]).requires_grad_(True) for k in ("w0", "w1")]
    sh, emb, lay = data[_keys.EDGE_ATTRS_KEY], data[_keys.EDGE_EMBEDDING_KEY], data[K.LAYOUT_KEY]
    out = K.fused_tp_scatter_mlp(plan, _t(p["x"]), sh, emb, *ws, a0, a1, lay)
    got = torch.autograd.grad(out.sum(), ws)
    want = torch.autograd.grad(K.conv_fwd_plain(plan, _t(p["x"]), sh, emb, *ws, a0, a1, lay).sum(), ws)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-10)


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


def test_plan_path_terms_run_by_m2():
    """Each path's terms are its CG terms sorted stably by m2 (numpy's
    stable argsort as the reference), so K2 sums A[p, m2] as one run and
    the kernels that sum A[p, m2] term by term keep their order."""
    p = _problem(unsorted=False)
    plan = K.TPPlan(p["tp"])
    t = plan._tables
    for q, (w_off, mul, y_off, y_dim, t0, t1) in zip(plan.paths, t["paths"]):
        terms = np.array([(q["x_off"] + m1 * mul, q["out_off"] + m3 * mul, m2) for m1, m2, m3, _ in q["terms"]])
        order = np.argsort(terms[:, 2], kind="stable")
        np.testing.assert_array_equal(t["path_terms"][t0:t1], terms[order])
        np.testing.assert_array_equal(t["path_coef"][t0:t1], np.array([c for *_, c in q["terms"]])[order])
        assert (np.diff(t["path_terms"][t0:t1, 2]) >= 0).all() and t["path_terms"][t0:t1, 2].max() < y_dim
