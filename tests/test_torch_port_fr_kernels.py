"""The kernels of fr training in the port: K4-acc, K6, K7, the slice table and
the edge-chunked autograd Functions, against the JAX package, float64.

On the CPU the wrappers run their plain PyTorch twins.  The JAX side runs
its Pallas kernels in interpret mode through its own chunked path (the
identity layout of its ``relayout_edge_stream``, slices of whole
``block_e`` chunks as ``chunked_jvp_conv`` cuts them), each reference
jitted as one program.  The problem is the one of
``tests/unit/train/test_fr_chunked.py``: 150 atoms at random positions,
r_max 4 (3,978 real edges, shuffled, padded to 4,096 slots), 256 node
slots, features ``4x0e+4x1o`` x SH(1).  The JAX stream of 4,608 slots cut
into 3 slices puts both boundaries of slice 1 inside a destination's
segment; the port's slice 1 holds the same real edges.  K5 runs on that
slice too, and K4-acc, K6 and K7 also over whole streams with the degree
patterns of their dense tiles on the card (``DEGREE_CASES``: long
segments, empty nodes, fewer real edges than a tile, none).

Tolerances: 1e-12 of max(1, max |ref|) for the kernel twins and the chunked
outputs (float64 sums of a few dozen terms in another order), 1e-10 of max
|grad| for the VJPs (one more contraction, through the radial MLP).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nequip_tpu.data import _keys as jkeys
from nequip_tpu.ops import Irreps as JIrreps
from nequip_tpu.ops import TensorProduct as JTP
from nequip_tpu.ops import uvu_instructions as j_uvu
from nequip_tpu.ops.mlp import ScalarMLP as JScalarMLP
from nequip_tpu.ops.pallas import tp_scatter as J

from nequip_tpu_torch.data import _keys
from nequip_tpu_torch.ops.irreps import Irreps
from nequip_tpu_torch.ops.kernels import tp_scatter as K
from nequip_tpu_torch.ops.mlp import ScalarMLP
from nequip_tpu_torch.ops.tensor_product import TensorProduct, uvu_instructions
from test_torch_port_kernels import DEGREE_CASES

N_NODES, N_SLOTS, ROWS, BLOCK_E, N_EMB, HIDDEN = 256, 4096, 128, 256, 8, 16
C, SLICE = 3, 1


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max(initial=0.0))))


def _stream(ei, mask, r, n_nodes=N_NODES):
    """The test TP on the stream ``(ei, mask)`` over ``n_nodes`` nodes: the
    JAX identity layout of its relaid stream and the port's kernel-order
    stream (row r holding edge order[r]), with random per-edge operands from
    ``r`` in JAX slot order (``slot``) and in port order (``port``) and
    random node operands."""
    feats, sh = "4x0e+4x1o", "1x0e+1x1o"
    mid, ins = uvu_instructions(Irreps(feats), Irreps(sh), Irreps(feats))
    jmid, jins = j_uvu(JIrreps(feats), JIrreps(sh), JIrreps(feats))
    tp, jtp = TensorProduct(feats, sh, mid, ins), JTP(feats, sh, str(jmid), jins)
    D, S, M, W = tp.irreps_in1.dim, tp.irreps_in2.dim, tp.irreps_out.dim, tp.weight_numel
    n_real = int(mask.sum())

    # JAX: the identity layout of its relaid stream and the slot -> edge map
    jdata = J.relayout_edge_stream({
        jkeys.POSITIONS_KEY: jnp.zeros((n_nodes, 3)),
        jkeys.EDGE_INDEX_KEY: jnp.asarray(ei), jkeys.EDGE_MASK_KEY: jnp.asarray(mask),
    })
    take = J._layout_edges_np(ei[0], ei[1], mask, n_nodes, ROWS, BLOCK_E)[0]
    wm = np.asarray(jdata[J.layout_key()]["valid"])
    slot_edge = np.minimum(take, N_SLOTS - 1)
    # the port: its kernel-order stream, row r holding edge order[r]
    pdata = K.relayout_edge_stream({
        _keys.POSITIONS_KEY: torch.zeros(n_nodes, 3, dtype=torch.float64),
        _keys.EDGE_INDEX_KEY: torch.as_tensor(ei, dtype=torch.int64), _keys.EDGE_MASK_KEY: torch.as_tensor(mask),
    })
    order = np.argsort(np.where(mask, ei[0], n_nodes), kind="stable")
    slot_of_edge = np.full(N_SLOTS, -1)
    slot_of_edge[take[wm]] = np.nonzero(wm)[0]

    def edge(*shape):  # per-edge values in the original order, zero at masked slots
        return np.where(mask[:, None], r.standard_normal((N_SLOTS,) + shape), 0.0)

    arrays = dict(sh=edge(S), tsh=edge(S), w=edge(W), dw=edge(W), emb=edge(N_EMB), temb=edge(N_EMB))
    node = dict(x=r.standard_normal((n_nodes, D)), tx=r.standard_normal((n_nodes, D)),
                g=r.standard_normal((n_nodes, M)), gt=r.standard_normal((n_nodes, M)),
                acc=r.standard_normal((n_nodes, M)), tacc=r.standard_normal((n_nodes, M)))
    return dict(
        tp=tp, jtp=jtp, plan=K.TPPlan(tp), jplan=J._TPPlan(jtp), jdata=jdata, jlay=jdata[J.layout_key()],
        jsrc=jdata[jkeys.EDGE_INDEX_KEY][1], take=take, wm=wm, lay=pdata[K.LAYOUT_KEY], order=order,
        n_real=n_real, slot_of_edge=slot_of_edge, node=node,
        slot={k: np.where(wm[:, None], a[slot_edge], 0.0) for k, a in arrays.items()},
        port={k: _t(a[order]) for k, a in arrays.items()},
    )


@pytest.fixture(scope="module")
def p():
    r = np.random.RandomState(5)
    pos = r.standard_normal((150, 3)) * 3.0
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    dst, src = np.nonzero((d < 4.0) & (d > 0))
    n_real = len(dst)
    perm = np.random.RandomState(6).permutation(n_real)
    pad = np.full(N_SLOTS - n_real, N_NODES - 1)
    ei = np.stack([np.concatenate([dst[perm], pad]), np.concatenate([src[perm], pad])]).astype(np.int32)
    mask = np.arange(N_SLOTS) < n_real
    st = _stream(ei, mask, r)
    jdata, jlay, take, wm, order = st["jdata"], st["jlay"], st["take"], st["wm"], st["order"]

    # JAX slices (whole chunks, the first chunk of each re-enters the accumulator)
    E_pal = take.shape[0]
    Es, Gc = E_pal // C, E_pal // C // BLOCK_E
    stk = {
        "src": jdata[jkeys.EDGE_INDEX_KEY][1].reshape(C, Es), "rel": jlay["rel_dst"].reshape(C, Es),
        "ct": jlay["chunk_tile"].reshape(C, Gc), "cf": jlay["chunk_first"].reshape(C, Gc).at[:, 0].set(1),
        "valid": jlay["valid"].reshape(C, Es),
    }
    jslice = {"take_idx": None, "rel_dst": stk["rel"][SLICE], "chunk_tile": stk["ct"][SLICE],
              "chunk_first": stk["cf"][SLICE], "valid": stk["valid"][SLICE], "dx": "segsum"}
    bounds = [int(wm[: s * Es].sum()) for s in range(C)] + [n_real]
    sl = K.edge_slices(st["lay"], C, bounds)[SLICE]
    real_dst = ei[0][order][:n_real]
    assert real_dst[sl.start - 1] == real_dst[sl.start] and real_dst[sl.stop - 1] == real_dst[sl.stop]
    jrows = np.nonzero(wm[SLICE * Es:(SLICE + 1) * Es])[0]  # real slots of the JAX slice
    np.testing.assert_array_equal(take[SLICE * Es + jrows], order[sl.start:sl.stop])

    W = st["tp"].weight_numel
    jmlp = JScalarMLP(input_dim=N_EMB, output_dim=W, hidden_layers_depth=1, hidden_layers_width=HIDDEN,
                      nonlinearity="silu", bias=False)
    mlp_params = jax.tree.map(np.asarray, jmlp.init(jax.random.PRNGKey(2)))
    mlp = ScalarMLP(N_EMB, W, hidden_layers_depth=1, hidden_layers_width=HIDDEN)
    with torch.no_grad():
        for k in ("w0", "w1"):
            getattr(mlp, k).data = _t(mlp_params[k])
    assert np.allclose(mlp.alphas, jmlp.alphas, rtol=1e-15)
    return dict(st, jslice=jslice, stk=stk, sl=sl, Es=Es, jrows=jrows, jmlp=jmlp, mlp=mlp, mlp_params=mlp_params)


def _jslice(p, name):
    """A per-edge array in JAX slot order, cut to slice SLICE."""
    return jnp.asarray(p["slot"][name].reshape(C, p["Es"], -1)[SLICE])


def _pslice(p, name):
    return p["port"][name][p["sl"].start:p["sl"].stop]


def _jedges(p, a):
    """JAX per-edge output of slice SLICE at its real slots, in port order."""
    return np.asarray(a)[p["jrows"]]


def _check_tri_fwd_acc(q, n_nodes, jl, src, y, w, lay, py, pw):
    """K4-acc (plain on the CPU) against the JAX ``_forward(acc=...)``: in
    place, and rows of nodes without an edge keep the accumulator's values."""
    n = q["node"]
    want = jax.jit(lambda x, y, w, acc: J._forward(
        q["jtp"], x, y, w, src, src, None, num_nodes=n_nodes, rows=ROWS, block_e=BLOCK_E, layout=jl, acc=acc,
    ))(jnp.asarray(n["x"]), y, w, jnp.asarray(n["acc"]))
    acc = _t(n["acc"])
    got = K.tri_fwd(q["plan"], _t(n["x"]), py, pw, lay, acc=acc)
    assert got is acc  # in place
    _close(got.numpy(), want, 1e-12)


def test_tri_fwd_acc_matches_jax_forward_acc(p):
    """On slice 1, whose both boundaries fall inside a destination's segment."""
    _check_tri_fwd_acc(p, N_NODES, p["jslice"], p["stk"]["src"][SLICE], _jslice(p, "sh"), _jslice(p, "w"),
                       p["sl"].layout, _pslice(p, "sh"), _pslice(p, "w"))


@pytest.mark.parametrize("case", list(DEGREE_CASES))
def test_tri_fwd_acc_matches_jax_forward_acc_degrees(case):
    """Over whole streams with the degree patterns of K4-acc's dense tiles
    on the card (a segment longer than a tile, degrees 0 and 1, fewer real
    edges than a tile, a ragged last tile, every slot masked)."""
    q, n_nodes = _degree_stream(DEGREE_CASES[case])
    _check_tri_fwd_acc(q, n_nodes, q["jlay"], q["jsrc"], jnp.asarray(q["slot"]["sh"]), jnp.asarray(q["slot"]["w"]),
                       q["lay"], q["port"]["sh"], q["port"]["w"])


@pytest.mark.parametrize("with_acc,case", [(False, None), (True, None)]
                         + [(a, c) for c in DEGREE_CASES for a in (False, True)],
                         ids=["False", "True"] + [f"{a}-{c}" for c in DEGREE_CASES for a in (False, True)])
def test_jvp_fwd_matches_jax_jvp_forward(p, with_acc, case):
    """Without accumulators over the whole stream, with them over slice 1
    (both boundaries inside a destination's segment); and both forms over
    whole streams with the degree patterns of K6's dense tiles on the
    card."""
    q, n_nodes = (p, N_NODES) if case is None else _degree_stream(DEGREE_CASES[case])
    n = q["node"]
    x, tx = jnp.asarray(n["x"]), jnp.asarray(n["tx"])
    if with_acc and case is None:
        jl, src = p["jslice"], p["stk"]["src"][SLICE]
        jops = [_jslice(p, k) for k in ("sh", "tsh", "w", "dw")]
        pops = [_pslice(p, k) for k in ("sh", "tsh", "w", "dw")] + [p["sl"].layout]
    else:
        jl, src = q["jlay"], q["jsrc"]
        jops = [jnp.asarray(q["slot"][k]) for k in ("sh", "tsh", "w", "dw")]
        pops = [q["port"][k] for k in ("sh", "tsh", "w", "dw")] + [q["lay"]]
    acc = (n["acc"], n["tacc"]) if with_acc else None
    want = jax.jit(lambda x, tx, ops, acc: J._jvp_forward(
        q["jtp"], x, tx, *ops, src, n_nodes, jl, ROWS, BLOCK_E, acc=acc,
    ))(x, tx, jops, None if acc is None else tuple(map(jnp.asarray, acc)))
    got = K.jvp_fwd(q["plan"], _t(n["x"]), _t(n["tx"]), *pops, acc=None if acc is None else tuple(map(_t, acc)))
    for a, b in zip(got, want):
        _close(a.numpy(), b, 1e-12)


def test_jvp_bwd_matches_jax_jvp_backward(p):
    """K7's six outputs on slice 1 (dx, dtx through K3 on the slice's source
    CSR) against the JAX kernel's (its dx/dtx through the slice segment sum)."""
    n = p["node"]
    jops = [_jslice(p, k) for k in ("sh", "tsh", "w", "dw")]
    want = jax.jit(lambda x, tx, ops, g, gt: J._jvp_backward_kernel_call(
        p["jtp"], p["jplan"], x, tx, *ops, p["stk"]["src"][SLICE], N_NODES, ROWS, BLOCK_E, g, gt,
        layout=p["jslice"],
    ))(*(jnp.asarray(n[k]) for k in ("x", "tx")), jops, *(jnp.asarray(n[k]) for k in ("g", "gt")))
    lay = p["sl"].layout
    dx_e, dtx_e, *per_edge = K.jvp_bwd(p["plan"], _t(n["x"]), _t(n["tx"]),
                                       *(_pslice(p, k) for k in ("sh", "tsh", "w", "dw")), lay,
                                       _t(n["g"]), _t(n["gt"]))
    for e, w in ((dx_e, want[0]), (dtx_e, want[1])):
        _close(K.scatter_rows(e, lay.src_perm, lay.src_ptr).numpy(), w, 1e-12)
    for a, b in zip(per_edge, want[2:]):
        _close(a.numpy(), _jedges(p, b), 1e-12)


def test_tri_bwd_matches_jax_backward_on_slice(p):
    """K5's three outputs on slice 1, whose both boundaries fall inside a
    destination's segment (dx through K3 on the slice's source CSR), against
    the JAX kernel on the same slice (its dx through the slice segment sum)."""
    n = p["node"]
    want = jax.jit(lambda x, y, w, g: J._backward_kernel_call(
        p["jtp"], p["jplan"], x, y, w, p["stk"]["src"][SLICE], p["stk"]["src"][SLICE], None, N_NODES, ROWS,
        BLOCK_E, g, layout=p["jslice"],
    ))(jnp.asarray(n["x"]), _jslice(p, "sh"), _jslice(p, "w"), jnp.asarray(n["g"]))
    lay = p["sl"].layout
    dx_e, dy, dw = K.tri_bwd(p["plan"], _t(n["x"]), _pslice(p, "sh"), _pslice(p, "w"), lay, _t(n["g"]))
    _close(K.scatter_rows(dx_e, lay.src_perm, lay.src_ptr).numpy(), want[0], 1e-12)
    for a, b in zip((dy, dw), want[1:]):
        _close(a.numpy(), _jedges(p, b), 1e-12)


def _degree_stream(degrees):
    """``_stream`` on real edges with the given destination degrees (random
    sources, shuffled), the other slots masked."""
    r = np.random.RandomState(7)
    n_real, n_nodes = int(np.sum(degrees)), -(-(len(degrees) + 1) // ROWS) * ROWS
    dst = np.repeat(np.arange(len(degrees)), degrees)
    perm = r.permutation(n_real)
    pad = np.full(N_SLOTS - n_real, n_nodes - 1)
    src = r.randint(0, n_nodes, n_real)
    ei = np.stack([np.concatenate([dst[perm], pad]), np.concatenate([src[perm], pad])]).astype(np.int32)
    return _stream(ei, np.arange(N_SLOTS) < n_real, r, n_nodes), n_nodes


@pytest.mark.parametrize("case", list(DEGREE_CASES))
def test_jvp_bwd_matches_jax_jvp_backward_degrees(case):
    """K7's six outputs over a whole stream with the degree patterns of its
    dense tiles on the card (a segment longer than a tile, degrees 0 and 1,
    fewer real edges than a tile, a ragged last tile, every slot masked)
    against the JAX kernel on the identity layout of the same stream."""
    q, n_nodes = _degree_stream(DEGREE_CASES[case])
    n = q["node"]
    jops = [jnp.asarray(q["slot"][k]) for k in ("sh", "tsh", "w", "dw")]
    want = jax.jit(lambda x, tx, ops, g, gt: J._jvp_backward_kernel_call(
        q["jtp"], q["jplan"], x, tx, *ops, q["jsrc"], n_nodes, ROWS, BLOCK_E, g, gt, layout=q["jlay"],
    ))(*(jnp.asarray(n[k]) for k in ("x", "tx")), jops, *(jnp.asarray(n[k]) for k in ("g", "gt")))
    lay, n_real = q["lay"], q["n_real"]
    dx_e, dtx_e, *per_edge = K.jvp_bwd(q["plan"], _t(n["x"]), _t(n["tx"]),
                                       *(q["port"][k] for k in ("sh", "tsh", "w", "dw")), lay,
                                       _t(n["g"]), _t(n["gt"]))
    for e, w in ((dx_e, want[0]), (dtx_e, want[1])):
        _close(K.scatter_rows(e, lay.src_perm, lay.src_ptr).numpy(), w, 1e-12)
    rows = q["slot_of_edge"][q["order"][:n_real]]  # the JAX slots of the port's real rows
    for a, b in zip(per_edge, want[2:]):
        assert not a[n_real:].any()
        _close(a.numpy()[:n_real], np.asarray(b)[rows], 1e-12)


def test_chunked_conv_matches_jax(p):
    """ChunkedConv (K4/K4-acc, backward K5 + K3 and the MLP's VJP per slice)
    against the JAX chunked_conv and its VJP."""
    n = p["node"]
    g = n["g"]

    def f(x, sh, emb, mp):
        return J.chunked_conv(p["jtp"], p["jmlp"], mp, x, sh, emb, p["jsrc"], p["jlay"], N_NODES, C)

    jins = (jnp.asarray(n["x"]), jnp.asarray(p["slot"]["sh"]), jnp.asarray(p["slot"]["emb"]),
            jax.tree.map(jnp.asarray, p["mlp_params"]))
    want, (jdx, jdsh, jdemb, jdmlp) = jax.jit(
        lambda ins, ct: (lambda o, pull: (o, pull(ct)))(*jax.vjp(f, *ins)))(jins, jnp.asarray(g))

    x = _t(n["x"]).requires_grad_(True)
    sh, emb = (p["port"][k].clone().requires_grad_(True) for k in ("sh", "emb"))
    mlp = p["mlp"]
    got = K.chunked_conv(p["plan"], mlp, x, sh, emb, p["lay"], C)
    _close(got.detach().numpy(), want, 1e-12)
    grads = torch.autograd.grad(got, [x, sh, emb, mlp.w0, mlp.w1], _t(g))
    for a, b, per_edge in ((grads[0], jdx, False), (grads[1], jdsh, True), (grads[2], jdemb, True),
                           (grads[3], jdmlp["w0"], False), (grads[4], jdmlp["w1"], False)):
        b = _slot_to_port(p, b) if per_edge else np.asarray(b)
        a = a.numpy()[: p["n_real"]] if per_edge else a.numpy()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10 * float(np.abs(b).max()))


def _slot_to_port(p, a):
    """A JAX per-slot array (whole stream) at the port's real rows."""
    return np.asarray(a)[p["slot_of_edge"][p["order"][: p["n_real"]]]]


def _port_vjp_inputs(p, names):
    return [(_t(p["node"][k]) if k in p["node"] else p["port"][k].clone()).requires_grad_(True) for k in names]


JVP_INS = ("x", "tx", "sh", "tsh", "emb", "temb")


def _port_chunked_jvp(p, ins):
    return K.chunked_jvp_conv(p["plan"], p["mlp"], *ins, p["lay"], C)


def test_chunked_jvp_conv_matches_jax(p):
    """ChunkedJvpConv (K6; backward K7, K3 twice and the reverse of the MLP
    jvp per slice) against the JAX chunked_jvp_conv and its VJP."""
    n = p["node"]

    def f(x, tx, sh, tsh, emb, temb, mp):
        return J.chunked_jvp_conv(p["jtp"], p["jmlp"], mp, x, tx, sh, tsh, emb, temb, p["jsrc"], p["jlay"],
                                  N_NODES, C)

    jins = tuple(jnp.asarray(n[k] if k in n else p["slot"][k]) for k in JVP_INS) + (
        jax.tree.map(jnp.asarray, p["mlp_params"]),)
    cts = (jnp.asarray(n["g"]), jnp.asarray(n["gt"]))
    want, jgrads = jax.jit(lambda ins, ct: (lambda o, pull: (o, pull(ct)))(*jax.vjp(f, *ins)))(jins, cts)

    ins = _port_vjp_inputs(p, JVP_INS)
    got = _port_chunked_jvp(p, ins)
    for a, b in zip(got, want):
        _close(a.detach().numpy(), b, 1e-12)
    mlp = p["mlp"]
    grads = torch.autograd.grad(got, ins + [mlp.w0, mlp.w1], (_t(n["g"]), _t(n["gt"])))
    wants = list(jgrads[:6]) + [jgrads[6]["w0"], jgrads[6]["w1"]]
    for name, a, b in zip(JVP_INS + ("w0", "w1"), grads, wants):
        per_edge = name in ("sh", "tsh", "emb", "temb")
        b = _slot_to_port(p, b) if per_edge else np.asarray(b)
        a = a.numpy()[: p["n_real"]] if per_edge else a.numpy()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10 * float(np.abs(b).max()), err_msg=name)


def test_chunked_results_are_bitwise_repeatable(p):
    """Two calls of the chunked Functions give bitwise equal outputs and
    gradients: the accumulators are summed in place in slice order."""
    runs = []
    for _ in range(2):
        ins = _port_vjp_inputs(p, JVP_INS)
        outs = _port_chunked_jvp(p, ins)
        primal = K.chunked_conv(p["plan"], p["mlp"], ins[0], ins[2], ins[4], p["lay"], C)
        grads = torch.autograd.grad(list(outs) + [primal], ins + [p["mlp"].w0, p["mlp"].w1],
                                    [_t(p["node"][k]) for k in ("g", "gt", "acc")])
        runs.append(list(outs) + [primal] + list(grads))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_slices_cover_the_stream_with_clipped_csr(p):
    lay = p["lay"]
    slices = lay.slices(C)
    assert lay.slices(C) is slices  # built once per C
    assert [s.start for s in slices] == [0, 1326, 2652] and slices[-1].stop == p["n_real"]
    dst_ptr = lay.dst_ptr.numpy()
    for s in slices:
        sub = s.layout
        assert sub.n_real == s.stop - s.start
        np.testing.assert_array_equal(sub.dst_ptr.numpy(), np.clip(dst_ptr, s.start, s.stop) - s.start)
        src = lay.edge_src[s.start:s.stop].numpy()
        np.testing.assert_array_equal(sub.src_perm.numpy(), np.argsort(src, kind="stable"))
        np.testing.assert_array_equal(np.diff(sub.src_ptr.numpy()), np.bincount(src, minlength=N_NODES))


@pytest.mark.parametrize("n_chunks", [1, 0, -2, 2.5, 10**6])
def test_invalid_slice_counts_raise(p, n_chunks):
    with pytest.raises(ValueError, match="fr_edge_chunks"):
        K.edge_slices(p["lay"], n_chunks)


def test_dual_tensors_never_reach_a_kernel(p):
    import torch.autograd.forward_ad as fwAD

    n = p["node"]
    with fwAD.dual_level():
        x = fwAD.make_dual(_t(n["x"]), _t(n["tx"]))
        with pytest.raises(RuntimeError, match="dual tensor"):
            K.tri_fwd(p["plan"], x, p["port"]["sh"], p["port"]["w"], p["lay"])
