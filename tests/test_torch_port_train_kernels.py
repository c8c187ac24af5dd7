"""The training kernels of the port: K2's weight gradients, K4, K5 and the
autograd Functions that close the fused conv under double backward.

On the CPU the wrappers run their plain PyTorch twins through the same
autograd Functions as on the card.  They are held against the JAX
package's Pallas kernels in interpret mode, on the small problem of
``tests/test_torch_port_kernels.py`` (float64, ``8x0e+8x1o+8x2e`` x SH(2),
128 nodes, 300 real edges of 512 slots, sorted and unsorted streams):

* K4/K5 (``fused_tp_scatter``/``fused_tp_scatter_bwd``): forward 1e-10,
  cotangents 1e-9; both also on the degree patterns of their dense tiles
  on the card (``DEGREE_CASES``);
* K2's ``dw1``/``dw2`` against ``jax.vjp`` of ``fused_tp_scatter_mlp``: 1e-9;
* ``dw_reduce`` (plain on the CPU) against numpy: 1e-13; its split of the
  edges into chunks (``_dw_split``) tiles them once, in order, per dtype,
  with f32's chunks at the flagship's shapes pinned and bf16's whole slabs;
* the second order, the VJP of ``FusedConvBwd`` and of ``TriConvBwd`` with
  random cotangents, against ``jax.vjp`` of the JAX VJP: 1e-9.

The tolerances are those of ``tests/test_torch_port_kernels.py`` (float64
sums in another order).  ``gradcheck`` runs on a tiny problem.  The CUDA
kernels are held against these twins on the card in
``tests/test_torch_port_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_kernels import DEGREE_CASES, _jax_call, _port_stream, _problem, _t

from nequip_tpu.ops.pallas.tp_scatter import fused_tp_scatter as j_tri
from nequip_tpu.ops.pallas.tp_scatter import fused_tp_scatter_bwd as j_tri_bwd

from nequip_tpu_torch.data import _keys
from nequip_tpu_torch.ops.irreps import Irreps
from nequip_tpu_torch.ops.kernels import tp_scatter as K
from nequip_tpu_torch.ops.tensor_product import TensorProduct, uvu_instructions

SORTS = [False, True]


def _weights(p):
    """Random per-edge TP weights [E, WN] in the stream's original order."""
    return np.random.RandomState(5).standard_normal((p["mask"].shape[0], p["tp"].weight_numel))


def _jgraph(p):
    ei = jnp.asarray(p["edge_index"], dtype=jnp.int32)
    return ei[0], ei[1], jnp.asarray(p["mask"]), p["n_nodes"]


def _g(p, seed=9):
    return np.random.RandomState(seed).standard_normal((p["n_nodes"], p["tp"].irreps_out.dim))


def _mlp_args(p):
    return _t(p["mlp_params"]["w0"]), _t(p["mlp_params"]["w1"])


def _close(got, want, atol):
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


def _jit_vjp(f, primals, cotangent):
    """``jax.vjp(f, *primals)[1](cotangent)`` as one jitted program: the
    interpret-mode kernels compile once instead of op by op."""
    return jax.jit(lambda ps, ct: jax.vjp(f, *ps)[1](ct))(primals, cotangent)


@pytest.mark.parametrize("unsorted,case", [(False, None), (True, None)] + [(False, c) for c in DEGREE_CASES],
                         ids=["False", "True", *DEGREE_CASES])
def test_tri_fwd_matches_jax_pallas(unsorted, case):
    """K4 (plain on the CPU) against the JAX kernel, also on the degree
    patterns of K4's dense tiles on the card: a segment longer than a tile
    (one tile walks it in several chunks), degrees 0 and 1, fewer real
    edges than a tile, a ragged last tile, every slot masked."""
    p = _problem(unsorted, None if case is None else DEGREE_CASES[case])
    data, order = _port_stream(p)
    w = _weights(p)
    got = K.fused_tp_scatter(K.TPPlan(p["tp"]), _t(p["x"]), data[_keys.EDGE_ATTRS_KEY], _t(w[order]),
                             data[K.LAYOUT_KEY])
    want = j_tri(p["jtp"], jnp.asarray(p["x"]), jnp.asarray(p["sh"]), jnp.asarray(w), *_jgraph(p))
    _close(got.numpy(), want, 1e-10)


@pytest.mark.parametrize("unsorted,case", [(False, None), (True, None)] + [(False, c) for c in DEGREE_CASES],
                         ids=["False", "True", *DEGREE_CASES])
def test_tri_bwd_matches_jax_pallas(unsorted, case):
    """K5 (plain on the CPU) against the JAX kernel, also on the degree
    patterns of K5's dense tiles on the card: a segment longer than a tile,
    degrees 0 and 1, fewer real edges than a tile, a ragged last tile, every
    slot masked."""
    p = _problem(unsorted, None if case is None else DEGREE_CASES[case])
    data, order = _port_stream(p)
    w, g = _weights(p), _g(p)
    dx, dy, dw = K.fused_tp_scatter_bwd(K.TPPlan(p["tp"]), _t(p["x"]), data[_keys.EDGE_ATTRS_KEY],
                                        _t(w[order]), data[K.LAYOUT_KEY], _t(g))
    jdx, jdy, jdw = j_tri_bwd(p["jtp"], jnp.asarray(p["x"]), jnp.asarray(p["sh"]), jnp.asarray(w),
                              *_jgraph(p), jnp.asarray(g))
    _close(dx.numpy(), jdx, 1e-9)
    _close(dy.numpy(), np.asarray(jdy)[order], 1e-9)
    _close(dw.numpy(), np.asarray(jdw)[order], 1e-9)


@pytest.mark.parametrize("unsorted", SORTS)
def test_conv_bwd_train_weight_grads_match_jax(unsorted):
    """All five outputs of K2's training variant (dx through K3) against
    jax.vjp of the JAX fused call (its K2 kernel with dw1/dw2)."""
    p = _problem(unsorted)
    data, order = _port_stream(p)
    g = _g(p)
    w1, w2 = _mlp_args(p)
    got = K.FusedConvBwd.apply(_t(p["x"]), data[_keys.EDGE_ATTRS_KEY], data[_keys.EDGE_EMBEDDING_KEY],
                               w1, w2, _t(g), K.TPPlan(p["tp"]), *p["mlp"].alphas, data[K.LAYOUT_KEY])

    def f(x, sh, emb, w0, w1_):
        return _jax_call(dict(p, mlp_params={"w0": w0, "w1": w1_}), x, sh, emb)

    jins = [jnp.asarray(a) for a in (p["x"], p["sh"], p["emb"], p["mlp_params"]["w0"], p["mlp_params"]["w1"])]
    want = _jit_vjp(f, jins, jnp.asarray(g))
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        _close(a.numpy(), b[order] if i in (1, 2) else b, 1e-9)


def _cotangents(shapes, seed):
    r = np.random.RandomState(seed)
    return [r.standard_normal(s) for s in shapes]


@pytest.mark.parametrize("unsorted", SORTS)
def test_fused_conv_bwd_second_order_matches_jax(unsorted):
    """The VJP of FusedConvBwd (K4/K5 through the MLP composition) against
    jax.vjp of the JAX fused call's VJP (its kernel_bwd_bwd)."""
    p = _problem(unsorted)
    data, order = _port_stream(p)
    plan = K.TPPlan(p["tp"])
    g = _g(p)
    w1, w2 = _mlp_args(p)
    ins = [_t(p["x"]), data[_keys.EDGE_ATTRS_KEY], data[_keys.EDGE_EMBEDDING_KEY], w1, w2, _t(g)]
    ins = [t.clone().requires_grad_(True) for t in ins]
    outs = K.FusedConvBwd.apply(*ins, plan, *p["mlp"].alphas, data[K.LAYOUT_KEY])
    cts = _cotangents([o.shape for o in outs], seed=11)
    per_edge = (1, 2)  # dsh, demb: port rows are original rows [order]
    port_cts = [_t(c[order] if i in per_edge else c) for i, c in enumerate(cts)]
    got = torch.autograd.grad(outs, ins, port_cts)

    def vjp_of(x, sh, emb, w0, w1_, g_):
        f = lambda *a: _jax_call(dict(p, mlp_params={"w0": a[3], "w1": a[4]}), *a[:3])
        return jax.vjp(f, x, sh, emb, w0, w1_)[1](g_)

    # JAX cotangents in original order (the port's rows were [order] of them)
    jcts = tuple(jnp.asarray(c) for c in cts)
    jins = [jnp.asarray(a) for a in (p["x"], p["sh"], p["emb"], p["mlp_params"]["w0"],
                                      p["mlp_params"]["w1"], g)]
    want = _jit_vjp(vjp_of, jins, jcts)
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        _close(a.numpy(), b[order] if i in per_edge else b, 1e-9)


@pytest.mark.parametrize("unsorted", SORTS)
def test_tri_conv_bwd_second_order_matches_jax(unsorted):
    """The VJP of TriConvBwd (three K4 and three K5 calls) against jax.vjp
    of the JAX trilinear backward (its bwd_bwd)."""
    p = _problem(unsorted)
    data, order = _port_stream(p)
    w, g = _weights(p), _g(p)
    ins = [_t(p["x"]), data[_keys.EDGE_ATTRS_KEY], _t(w[order]), _t(g)]
    ins = [t.clone().requires_grad_(True) for t in ins]
    outs = K.fused_tp_scatter_bwd(K.TPPlan(p["tp"]), *ins[:3], data[K.LAYOUT_KEY], ins[3])
    cts = _cotangents([o.shape for o in outs], seed=12)
    per_edge = (1, 2)
    got = torch.autograd.grad(outs, ins, [_t(c[order] if i in per_edge else c) for i, c in enumerate(cts)])

    def bwd(x, sh, w_, g_):
        return j_tri_bwd(p["jtp"], x, sh, w_, *_jgraph(p), g_)

    jins = [jnp.asarray(a) for a in (p["x"], p["sh"], w, g)]
    want = _jit_vjp(bwd, jins, tuple(jnp.asarray(c) for c in cts))
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        _close(a.numpy(), b[order] if i in per_edge else b, 1e-9)


def _tiny():
    """A tiny problem for gradcheck: 0e+1o features, SH(1), 6 nodes, 10 real
    edges of 12 slots."""
    r = np.random.RandomState(4)
    feats, sh = "2x0e+2x1o", "1x0e+1x1o"
    mid, ins = uvu_instructions(Irreps(feats), Irreps(sh), Irreps(feats))
    plan = K.TPPlan(TensorProduct(feats, sh, mid, ins))
    n_nodes, n_real, n_slots = 6, 10, 12
    ei = np.stack([r.randint(0, n_nodes - 1, n_slots), r.randint(0, n_nodes - 1, n_slots)])
    data = K.relayout_edge_stream({
        _keys.POSITIONS_KEY: torch.zeros(n_nodes, 3, dtype=torch.float64),
        _keys.EDGE_INDEX_KEY: torch.as_tensor(ei),
        _keys.EDGE_MASK_KEY: torch.as_tensor(np.arange(n_slots) < n_real),
    })
    t = lambda *s: torch.as_tensor(r.standard_normal(s)).requires_grad_(True)
    return plan, data[K.LAYOUT_KEY], t, n_nodes, n_slots


def test_gradcheck_tri_conv():
    plan, lay, t, n, e = _tiny()
    ins = (t(n, plan.dim_in), t(e, plan.sh_dim), t(e, plan.weight_numel))
    f = lambda x, y, w: K.fused_tp_scatter(plan, x, y, w, lay)
    assert torch.autograd.gradcheck(f, ins)
    assert torch.autograd.gradgradcheck(f, ins)


def test_gradcheck_fused_conv_bwd():
    plan, lay, t, n, e = _tiny()
    ins = (t(n, plan.dim_in), t(e, plan.sh_dim), t(e, 3), t(3, 4), t(4, plan.weight_numel), t(n, plan.mid_dim))
    alphas = (1 / np.sqrt(3), np.sqrt(2) / 2)
    f = lambda *a: K.FusedConvBwd.apply(*a, plan, *alphas, lay)
    assert torch.autograd.gradcheck(f, ins)


# dw_reduce's shapes: the flagship's dW1 and dW2 (P, Q), two ragged ones
# (masked rows and columns, two row tiles) and one whose rows are not
# 16-byte multiples; numbers of summed rows around the smallest chunk
DW_SHAPES = [(8, 128), (128, 96), (128, 352), (24, 40), (136, 20), (5, 7)]
DW_ROWS = 300
DW_NS = [0, 1, K._DW_MIN_CHUNK - 1, K._DW_MIN_CHUNK + 1, DW_ROWS]


@pytest.mark.parametrize("n", DW_NS)
@pytest.mark.parametrize("shape", DW_SHAPES)
def test_dw_reduce_plain_is_the_outer_product_sum(shape, n):
    r = np.random.RandomState(2)
    a, b = r.standard_normal((DW_ROWS, shape[0])), r.standard_normal((DW_ROWS, shape[1]))
    got = K.dw_reduce(_t(a), _t(b), 0.5, n).numpy()
    assert got.shape == shape
    _close(got, 0.5 * a[:n].T @ b[:n], 1e-13)


DW_DTYPES = [torch.float32, torch.float64, torch.bfloat16]
DW_SPLIT_NS = DW_NS + [K._DW_MIN_CHUNK, 4096, 20_000, 419_904, 10**7]
FLAGSHIP_EDGES = 419_904  # the 23k-atom frame's real edges
# the flagship's three dW shapes (P, Q) and their f32 split at its edge
# count: the f32 (and f64) summation order, which the bf16 tiles leave alone
FLAGSHIP_F32_SPLITS = {(8, 128): (386, 1088), (128, 96): (263, 1600), (128, 352): (66, 6368)}


@pytest.mark.parametrize("dtype", DW_DTYPES)
@pytest.mark.parametrize("shape", DW_SHAPES + [(128, 768)])
def test_dw_split_covers_the_edges_once_in_order(shape, dtype):
    """The chunks of ``_dw_split`` tile ``[0, n)`` in order, none empty; one
    chunk for ``n = 0``; the flagship's edge count fills a wave of SMs with
    the dtype's own block tiles (bf16: whole waves, its chunks capped)."""
    for n in DW_SPLIT_NS:
        S, chunk = K._dw_split(n, *shape, dtype)
        assert (S, chunk) == K._dw_split(n, *shape, dtype)
        assert chunk % 32 == 0 and chunk >= K._DW_MIN_CHUNK
        if n == 0:
            assert S == 1
            continue
        bounds = [(c * chunk, min(n, (c + 1) * chunk)) for c in range(S)]
        assert bounds[0][0] == 0 and bounds[-1][1] == n
        assert all(lo < hi for lo, hi in bounds)
        assert all(hi == lo for (_, hi), (lo, _) in zip(bounds, bounds[1:]))
    rows, cols, per_sm = K._dw_tile(*shape, dtype)
    tiles = -(-shape[0] // rows) * -(-shape[1] // cols)
    S, chunk = K._dw_split(FLAGSHIP_EDGES, *shape, dtype)
    wave = K._DW_SMS * per_sm
    waves = -(-S * tiles // wave)
    assert waves == 1 or (dtype == torch.bfloat16 and chunk <= K._DW_BF16_MAX_CHUNK < 2 * chunk)
    assert 0.95 * waves * wave <= S * tiles <= waves * wave


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", list(FLAGSHIP_F32_SPLITS))
def test_dw_split_keeps_the_f32_order_at_the_flagships_shapes(shape, dtype):
    """f32 and f64 keep their tiles and chunks: ``(S, chunk)`` at the
    flagship's dW shapes and edge count are the values of the split before
    bf16 had tiles of its own, and the default dtype is f32's."""
    assert K._dw_tile(*shape, dtype) == (K._DW_NARROW if shape[0] <= 8 else K._DW_WIDE)
    assert K._dw_split(FLAGSHIP_EDGES, *shape, dtype) == FLAGSHIP_F32_SPLITS[shape]
    assert K._dw_split(FLAGSHIP_EDGES, *shape) == FLAGSHIP_F32_SPLITS[shape]


@pytest.mark.parametrize("shape", DW_SHAPES + [(128, 768), (128, 224), (128, 1000)])
def test_dw_split_bf16_chunks_are_whole_slabs(shape):
    """bf16's chunks are whole slabs of its deepest ring (64 edges) and at
    most _DW_BF16_MAX_CHUNK edges (the tensor cores' accumulation error
    grows with a chunk's length), and its wide tile takes the fewest column
    tiles of at most 352 columns, each the narrowest multiple of 32 that
    covers Q (96 -> 96, 352 -> 352, 768 -> 3 x 256)."""
    for n in DW_SPLIT_NS:
        chunk = K._dw_split(n, *shape, torch.bfloat16)[1]
        assert chunk % K._DW_BF16_SLAB == 0 and chunk <= K._DW_BF16_MAX_CHUNK
    rows, cols, per_sm = K._dw_tile(*shape, torch.bfloat16)
    assert per_sm == 1
    if shape[0] <= 8:
        assert (rows, cols) == K._DW_BF16_NARROW[:2]
        return
    tiles = -(-shape[1] // 352)
    assert rows == 128 and cols % 32 == 0 and cols <= 352
    assert tiles * cols >= shape[1] > tiles * (cols - 32)
    assert cols == {96: 96, 352: 352, 768: 256, 224: 224}.get(shape[1], cols)


def test_train_variant_runs_only_when_weights_need_grads(monkeypatch):
    """Serving keeps K2's inference variant; a weight gradient takes the
    training variant."""
    p = _problem(unsorted=False)
    data, _ = _port_stream(p)
    plan = K.TPPlan(p["tp"])
    sh = data[_keys.EDGE_ATTRS_KEY].clone().requires_grad_(True)
    emb, lay = data[_keys.EDGE_EMBEDDING_KEY], data[K.LAYOUT_KEY]
    calls = []
    for name in ("conv_bwd_plain", "conv_bwd_train_plain"):
        orig = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _o=orig, _n=name: calls.append(_n) or _o(*a))
    for train in (False, True):
        w1, w2 = (w.requires_grad_(train) for w in _mlp_args(p))
        out = K.fused_tp_scatter_mlp(plan, _t(p["x"]), sh, emb, w1, w2, *p["mlp"].alphas, lay)
        torch.autograd.grad(out.sum(), sh)
    assert calls == ["conv_bwd_plain", "conv_bwd_train_plain"]
