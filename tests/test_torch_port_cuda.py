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
@pytest.mark.parametrize("name", ["tri_fwd_acc", "jvp_fwd", "jvp_fwd_acc", "jvp_bwd"])
def test_cuda_fr_kernel_matches_plain(cuda, name, dtype):
    """K4-acc, K6 (with and without accumulators) and K7 on the third of
    four edge slices, whose first destination segment the slice boundary
    splits; bitwise equal on a repeat call."""
    args, g, _ = _problem(cuda, dtype)
    plan, x, sh, lay = args[0], args[1], args[2], args[-1]
    r = np.random.RandomState(8)
    t = lambda *shape: torch.as_tensor(r.standard_normal(shape), dtype=dtype, device=cuda)
    tx, tsh, w, dw, gt = t(*x.shape), t(*sh.shape), t(N_SLOTS, plan.weight_numel), t(N_SLOTS, plan.weight_numel), t(*g.shape)
    sl = lay.slices(4)[2]
    assert lay.dst_ptr.tolist().count(sl.start) == 0  # the boundary falls inside a segment
    rows = slice(sl.start, sl.stop)
    ops = (x, tx, sh[rows], tsh[rows], w[rows], dw[rows], sl.layout)
    acc = (t(N_NODES, plan.mid_dim), t(N_NODES, plan.mid_dim))
    if name == "tri_fwd_acc":
        run = lambda: (K.tri_fwd(plan, x, sh[rows], w[rows], sl.layout, acc=acc[0].clone()),)
        plain = lambda: (K.tri_fwd_plain(plan, x, sh[rows], w[rows], sl.layout, acc[0].clone()),)
    elif name == "jvp_fwd":
        run, plain = lambda: K.jvp_fwd(plan, *ops), lambda: K.jvp_fwd_plain(plan, *ops)
    elif name == "jvp_fwd_acc":
        run = lambda: K.jvp_fwd(plan, *ops, acc=tuple(a.clone() for a in acc))
        plain = lambda: K.jvp_fwd_plain(plan, *ops, tuple(a.clone() for a in acc))
    else:
        run, plain = lambda: K.jvp_bwd(plan, *ops, g, gt), lambda: K.jvp_bwd_plain(plan, *ops, g, gt)
    counter = K.KERNELS[name.replace("jvp_fwd_acc", "jvp_fwd")]
    before = counter.launches
    got, want = run(), plain()
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    for a, b, c in zip(got, want, run()):
        rtol, atol = _tol(dtype, b)
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol)
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["conv_fwd", "conv_bwd", "conv_bwd_train", "scatter_rows", "tri_fwd", "tri_bwd"])
def test_cuda_kernel_matches_plain(cuda, name, dtype):
    args, g, v = _problem(cuda, dtype)
    plan, x, sh, emb, lay = args[0], args[1], args[2], args[3], args[-1]
    w = torch.as_tensor(np.random.RandomState(7).standard_normal((N_SLOTS, plan.weight_numel)),
                        dtype=dtype, device=cuda)
    before = K.KERNELS[name].launches
    if name == "conv_fwd":
        got, want = K.conv_fwd(*args), K.conv_fwd_plain(*args)
    elif name == "conv_bwd":
        got, want = K.conv_bwd(*args, g), K.conv_bwd_plain(*args, g)
    elif name == "conv_bwd_train":
        got, want = K.conv_bwd_train(*args, g), K.conv_bwd_train_plain(*args, g)
    elif name == "tri_fwd":
        got, want = K.tri_fwd(plan, x, sh, w, lay), K.tri_fwd_plain(plan, x, sh, w, lay)
    elif name == "tri_bwd":
        got, want = K.tri_bwd(plan, x, sh, w, lay, g), K.tri_bwd_plain(plan, x, sh, w, lay, g)
    else:
        got, want = K.scatter_rows(v, lay.src_perm, lay.src_ptr), K.scatter_rows_plain(v, lay.src_perm, lay.src_ptr)
    torch.cuda.synchronize()
    assert K.KERNELS[name].launches == before + 1
    for a, b in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        rtol, atol = _tol(dtype, b)
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol)


# Dense-tile cases of K1 and K2 (32-edge tiles in f32 and f64 at these
# widths): (plan, destination degrees of the real edges); masked slots
# follow them
DENSE_TILE_CASES = {
    "segment_longer_than_tile": ("small", [3, 0, 100, 5] + [18] * 20),
    "degree_0_and_1": ("small", list(np.random.RandomState(5).choice([0, 0, 0, 1, 1, 2, 7], 300))),
    "n_real_below_tile": ("small", [2, 0, 3]),
    "n_real_ragged": ("small", [18] * 4 + [5]),
    "n_real_zero": ("small", [0] * 50),
    "flagship_layer0": ("flagship0", [18] * 40 + [7]),
    "flagship_layer1": ("flagship1", [18] * 40 + [7]),
    # wider models whose 32-edge tiles do not fit: 16-edge tiles (K2: 64
    # features in f64, 128 in f32; K1 the same) and 8-edge tiles (128
    # features in f64)
    "wide_64": ("wide64", [18] * 10 + [7]),
    "wide_128": ("wide128", [18] * 10 + [7]),
}


def _tile_plan(kind, device, dtype):
    """(plan, w1 shape, alphas): the test TP with hidden 16, or one of the
    flagship's conv layers (hidden 128, WN 96 or 352)."""
    if kind == "small":
        args, _, _ = _problem(device, dtype)
        return args[0], (8, 16), args[6:8]
    if kind.startswith("wide"):
        mul = int(kind[4:])
        feats, sh = f"{mul}x0e+{mul}x1o+{mul}x2e", "1x0e+1x1o+1x2e"
        mid, ins = uvu_instructions(Irreps(feats), Irreps(sh), Irreps(feats) + Irreps(f"{mul}x1e+{mul}x2o"))
        plan = K.TPPlan(TensorProduct(feats, sh, mid, ins))
        return plan, (8, 16), ScalarMLP(8, plan.weight_numel, hidden_layers_depth=1, hidden_layers_width=16).alphas
    from nequip_tpu_torch.model import NequIPGNNModel
    from nequip_tpu_torch.nn.interaction_block import InteractionBlock

    model = NequIPGNNModel(seed=0, model_dtype="float64", type_names=["Cu"], r_max=4.0, num_layers=3, l_max=2,
                           parity=False, num_features=32, avg_num_neighbors=18.0, tp_impl="fused")
    blk = [m for m in model.modules() if isinstance(m, InteractionBlock)][int(kind[-1])]
    return blk.tp_scatter.plan, tuple(blk.edge_mlp.w0.shape), blk.edge_mlp.alphas


def _tile_stream(degrees, device, r, n_masked=37):
    """The kernel-order layout of real edges with the given destination
    degrees and random sources, then ``n_masked`` masked slots with random
    destinations; returns (layout, n_slots)."""
    n_nodes, n_real = len(degrees), int(np.sum(degrees))
    n_slots = n_real + n_masked
    dst = np.concatenate([np.repeat(np.arange(n_nodes), degrees), r.randint(0, n_nodes, n_masked)])
    mask = np.arange(n_slots) < n_real
    lay = K.relayout_edge_stream({
        _keys.POSITIONS_KEY: torch.zeros(n_nodes, 3, device=device),
        _keys.EDGE_INDEX_KEY: torch.as_tensor(np.stack([dst, r.randint(0, n_nodes, n_slots)]), device=device),
        _keys.EDGE_MASK_KEY: torch.as_tensor(mask, device=device),
    })[K.LAYOUT_KEY]
    assert lay.n_real == n_real
    return lay, n_slots


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(DENSE_TILE_CASES))
def test_cuda_conv_fwd_dense_tiles(cuda, case, dtype):
    """K1 on streams whose tiles cross node boundaries in every way (nodes
    split over two or more tiles, the 16- and 8-edge tiles of wide models),
    against the plain version at the file's tolerances; rows of empty and
    padding nodes exactly zero; masked slots poisoned with NaN change
    nothing; bitwise equal on a repeat call."""
    kind, degrees = DENSE_TILE_CASES[case]
    degrees = list(degrees) + [0] * 3  # padding nodes: no real edge, masked slots may point at them
    plan, (n_emb, hidden), (a0, a1) = _tile_plan(kind, cuda, dtype)
    r = np.random.RandomState(7)
    lay, n_slots = _tile_stream(degrees, cuda, r)
    n_nodes, n_real = len(degrees), lay.n_real
    t = lambda *shape: torch.as_tensor(r.standard_normal(shape), dtype=dtype, device=cuda)
    x, sh, emb, w1, w2 = t(n_nodes, plan.dim_in), t(n_slots, plan.sh_dim), t(n_slots, n_emb), t(n_emb, hidden), \
        t(hidden, plan.weight_numel)
    before = K.KERNELS["conv_fwd"].launches
    got = K.conv_fwd(plan, x, sh, emb, w1, w2, a0, a1, lay)
    torch.cuda.synchronize()
    assert K.KERNELS["conv_fwd"].launches == before + 1
    want = K.conv_fwd_plain(plan, x, sh, emb, w1, w2, a0, a1, lay)
    rtol, atol = _tol(dtype, want)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    empty = torch.as_tensor(np.asarray(degrees) == 0, device=cuda)
    assert not got[empty].any()  # NaN would count as nonzero
    poisoned = [v.clone() for v in (sh, emb)]
    for v in poisoned:
        v[n_real:] = float("nan")
    assert torch.equal(K.conv_fwd(plan, x, *poisoned, w1, w2, a0, a1, lay), got)
    assert torch.equal(K.conv_fwd(plan, x, sh, emb, w1, w2, a0, a1, lay), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["conv_bwd", "conv_bwd_train"])
@pytest.mark.parametrize("case", list(DENSE_TILE_CASES))
def test_cuda_conv_bwd_dense_tiles(cuda, case, name, dtype):
    """K2 (both variants) on streams whose tiles cross node boundaries in
    every way, against the plain version at the file's tolerances, zero at
    masked slots, and bitwise equal on a repeat call."""
    kind, degrees = DENSE_TILE_CASES[case]
    plan, (n_emb, hidden), (a0, a1) = _tile_plan(kind, cuda, dtype)
    r = np.random.RandomState(6)
    lay, n_slots = _tile_stream(degrees, cuda, r)
    n_nodes, n_real = len(degrees), lay.n_real
    t = lambda *shape: torch.as_tensor(r.standard_normal(shape), dtype=dtype, device=cuda)
    args = (plan, t(n_nodes, plan.dim_in), t(n_slots, plan.sh_dim), t(n_slots, n_emb), t(n_emb, hidden),
            t(hidden, plan.weight_numel), a0, a1, lay, t(n_nodes, plan.mid_dim))
    run, plain = getattr(K, name), getattr(K, name + "_plain")
    before = K.KERNELS[name].launches
    got = run(*args)
    torch.cuda.synchronize()
    assert K.KERNELS[name].launches == before + 1
    for a, b, c in zip(got, plain(*args), run(*args)):
        rtol, atol = _tol(dtype, b)
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol)
        assert torch.equal(a, c)
    for a in got[:3]:  # dx, dsh, demb over every slot
        assert not a[n_real:].any()


def _tri_operands(kind, device, dtype, degrees, seed):
    """(plan, layout, n_real, x, tx, sh, tsh, w, dw, g, gt) on the stream of
    ``degrees`` for K5 and K7: node rows and per-slot rows, random."""
    plan, _, _ = _tile_plan(kind, device, dtype)
    r = np.random.RandomState(seed)
    lay, n_slots = _tile_stream(degrees, device, r)
    n_nodes = len(degrees)
    t = lambda *shape: torch.as_tensor(r.standard_normal(shape), dtype=dtype, device=device)
    x, tx = t(n_nodes, plan.dim_in), t(n_nodes, plan.dim_in)
    sh, tsh = t(n_slots, plan.sh_dim), t(n_slots, plan.sh_dim)
    w, dw = t(n_slots, plan.weight_numel), t(n_slots, plan.weight_numel)
    g, gt = t(n_nodes, plan.mid_dim), t(n_nodes, plan.mid_dim)
    return plan, lay, lay.n_real, x, tx, sh, tsh, w, dw, g, gt


def _tri_call(name, plan, lay, x, tx, sh, tsh, w, dw, g, gt):
    """K5 or K7 (``name``) and its plain version on the same operands."""
    if name == "tri_bwd":
        return (lambda: K.tri_bwd(plan, x, sh, w, lay, g)), (lambda: K.tri_bwd_plain(plan, x, sh, w, lay, g))
    ops = (plan, x, tx, sh, tsh, w, dw, lay, g, gt)
    return (lambda: K.jvp_bwd(*ops)), (lambda: K.jvp_bwd_plain(*ops))


def _check_once_and_repeat(name, run, plain, dtype):
    """One launch, the plain version's values at the file's tolerances, and
    bitwise equal outputs on a repeat call; returns the outputs."""
    before = K.KERNELS[name].launches
    got = run()
    torch.cuda.synchronize()
    assert K.KERNELS[name].launches == before + 1
    for a, b, c in zip(got, plain(), run()):
        rtol, atol = _tol(dtype, b)
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol)
        assert torch.equal(a, c)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["tri_bwd", "jvp_bwd"])
@pytest.mark.parametrize("case", list(DENSE_TILE_CASES))
def test_cuda_tri_bwd_jvp_bwd_dense_tiles(cuda, case, name, dtype):
    """K5 and K7 on streams whose tiles cross node boundaries in every way
    (and the 16- and 8-edge tiles of wide models), against their plain
    versions, bitwise equal on a repeat call; masked slots read as NaN
    change nothing and come out zero."""
    kind, degrees = DENSE_TILE_CASES[case]
    plan, lay, n_real, *ops = _tri_operands(kind, cuda, dtype, degrees, seed=11)
    got = _check_once_and_repeat(name, *_tri_call(name, plan, lay, *ops), dtype)
    for a in got:
        assert not a[n_real:].any()  # NaN would count as nonzero
    poisoned = [v.clone() for v in ops]
    for v in poisoned[2:6]:  # sh, tsh, w, dw
        v[n_real:] = float("nan")
    for a, b in zip(_tri_call(name, plan, lay, *poisoned)[0](), got):
        assert torch.equal(a, b)


FWD_KERNELS = ["tri_fwd", "tri_fwd_acc", "jvp_fwd", "jvp_fwd_acc"]


def _fwd_call(name, plan, lay, x, tx, sh, tsh, w, dw, acc):
    """K4, K4-acc or K6 with or without accumulators (``name``) and its plain
    version on the same operands; each call adds onto fresh copies of
    ``acc``."""
    fresh = lambda: tuple(a.clone() for a in acc)  # noqa: E731
    if name == "tri_fwd":
        return (lambda: (K.tri_fwd(plan, x, sh, w, lay),)), (lambda: (K.tri_fwd_plain(plan, x, sh, w, lay),))
    if name == "tri_fwd_acc":
        return ((lambda: (K.tri_fwd(plan, x, sh, w, lay, acc=fresh()[0]),)),
                (lambda: (K.tri_fwd_plain(plan, x, sh, w, lay, fresh()[0]),)))
    ops = (plan, x, tx, sh, tsh, w, dw, lay)
    if name == "jvp_fwd":
        return (lambda: K.jvp_fwd(*ops)), (lambda: K.jvp_fwd_plain(*ops))
    return (lambda: K.jvp_fwd(*ops, acc=fresh())), (lambda: K.jvp_fwd_plain(*ops, fresh()))


def _check_fwd(name, run, plain, dtype, lay, acc):
    """One launch, the plain version's values at the file's tolerances,
    bitwise equal outputs on a repeat call; rows of nodes without an edge
    exactly zero (without accumulators) or bitwise the accumulators' (with
    them).  Returns the outputs."""
    counter = name.replace("jvp_fwd_acc", "jvp_fwd")
    before = K.KERNELS[counter].launches
    got = run()
    torch.cuda.synchronize()
    assert K.KERNELS[counter].launches == before + 1
    for a, b, c in zip(got, plain(), run()):
        rtol, atol = _tol(dtype, b)
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol)
        assert torch.equal(a, c)
    empty = lay.dst_ptr[1:] == lay.dst_ptr[:-1]
    for i, a in enumerate(got):
        if name.endswith("_acc"):
            assert torch.equal(a[empty], acc[i][empty])
        else:
            assert not a[empty].any()  # NaN would count as nonzero
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", FWD_KERNELS)
@pytest.mark.parametrize("case", list(DENSE_TILE_CASES))
def test_cuda_tri_fwd_jvp_fwd_dense_tiles(cuda, case, name, dtype):
    """K4, K4-acc and K6 (both forms) on streams whose tiles cross node
    boundaries in every way (nodes owned by one tile and walked over several
    chunks, the 16-, 8- and 4-edge tiles of wide models), with padding
    nodes; against their plain versions, bitwise equal on a repeat call;
    masked slots poisoned with NaN change nothing."""
    kind, degrees = DENSE_TILE_CASES[case]
    degrees = list(degrees) + [0] * 3  # padding nodes: no real edge, masked slots may point at them
    plan, lay, n_real, x, tx, sh, tsh, w, dw, g, gt = _tri_operands(kind, cuda, dtype, degrees, seed=13)
    acc = (g, gt)  # random accumulators of the _acc forms
    got = _check_fwd(name, *_fwd_call(name, plan, lay, x, tx, sh, tsh, w, dw, acc), dtype, lay, acc)
    poisoned = [v.clone() for v in (sh, tsh, w, dw)]
    for v in poisoned:
        v[n_real:] = float("nan")
    for a, b in zip(_fwd_call(name, plan, lay, x, tx, *poisoned, acc)[0](), got):
        assert torch.equal(a, b)


# slices of the fr sweep through edge_slices on [18] * 40 + [7]: the second
# slice starts inside node 1's segment at row 28 (a destination split over
# two slices, sh[rows] 16-byte aligned) or at row 37 (an odd row: the base of
# sh[rows] is 4 bytes past a 16-byte boundary in f32, 8 in f64)
SLICE_STARTS = {"split_destination": 28, "odd_row": 37}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["tri_fwd_acc", "jvp_fwd_acc"])
@pytest.mark.parametrize("case", list(SLICE_STARTS))
def test_cuda_tri_fwd_jvp_fwd_on_slices(cuda, case, name, dtype):
    """K4-acc and K6-acc on both slices of a two-slice cut of the flagship's
    layer-1 stream, the operands the rows of each slice, against plain; rows
    of nodes without an edge in the slice untouched; both slices in turn
    onto the same accumulators give the whole stream's sum."""
    degrees = [18] * 40 + [7]
    plan, lay, n_real, x, tx, sh, tsh, w, dw, g, gt = _tri_operands("flagship1", cuda, dtype, degrees, seed=14)
    slices = K.edge_slices(lay, 2, [0, SLICE_STARTS[case], n_real])
    assert SLICE_STARTS[case] not in lay.dst_ptr.tolist()  # the boundary falls inside a segment
    acc = (g, gt)
    running = tuple(a.clone() for a in acc)
    for sl in slices:
        rows = slice(sl.start, sl.stop)
        ops = (x, tx, sh[rows], tsh[rows], w[rows], dw[rows])
        if sl.start == SLICE_STARTS["odd_row"]:
            assert ops[2].data_ptr() % 16 and ops[3].data_ptr() % 16
        _check_fwd(name, *_fwd_call(name, plan, sl.layout, *ops, acc), dtype, sl.layout, acc)
        if name == "tri_fwd_acc":
            K.tri_fwd(plan, x, ops[2], ops[4], sl.layout, acc=running[0])
        else:
            K.jvp_fwd(plan, *ops, sl.layout, acc=running)
    whole = _fwd_call(name, plan, lay, x, tx, sh, tsh, w, dw, acc)[1]()
    for a, b in zip(running, whole):
        rtol, atol = _tol(dtype, b)
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["tri_bwd", "jvp_bwd"])
@pytest.mark.parametrize("case", list(SLICE_STARTS))
def test_cuda_tri_bwd_jvp_bwd_on_slices(cuda, case, name, dtype):
    """K5 and K7 on both slices of a two-slice cut of the flagship's layer-1
    stream, the operands the rows of each slice, against plain."""
    degrees = [18] * 40 + [7]
    plan, lay, n_real, x, tx, sh, tsh, w, dw, g, gt = _tri_operands("flagship1", cuda, dtype, degrees, seed=12)
    slices = K.edge_slices(lay, 2, [0, SLICE_STARTS[case], n_real])
    assert SLICE_STARTS[case] not in lay.dst_ptr.tolist()  # the boundary falls inside a segment
    for sl in slices:
        rows = slice(sl.start, sl.stop)
        ops = (x, tx, sh[rows], tsh[rows], w[rows], dw[rows], g, gt)
        if sl.start == SLICE_STARTS["odd_row"]:
            assert ops[2].data_ptr() % 16 and ops[3].data_ptr() % 16
        _check_once_and_repeat(name, *_tri_call(name, plan, sl.layout, *ops), dtype)


# dw_reduce's shapes (P, Q): the flagship's dW1 and dW2, two ragged ones
# (masked rows and columns, two row tiles) and one staged element by element
DW_SHAPES = [(8, 128), (128, 96), (128, 352), (24, 40), (136, 20), (5, 7)]
DW_ROWS = 300
DW_NS = [0, 1, K._DW_MIN_CHUNK - 1, K._DW_MIN_CHUNK + 1, DW_ROWS]


def _dw_check(a, b, n, dtype):
    """dw_reduce against its plain twin, bitwise equal on a repeat call, one
    launch each."""
    before = K.KERNELS["dw_reduce"].launches
    got = K.dw_reduce(a, b, 0.5, n)
    torch.cuda.synchronize()
    assert K.KERNELS["dw_reduce"].launches == before + 1
    want = K.dw_reduce_plain(a, b, 0.5, n)
    rtol, atol = _tol(dtype, want)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    assert torch.equal(got, K.dw_reduce(a, b, 0.5, n))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", DW_NS)
@pytest.mark.parametrize("shape", DW_SHAPES)
def test_cuda_dw_reduce_matches_plain(cuda, shape, n, dtype):
    r = np.random.RandomState(3)
    t = lambda *s: torch.as_tensor(r.standard_normal(s), dtype=dtype, device=cuda)
    _dw_check(t(DW_ROWS, shape[0]), t(DW_ROWS, shape[1]), n, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_dw_reduce_unaligned_base(cuda, dtype):
    """Operands one element past a 16-byte boundary take the element-wise
    staging path of the same kernel."""
    r = np.random.RandomState(4)
    flat = lambda m: torch.as_tensor(r.standard_normal(m * 128 + 1), dtype=dtype, device=cuda)[1:]
    a, b = flat(DW_ROWS).view(DW_ROWS, 128), flat(DW_ROWS).view(DW_ROWS, 128)
    assert a.data_ptr() % 16 and b.data_ptr() % 16
    _dw_check(a, b, DW_ROWS, dtype)


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


@pytest.mark.cuda
@pytest.mark.parametrize("tp_impl", ["fused", "fused_tp"])
def test_cuda_force_loss_grads_match_torch_model(cuda, tp_impl):
    """rr force-loss parameter gradients through the kernels (K1-K5, the
    reduction) against tp_impl="torch" on the card, float64."""
    from nequip_tpu_torch.model import NequIPGNNModel

    cfg = dict(seed=0, model_dtype="float64", type_names=["Cu"], r_max=4.0, num_layers=2, l_max=2,
               parity=False, num_features=8, radial_mlp_width=16, avg_num_neighbors=18.0)
    r = np.random.RandomState(1)
    a = 3.61
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]) * a
    pos = np.concatenate([base + np.array([i, j, k]) * a for i in range(2) for j in range(2) for k in range(2)])
    frame = compute_neighborlist_(from_dict({
        "pos": pos + r.normal(0, 0.1, pos.shape), "cell": np.diag([2 * a] * 3),
        "pbc": np.array([True] * 3), "atom_types": np.zeros(len(pos), dtype=int),
    }), 4.0)
    n_edges = frame[_keys.EDGE_INDEX_KEY].shape[1]
    batch = to_tensors(pad_batch(batched_from_list([frame]), 64, round_up(n_edges, 256), 2), cuda)
    f_ref = torch.as_tensor(r.standard_normal((64, 3)), device=cuda)
    grads = []
    for impl in ("torch", tp_impl):
        model = NequIPGNNModel(tp_impl=impl, **cfg).to(cuda)
        out = model(batch)
        loss = out[_keys.TOTAL_ENERGY_KEY][0, 0] ** 2 + ((out[_keys.FORCE_KEY] - f_ref) ** 2).sum()
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for ref, got in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-9 * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("tp_impl,n_chunks", [("fused", 0), ("fused", 3), ("fused_tp", 0), ("fused_tp", 4)])
def test_cuda_fr_grads_match_rr(cuda, tp_impl, n_chunks):
    """fr force-loss gradients through the kernels (K6/K7/K4-acc when
    chunked) against the rr step of the same model on the card, float64."""
    from nequip_tpu_torch.data import DataLoader
    from nequip_tpu_torch.data.dataset import LJTestDataset
    from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper, NeighborListTransform
    from nequip_tpu_torch.model import NequIPGNNModel, jax_named_grads
    from nequip_tpu_torch.train import EnergyForceLoss, NequIPTrainModule

    cfg = dict(seed=0, model_dtype="float64", type_names=["Cu"], r_max=4.0, num_layers=2, l_max=2,
               parity=False, num_features=8, radial_mlp_width=16, avg_num_neighbors=18.0)
    ds = LJTestDataset(num_frames=1, seed=3, transforms=[ChemicalSpeciesToAtomTypeMapper(["Cu"]), NeighborListTransform(4.0)])
    batch = next(iter(DataLoader(ds, batch_size=1, device=cuda)))
    model = NequIPGNNModel(tp_impl=tp_impl, **cfg).to(cuda)
    grads = []
    for mode, c in (("rr", 0), ("fr", n_chunks)):
        K.reset_launch_counts()
        module = NequIPTrainModule(model, loss=EnergyForceLoss(type_names=["Cu"]), force_grad_mode=mode, fr_edge_chunks=c)
        if mode == "rr":
            loss, _, _ = module.compute_loss(batch)
            loss.backward()
        else:
            module.compute_grads_fr(batch)
        grads.append(jax_named_grads(model))
        model.zero_grad(set_to_none=True)
    chunked = {k: K.KERNELS[k].launches > 0 for k in ("jvp_fwd", "jvp_bwd", "tri_fwd_acc")}
    assert all(chunked.values()) == bool(n_chunks) and any(chunked.values()) == bool(n_chunks)
    for k, ref in grads[0].items():
        np.testing.assert_allclose(grads[1][k], ref, rtol=0, atol=1e-9 * float(np.abs(ref).max()), err_msg=k)


def _microbench_ops(cuda, dtype, rows=8, be=32):
    from nequip_tpu_torch.tools.kernel_microbench import make_inputs, to_tensors

    plan, arrays = make_inputs(rows, be)
    return plan, to_tensors(arrays, cuda, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["HIGHEST", "DEFAULT", "f64"])
@pytest.mark.parametrize("variant", ["dot", "mlp", "cg", "full", "xpose", "cg_t", "full_t", "full_t_pre"])
def test_cuda_microbench_fwd_matches_plain(cuda, variant, prec):
    """T1/T3 against the plain version at G=5 (HIGHEST and f64 against plain
    f32/f64, DEFAULT against plain with TF32 rounding emulated), 1e-4
    max|ref| in f32 and 1e-12 in f64; bitwise equal on a repeat call."""
    from nequip_tpu_torch.ops.kernels import microbench as MB

    dtype = torch.float64 if prec == "f64" else torch.float32
    plan, ops = _microbench_ops(cuda, dtype)
    p = "HIGHEST" if prec == "f64" else prec
    counter = K.KERNELS["mb_fwd_t" if variant in MB.FWD_T_VARIANTS else "mb_fwd"]
    before = counter.launches
    got = MB.chunk_fwd(plan, variant, ops, 8, 5, p)
    want = MB.chunk_fwd_plain(plan, variant, ops, 8, 5, tf32=p == "DEFAULT" and variant in MB.MLP_VARIANTS)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    rel = 1e-12 if dtype == torch.float64 else 1e-4
    torch.testing.assert_close(got, want, rtol=0, atol=rel * float(want.abs().max()))
    assert torch.equal(got, MB.chunk_fwd(plan, variant, ops, 8, 5, p))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", ["r", "t"])
def test_cuda_microbench_bwd_matches_plain(cuda, layout, dtype):
    from nequip_tpu_torch.ops.kernels import microbench as MB

    plan, ops = _microbench_ops(cuda, dtype)
    got = MB.chunk_bwd(plan, ops, 5, layout)
    for a, b, c in zip(got, MB.chunk_bwd_plain(plan, ops, layout), MB.chunk_bwd(plan, ops, 5, layout)):
        rtol, atol = _tol(dtype, b)
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol)
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("be,grid", [(8, 1), (40, 3), (264, 2)])
@pytest.mark.parametrize("layout", ["r", "t"])
def test_cuda_microbench_bwd_tiles_and_ranges(cuda, layout, be, grid):
    """T2/T4 on one tile, on a chunk of 5 tiles and on 33 tiles, with one
    or a few steps (step ranges of one step each), f32 against plain."""
    from nequip_tpu_torch.ops.kernels import microbench as MB

    plan, ops = _microbench_ops(cuda, torch.float32, be=be)
    for a, b in zip(MB.chunk_bwd(plan, ops, grid, layout), MB.chunk_bwd_plain(plan, ops, layout)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()))


# (dtype, row width): row bytes 1152, 24, 28, 576, 14, 7, 576 and 2304 take
# 16-, 8-, 4-, 16-, 2-, 1-, 16- and 16-byte units
GATHER_ROWS = [(torch.float32, 288), (torch.float32, 6), (torch.float32, 7), (torch.bfloat16, 288),
               (torch.bfloat16, 7), (torch.int8, 7), (torch.int16, 288), (torch.float64, 288)]
assert {next(u for u in (16, 8, 4, 2, 1) if d * torch.empty(0, dtype=t).element_size() % u == 0)
        for t, d in GATHER_ROWS} == {16, 8, 4, 2, 1}


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,block_e,n_buf", [(3000, 128, 8), (3001, 7, 1), (777, 512, 32), (1, 512, 16)])
@pytest.mark.parametrize("dtype,dim", GATHER_ROWS)
def test_cuda_row_gather_equals_index_select(cuda, dtype, dim, n_rows, block_e, n_buf):
    """T5 bitwise equal to index_select at every unit size, row counts that
    are no multiple of the block's rows or of its flat step, and indices
    that repeat and hit both ends of src."""
    from nequip_tpu_torch.ops.kernels.row_gather import row_gather

    r = np.random.RandomState(0)
    src = torch.as_tensor(r.standard_normal((1000, dim)) * 100, device=cuda).to(dtype)
    idx = r.randint(0, 1000, n_rows)
    idx[: min(n_rows, 3)] = 999
    idx[n_rows // 2 :: 97] = 0
    idx = torch.as_tensor(idx, dtype=torch.int32, device=cuda)
    before = K.KERNELS["row_gather"].launches
    got = row_gather(src, idx, block_e=block_e, n_buf=n_buf)
    torch.cuda.synchronize()
    assert K.KERNELS["row_gather"].launches == before + 1
    assert torch.equal(got, torch.index_select(src, 0, idx))


@pytest.mark.cuda
def test_cuda_md_block_graph_replays_refilled_layouts(cuda):
    """integration="block" on the card: one CUDA graph, captured once, replays
    every block on a layout refilled in place (skin 1e-6: a rebuild after
    each block); it follows the eager host loop (float64) and its last
    block's forces equal those from a fresh neighbour list at the positions
    of the last build."""
    from nequip_tpu_torch.data.dataset import LJTestDataset
    from nequip_tpu_torch.integrations import MDDriver, VelocityVerlet
    from nequip_tpu_torch.model import NequIPGNNModel

    cfg = dict(seed=0, model_dtype="float64", type_names=["Cu"], r_max=4.0, num_layers=3, l_max=2,
               parity=False, num_features=8, radial_mlp_width=16, avg_num_neighbors=18.0)
    model = NequIPGNNModel(tp_impl="fused", **cfg)
    f = LJTestDataset(supercell=(3, 3, 3), num_frames=1, seed=31).frames[0]
    n = len(f["pos"])
    frame = {"pos": f["pos"], "cell": f["cell"], "pbc": np.array([True] * 3), "atom_types": np.zeros(n, dtype=int)}
    v0 = 0.02 * np.random.RandomState(3).standard_normal((n, 3))
    kw = dict(masses=np.full(n, 63.5), skin=1e-6, steps_per_block=5)
    outs = {}
    for integration in ("host", "block"):
        driver = MDDriver(model, dict(frame), VelocityVerlet(dt_fs=2.0), integration=integration, **kw)
        outs[integration] = driver.run(15, velocities=v0)
    assert driver.captures == 1 and driver.replays == 3 and len(driver.rebuild_timings) == 4
    for k in ("positions", "velocities", "forces"):
        np.testing.assert_allclose(outs["block"][k], outs["host"][k], rtol=0, atol=1e-9, err_msg=k)

    nl_pos = driver._nl_pos.copy()
    driver._block_program()()  # a fourth block on the layout refilled after the third
    torch.cuda.synchronize()
    fresh = MDDriver(model, dict(frame, pos=nl_pos), VelocityVerlet(dt_fs=2.0), integration="host", **kw)
    want = fresh.forces(driver._state[0].clone())
    torch.testing.assert_close(driver._state[2], want, rtol=0, atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_device_nl_matches_plain(cuda, dtype):
    """csrc/device_nl.cu against its plain twin on the same CUDA tensors: the
    slots, the stream and the flag equal exactly (the same single-rounded
    geometry decides every cutoff test), bitwise equal on a repeat call,
    and under small capacities the same flag and the same kept edges."""
    from nequip_tpu_torch.ops import device_nl as D

    r = np.random.RandomState(0)
    a, reps = 3.61, 5
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]) * a
    pos = np.concatenate([base + np.array([i, j, k]) * a for i in range(reps) for j in range(reps) for k in range(reps)])
    cell = np.diag([reps * a] * 3) + np.array([[0.0, 0.0, 0.0], [0.9, 0.0, 0.0], [0.0, 0.4, 0.0]])
    pos = (pos + r.normal(0, 0.1, pos.shape)) @ np.linalg.inv(np.diag([reps * a] * 3)) @ cell + 2.0 * cell[0]
    r_cut = 4.5
    dims = D.suggest_grid_dims(cell, r_cut)
    grid = D.cell_grid(cell, r_cut, dims, dtype, cuda)
    x = torch.as_tensor(pos, dtype=dtype, device=cuda)
    n = len(pos)

    def run(fn, cell_cap, k_max, e_cap):
        out = (torch.empty(2, e_cap, dtype=torch.int64, device=cuda), torch.empty(e_cap, 3, dtype=dtype, device=cuda),
               torch.empty(e_cap, dtype=torch.bool, device=cuda))
        flag = torch.zeros(1, dtype=torch.int32, device=cuda)
        slots = fn(x, grid, cell_cap, k_max, flag, out=out, pad_index=n - 1)
        torch.cuda.synchronize()
        return tuple(slots) + out + (flag,)

    before = K.KERNELS["device_nl"].launches
    for cell_cap, k_max, e_cap, overflow in ((24, 64, 64 * n, 0), (2, 64, 64 * n, 1), (24, 8, 64 * n, 1),
                                             (24, 64, 1024, 1)):
        got = run(D.device_nl, cell_cap, k_max, e_cap)
        again = run(D.device_nl, cell_cap, k_max, e_cap)
        want = run(D.device_nl_plain, cell_cap, k_max, e_cap)
        assert int(got[-1].item()) == overflow
        for g, a2, w in zip(got, again, want):
            assert torch.equal(g, w) and torch.equal(g, a2)
    assert K.KERNELS["device_nl"].launches == before + 8


@pytest.mark.cuda
def test_cuda_md_device_nl_graphs(cuda):
    """nl_backend="device" on the card: the block graph, then at each rebuild
    (skin 1e-6: after every block) the rebuild and force-refresh graphs,
    captured once; it follows the host-list block run (float64) and its
    last forces equal those from a fresh host list at the final positions."""
    from nequip_tpu_torch.data.dataset import LJTestDataset
    from nequip_tpu_torch.integrations import MDDriver, VelocityVerlet
    from nequip_tpu_torch.model import NequIPGNNModel

    cfg = dict(seed=0, model_dtype="float64", type_names=["Cu"], r_max=4.0, num_layers=3, l_max=2,
               parity=False, num_features=8, radial_mlp_width=16, avg_num_neighbors=18.0)
    model = NequIPGNNModel(tp_impl="fused", **cfg)
    f = LJTestDataset(supercell=(4, 4, 4), num_frames=1, seed=31).frames[0]
    n = len(f["pos"])
    frame = {"pos": f["pos"], "cell": f["cell"], "pbc": np.array([True] * 3), "atom_types": np.zeros(n, dtype=int)}
    v0 = 0.02 * np.random.RandomState(3).standard_normal((n, 3))
    kw = dict(masses=np.full(n, 63.5), skin=1e-6, steps_per_block=5)
    outs = {}
    for backend in ("host", "device"):
        driver = MDDriver(model, dict(frame), VelocityVerlet(dt_fs=2.0), nl_backend=backend, **kw)
        outs[backend] = driver.run(15, velocities=v0)
    assert driver.captures == 1 and driver.replays == 3 and driver.rebuilds == 3
    assert [list(t) for t in driver.rebuild_timings[1:]] == [["device_nl_ms"]] * 4
    for k in ("positions", "velocities", "forces"):
        np.testing.assert_allclose(outs["device"][k], outs["host"][k], rtol=0, atol=1e-9, err_msg=k)
    fresh = MDDriver(model, dict(frame, pos=outs["device"]["positions"]), VelocityVerlet(dt_fs=2.0),
                     integration="host", **kw)
    want = fresh.forces(torch.as_tensor(outs["device"]["positions"], dtype=torch.float64, device=cuda))
    np.testing.assert_allclose(outs["device"]["forces"], want.cpu().numpy(), rtol=0, atol=1e-10)
