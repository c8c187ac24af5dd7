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
    """(plan, w1 shape, alphas): the test TP with hidden 16, a TP of
    ``wide<mul>`` channels with hidden 16 (``odd``: 5 channels, dim_in 45,
    WN 75, hidden 20), one of the flagship's conv layers (hidden 128, WN 96
    or 352), or preset M's layer 1 (``preset_m1``: dim_in 480, WN 768)."""
    if kind == "small":
        args, _, _ = _problem(device, dtype)
        return args[0], (8, 16), args[6:8]
    if kind == "odd":
        plan, _, _ = _tile_plan("wide5", device, dtype)
        return plan, (8, 20), ScalarMLP(8, plan.weight_numel, hidden_layers_depth=1, hidden_layers_width=20).alphas
    if kind == "preset_m1":
        from nequip_tpu_torch.model import PresetNequIPGNNModel
        from nequip_tpu_torch.nn.interaction_block import InteractionBlock

        model = PresetNequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", type_names=["Cu"], r_max=4.0,
                                     preset="M", avg_num_neighbors=18.0)
        blk = [m for m in model.modules() if isinstance(m, InteractionBlock)][1]
        return blk.tp_scatter.plan, tuple(blk.edge_mlp.w0.shape), blk.edge_mlp.alphas
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


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["conv_fwd", "conv_bwd_train"])
def test_cuda_smem_opt_in_holds_across_threads(cuda, name):
    """A kernel launched from another thread at a smaller shared-memory size
    (autograd's backward thread launches K1 under remat, and K2 always)
    leaves the larger sizes this thread launched before launchable: the
    kernel's opt-in and the cache of launch geometry are the process's."""
    import threading

    def case(kind, seed):
        plan, (n_emb, hidden), (a0, a1) = _tile_plan(kind, cuda, torch.float32)
        r = np.random.RandomState(seed)
        lay, n_slots = _tile_stream([18] * 10 + [7], cuda, r)
        t = lambda *shape: torch.as_tensor(r.standard_normal(shape), dtype=torch.float32, device=cuda)  # noqa: E731
        args = (plan, t(11, plan.dim_in), t(n_slots, plan.sh_dim), t(n_slots, n_emb), t(n_emb, hidden),
                t(hidden, plan.weight_numel), a0, a1, lay)
        if name == "conv_bwd_train":
            args = args + (t(11, plan.mid_dim),)
        run = lambda: getattr(K, name)(*args)  # noqa: E731
        return run, getattr(K, name + "_plain")(*args)

    def check(got, want):
        for a, b in zip(*((got, want) if isinstance(want, tuple) else ((got,), (want,)))):
            rtol, atol = _tol(torch.float32, b)
            torch.testing.assert_close(a, b, rtol=rtol, atol=atol)

    # one kernel instance (K1 and K2 take 32-edge tiles at both widths), two shared-memory sizes
    big, big_want = case("flagship1", 1)
    small, small_want = case("small", 2)
    first = big()
    torch.cuda.synchronize()
    check(first, big_want)
    out = {}
    worker = threading.Thread(target=lambda: out.update(small=small()))
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive() and "small" in out
    torch.cuda.synchronize()
    check(out["small"], small_want)
    again = big()
    torch.cuda.synchronize()
    check(again, big_want)


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


# dw_reduce's shapes (P, Q): the flagship's dW1 and dW2, preset M's widest
# dW2, two ragged ones (masked rows and columns, two row tiles) and one
# staged element by element
DW_SHAPES = [(8, 128), (128, 96), (128, 352), (128, 768), (24, 40), (136, 20), (5, 7)]
DW_ROWS = 300
DW_NS = [0, 1, K._DW_MIN_CHUNK - 1, K._DW_MIN_CHUNK + 1, DW_ROWS]


def _dw_check(a, b, n, dtype):
    """dw_reduce against its plain twin at the result dtype's tolerance
    (bf16 operands: a float32 result at the f32 gate), bitwise equal on a
    repeat call, one launch each."""
    before = K.KERNELS["dw_reduce"].launches
    got = K.dw_reduce(a, b, 0.5, n)
    torch.cuda.synchronize()
    assert K.KERNELS["dw_reduce"].launches == before + 1
    want = K.dw_reduce_plain(a, b, 0.5, n)
    assert got.dtype == want.dtype == K.acc_dtype(dtype)
    rtol, atol = _tol(want.dtype, want)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    assert torch.equal(got, K.dw_reduce(a, b, 0.5, n))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("n", DW_NS)
@pytest.mark.parametrize("shape", DW_SHAPES)
def test_cuda_dw_reduce_matches_plain(cuda, shape, n, dtype):
    r = np.random.RandomState(3)
    t = lambda *s: torch.as_tensor(r.standard_normal(s), dtype=dtype, device=cuda)
    _dw_check(t(DW_ROWS, shape[0]), t(DW_ROWS, shape[1]), n, dtype)


# bf16 at a row count whose chunks each take several turns of the ring
# (8 slabs of 32 or 64 edges): at least 1,536 edges a chunk at every shape
DW_MANY_ROWS = 200_000


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 128), (128, 96), (128, 352), (128, 768)])
def test_cuda_dw_reduce_bf16_many_chunks(cuda, shape):
    """bf16 over many chunks and many slabs a chunk: the tensor-core sums
    within the f32 gate of the twin's float64 sum, bitwise on a repeat."""
    assert K._dw_split(DW_MANY_ROWS, *shape, torch.bfloat16)[1] >= 3 * 8 * 64
    g = torch.Generator(device=cuda).manual_seed(5)
    t = lambda q: torch.randn(DW_MANY_ROWS, q, generator=g, device=cuda).bfloat16()
    _dw_check(t(shape[0]), t(shape[1]), DW_MANY_ROWS, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 128), (128, 352)])
def test_cuda_dw_reduce_bf16_mixed_magnitudes(cuda, shape):
    """Rows of a and b scaled by 2^8 or 2^-8 at random, so that one k16
    group of the tensor cores adds products 2^32 apart: its float32 sums
    stay within the f32 gate of the twin."""
    r = np.random.RandomState(6)
    n = 20_000
    t = lambda q: torch.as_tensor(r.standard_normal((n, q)) * 2.0 ** (8 * r.choice([-1, 1], (n, 1))),
                                  dtype=torch.bfloat16, device=cuda)
    _dw_check(t(shape[0]), t(shape[1]), n, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_cuda_dw_reduce_unaligned_base(cuda, dtype):
    """Operands one element past a 16-byte boundary take the element-wise
    staging path of the same kernel (bf16: two-byte copies)."""
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
@pytest.mark.parametrize("tp_impl,extra", [("fused", {}), ("fused_tp", {}), ("fused", {"radial_mlp_depth": 2})],
                         ids=["k1", "k4", "k4_depth2"])
def test_cuda_md_device_nl_graphs(cuda, tp_impl, extra):
    """nl_backend="device" on the card, on K1's route and both ways onto K4's:
    the block graph, then at each rebuild (skin 1e-6: after every block)
    the rebuild and force-refresh graphs, captured once; it follows the
    host-list block run (float64) and its last forces equal those from a
    fresh host list at the final positions."""
    from nequip_tpu_torch.data.dataset import LJTestDataset
    from nequip_tpu_torch.integrations import MDDriver, VelocityVerlet
    from nequip_tpu_torch.model import NequIPGNNModel

    cfg = dict(seed=0, model_dtype="float64", type_names=["Cu"], r_max=4.0, num_layers=3, l_max=2,
               parity=False, num_features=8, radial_mlp_width=16, avg_num_neighbors=18.0)
    model = NequIPGNNModel(tp_impl=tp_impl, **cfg, **extra)
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


# --- bfloat16: K1, K2's inference variant and K3 ---------------------------------
# A bf16 kernel and its plain twin round at the same points and differ only
# by the order of their float32 sums, so an output (or a rounded w inside)
# may land one bf16 ulp apart where a sum lies near a rounding boundary:
# max error 8e-3 of max|out|, two bf16 ulps of it.
BF16_TOL = 8e-3


def _bf16_check(got, want):
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16
        assert bool(a.float().isfinite().all())
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= BF16_TOL * scale


@pytest.fixture
def bf16_sums():
    """cuBLAS's bf16 products (the twins' radial MLP) with float32 sums, as JAX
    sums them (_acc_dtype): the package never changes this setting."""
    old = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    yield
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = old


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["conv_fwd", "conv_bwd"])
@pytest.mark.parametrize("case", list(DENSE_TILE_CASES))
def test_cuda_bf16_conv_dense_tiles(cuda, bf16_sums, case, name):
    """K1 and K2's inference variant in bf16 on streams whose tiles cross
    node boundaries in every way (K1's split destinations through both of
    its carry rows), against their plain twins (bf16 in, float32 inside, the
    same rounding points) within two bf16 ulps of max|out|; K1's rows of
    empty nodes and K2's masked slots exactly zero; bitwise equal on a
    repeat call."""
    kind, degrees = DENSE_TILE_CASES[case]
    degrees = list(degrees) + [0] * 3
    plan, (n_emb, hidden), (a0, a1) = _tile_plan(kind, cuda, torch.float32)
    r = np.random.RandomState(9)
    lay, n_slots = _tile_stream(degrees, cuda, r)
    n_nodes, n_real = len(degrees), lay.n_real
    t = lambda *shape: torch.as_tensor(r.standard_normal(shape), dtype=torch.bfloat16, device=cuda)
    args = (plan, t(n_nodes, plan.dim_in), t(n_slots, plan.sh_dim), t(n_slots, n_emb), t(n_emb, hidden),
            t(hidden, plan.weight_numel), a0, a1, lay)
    if name == "conv_bwd":
        args += (t(n_nodes, plan.mid_dim),)
    run, plain = getattr(K, name), getattr(K, name + "_plain")
    before = K.KERNELS[name].launches
    got = run(*args)
    torch.cuda.synchronize()
    assert K.KERNELS[name].launches == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = plain(*args)
    _bf16_check(got, want if isinstance(want, tuple) else (want,))
    again = run(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again if isinstance(again, tuple) else (again,)))
    if name == "conv_fwd":
        assert not got[0][torch.as_tensor(np.asarray(degrees) == 0, device=cuda)].any()
    else:
        for a in got:
            assert not a[n_real:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DENSE_TILE_CASES))
def test_cuda_bf16_conv_bwd_train_dense_tiles(cuda, bf16_sums, case):
    """K2's training variant in bf16 on every dense-tile pattern: its dx,
    dsh and demb bitwise equal to the inference variant's (the per-edge
    factors stay float32 in the tile) and zero at masked slots; its float32
    dw1/dw2 (the dW reduction over the bf16 factors) within two bf16 ulps
    of max|out| of the twin's; every output bitwise equal on a repeat call,
    one launch of K2 and two of the dW reduction."""
    kind, degrees = DENSE_TILE_CASES[case]
    plan, (n_emb, hidden), (a0, a1) = _tile_plan(kind, cuda, torch.float32)
    r = np.random.RandomState(12)
    lay, n_slots = _tile_stream(degrees, cuda, r)
    n_nodes, n_real = len(degrees), lay.n_real
    t = lambda *shape: torch.as_tensor(r.standard_normal(shape), dtype=torch.bfloat16, device=cuda)
    args = (plan, t(n_nodes, plan.dim_in), t(n_slots, plan.sh_dim), t(n_slots, n_emb), t(n_emb, hidden),
            t(hidden, plan.weight_numel), a0, a1, lay, t(n_nodes, plan.mid_dim))
    before = {k: K.KERNELS[k].launches for k in ("conv_bwd_train", "dw_reduce")}
    got = K.conv_bwd_train(*args)
    torch.cuda.synchronize()
    assert K.KERNELS["conv_bwd_train"].launches == before["conv_bwd_train"] + 1
    assert K.KERNELS["dw_reduce"].launches == before["dw_reduce"] + 2
    want = K.conv_bwd_train_plain(*args)
    _bf16_check(got[:3], want[:3])
    for a, b in zip(got[3:], want[3:]):
        assert a.dtype == b.dtype == torch.float32 and bool(a.isfinite().all())
        assert float((a - b).abs().max()) <= BF16_TOL * float(b.abs().max())
    for a, b in zip(got[:3], K.conv_bwd(*args)):
        assert torch.equal(a, b)
        assert not a[n_real:].any()
    assert all(torch.equal(a, b) for a, b in zip(got, K.conv_bwd_train(*args)))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["flagship0", "flagship1", "preset_m1", "odd"])
def test_cuda_bf16_conv_bwd_train_mma_widths(cuda, bf16_sums, kind):
    """K2's training variant in bf16, whose two W2 products run on the
    tensor cores (tile_mma: 128-column chunks, k16 steps), at widths that
    leave the last chunk or k step part full: WN 96 and 352 (the flagship),
    768 (preset M's widest, one block an SM) and an odd model (WN 75,
    hidden 20, dim_in 45: W2's rows not 16-byte aligned, so its slabs are
    copied 2 bytes at a time).  Against the twin within two bf16 ulps of
    max|out| (dw1/dw2 float32 at the same gate), dx, dsh and demb bitwise
    the inference variant's, everything bitwise equal on a repeat call."""
    plan, (n_emb, hidden), (a0, a1) = _tile_plan(kind, cuda, torch.float32)
    r = np.random.RandomState(24)
    lay, n_slots = _tile_stream([18] * 40 + [7], cuda, r)
    n_nodes, n_real = 41, lay.n_real
    t = lambda *shape: torch.as_tensor(r.standard_normal(shape), dtype=torch.bfloat16, device=cuda)
    args = (plan, t(n_nodes, plan.dim_in), t(n_slots, plan.sh_dim), t(n_slots, n_emb), t(n_emb, hidden),
            t(hidden, plan.weight_numel), a0, a1, lay, t(n_nodes, plan.mid_dim))
    before = K.KERNELS["conv_bwd_train"].launches
    got = K.conv_bwd_train(*args)
    torch.cuda.synchronize()
    assert K.KERNELS["conv_bwd_train"].launches == before + 1
    want = K.conv_bwd_train_plain(*args)
    _bf16_check(got[:3], want[:3])
    for a, b in zip(got[3:], want[3:]):
        assert a.dtype == b.dtype == torch.float32 and bool(a.isfinite().all())
        assert float((a - b).abs().max()) <= BF16_TOL * float(b.abs().max())
    for a, b in zip(got[:3], K.conv_bwd(*args)):
        assert torch.equal(a, b)
        assert not a[n_real:].any()
    assert all(torch.equal(a, b) for a, b in zip(got, K.conv_bwd_train(*args)))


@pytest.mark.cuda
def test_cuda_bf16_scatter_rows_matches_plain(cuda):
    """K3 in bf16: float32 sums in edge order, rounded once; bitwise equal
    on a repeat call, and within one bf16 ulp of max|out| of the twin."""
    args, _, v = _problem(cuda, torch.bfloat16)
    lay = args[-1]
    before = K.KERNELS["scatter_rows"].launches
    got = K.scatter_rows(v, lay.src_perm, lay.src_ptr)
    torch.cuda.synchronize()
    assert K.KERNELS["scatter_rows"].launches == before + 1
    _bf16_check((got,), (K.scatter_rows_plain(v, lay.src_perm, lay.src_ptr),))
    assert torch.equal(got, K.scatter_rows(v, lay.src_perm, lay.src_ptr))


def _k3_case(device, d: int, degrees, seed: int = 0, offset: int = 0):
    """bf16 values over distinct rows, a source-sorted CSR with the given
    degrees, ``perm`` a permutation's prefix; the values a contiguous view
    ``offset`` values into a flat buffer (1: 2 bytes off 16-byte alignment)."""
    r = np.random.RandomState(seed)
    deg = np.asarray(degrees)
    m = int(deg.sum()) + 37
    ptr = torch.as_tensor(np.concatenate([[0], np.cumsum(deg)]), dtype=torch.int32, device=device)
    perm = torch.as_tensor(r.permutation(m)[: int(deg.sum())], dtype=torch.int32, device=device)
    flat = torch.as_tensor(r.standard_normal(m * d + offset), dtype=torch.bfloat16, device=device)
    return flat[offset:].view(m, d), perm, ptr


def _k3_holds(v, perm, ptr):
    """One launch (the counter moves by one), bitwise the edge-order float32
    reference and the repeat call."""
    before = K.KERNELS["scatter_rows"].launches
    got = K.scatter_rows(v, perm, ptr)
    torch.cuda.synchronize()
    assert K.KERNELS["scatter_rows"].launches == before + 1
    want = K.scatter_rows_edge_order(v, perm, ptr)
    assert got.dtype == want.dtype == torch.bfloat16 and torch.equal(got, want)
    assert torch.equal(got, K.scatter_rows(v, perm, ptr))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 7, 8, 32, 36, 288, 480])
def test_cuda_bf16_scatter_rows_is_edge_order(cuda, d):
    """K3 in bf16 (rows packed into warps at the host's geometry) at widths
    that take both load widths (D % 8 == 0: 16 bytes, else 2) and several
    lane packings, on
    300 rows of 0-30 edges, a quarter of them empty (zeros): bitwise the
    float32 sum in edge order rounded once."""
    r = np.random.RandomState(d)
    deg = r.randint(1, 31, 300) * (r.rand(300) > 0.25)
    v, perm, ptr = _k3_case(cuda, d, deg, seed=d)
    assert K.scatter_rows_geometry(d, v.data_ptr() % 16 == 0).vec == (8 if d % 8 == 0 else 1)
    got = _k3_holds(v, perm, ptr)
    assert not got[torch.as_tensor(deg == 0, device=cuda)].any()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 288])
def test_cuda_bf16_scatter_rows_long_segment(cuda, d):
    """One segment of 200 edges (several chunks of a row's indices) among
    short and empty ones, bitwise the edge-order reference."""
    _k3_holds(*_k3_case(cuda, d, [3, 0, 200, 5, 0, 17, 1], seed=5))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 36, 288])
def test_cuda_bf16_scatter_rows_misaligned_view(cuda, d):
    """A values view whose data_ptr is 2 bytes off 16-byte alignment takes
    the kernel's 2-byte load path (not the twin), bitwise the edge-order
    reference."""
    v, perm, ptr = _k3_case(cuda, d, np.random.RandomState(7).randint(0, 25, 200), seed=7, offset=1)
    assert v.data_ptr() % 16 == 2 and K.scatter_rows_geometry(d, False).vec == 1
    _k3_holds(v, perm, ptr)


@pytest.mark.cuda
def test_cuda_bf16_scatter_rows_registered_op(cuda):
    """``torch.ops.nequip_torch.scatter_rows`` (serving, exported programs)
    launches the same kernel: bitwise the edge-order reference."""
    v, perm, ptr = _k3_case(cuda, 288, np.random.RandomState(3).randint(0, 25, 200), seed=3)
    before = K.KERNELS["scatter_rows"].launches
    got = torch.ops.nequip_torch.scatter_rows(v, perm, ptr)
    torch.cuda.synchronize()
    assert K.KERNELS["scatter_rows"].launches == before + 1
    assert torch.equal(got, K.scatter_rows_edge_order(v, perm, ptr))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 288])
def test_cuda_bf16_scatter_rows_in_a_cuda_graph(cuda, d):
    """Captured in a CUDA graph (as MD's blocks capture it: the launch reads
    nothing on the host but D and the alignment), a replay on new values
    equals the eager call on them."""
    v, perm, ptr = _k3_case(cuda, d, np.random.RandomState(4).randint(0, 25, 200), seed=4)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K.scatter_rows(v, perm, ptr)  # loads the library before the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K.scatter_rows(v, perm, ptr)
    v.copy_(torch.as_tensor(np.random.RandomState(9).standard_normal(tuple(v.shape)), dtype=torch.bfloat16))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, K.scatter_rows(v, perm, ptr))
    assert torch.equal(out, K.scatter_rows_edge_order(v, perm, ptr))


@pytest.mark.cuda
def test_cuda_bf16_model_serves_through_k1_k2_k3(cuda, bf16_sums):
    """A bf16 model (enable_bf16_fast_mode, tp_impl="fused") on the card:
    its parameters float32, its forces float64 and finite, within 5e-2 of
    max|F| of the float32 model and its energy within 5e-3 eV an atom of it
    (sanity bounds: the CPU tests hold bf16 to the golden; this model has
    no energy shift, so its total energy is a small sum of per-atom terms
    of either sign and a relative bound would not hold), and its launches
    K1, K2's inference variant and K3 only."""
    from nequip_tpu_torch.integrations import NequIPCalculator
    from nequip_tpu_torch.model import NequIPGNNModel
    from nequip_tpu_torch.model.modify_utils import modify

    cfg = dict(seed=0, model_dtype="float32", type_names=["Cu"], r_max=4.0, num_layers=3, l_max=2,
               parity=False, num_features=32, avg_num_neighbors=18.0, tp_impl="fused")
    m32 = NequIPGNNModel(**cfg)
    m16 = modify(m32, [{"modifier": "enable_bf16_fast_mode"}, {"modifier": "enable_TPUFusedTPScatter"}])
    assert {p.dtype for p in m16.parameters()} == {torch.float32}
    r = np.random.RandomState(2)
    a = 3.61
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]) * a
    pos = np.concatenate([base + np.array([i, j, k]) * a for i in range(4) for j in range(4) for k in range(4)])
    frame = {"pos": pos + r.normal(0, 0.1, pos.shape), "cell": np.diag([4 * a] * 3), "pbc": np.array([True] * 3),
             "atomic_numbers": np.full(len(pos), 29)}
    ref = NequIPCalculator.from_model(m32, device=cuda).calculate(frame)
    K.reset_launch_counts()
    got = NequIPCalculator.from_model(m16, device=cuda).calculate(frame)
    launches = {k: fn.launches for k, fn in K.KERNELS.items()}
    assert all(launches[k] > 0 for k in ("conv_fwd", "conv_bwd", "scatter_rows"))
    assert not any(v for k, v in launches.items() if k not in ("conv_fwd", "conv_bwd", "scatter_rows"))
    assert got["forces"].dtype == np.float64 and np.isfinite(got["forces"]).all()
    scale = np.abs(ref["forces"]).max()
    assert np.abs(got["forces"] - ref["forces"]).max() <= 5e-2 * scale
    assert abs(got["energy"] - ref["energy"]) <= 5e-3 * len(pos)


# --- bfloat16: the trilinear kernels K4/K4-acc, K5, K6 and K7 ----------------------
def _bf16_tri_operands(kind, device, degrees, seed):
    """``_tri_operands`` in bf16, with float32 accumulators for the _acc
    forms (``acc_dtype``)."""
    plan, lay, n_real, *ops = _tri_operands(kind, device, torch.bfloat16, degrees, seed)
    return plan, lay, n_real, ops, (ops[-2].float(), ops[-1].float())


def _bf16_fwd_check(name, run, plain, lay, acc):
    """One launch, the twin's values within two bf16 ulps of max|out| (the
    accumulators of the _acc forms, float32, within 8e-3 of max|out| too),
    bitwise equal on a repeat call; rows of nodes without an edge exactly
    zero, or the accumulators' bitwise."""
    counter = name.replace("jvp_fwd_acc", "jvp_fwd")
    before = K.KERNELS[counter].launches
    got = run()
    torch.cuda.synchronize()
    assert K.KERNELS[counter].launches == before + 1
    want = plain()
    dtype = torch.float32 if name.endswith("_acc") else torch.bfloat16
    for a, b, c in zip(got, want, run()):
        assert a.dtype == dtype == b.dtype and bool(a.isfinite().all())
        assert float((a.float() - b.float()).abs().max()) <= BF16_TOL * float(b.float().abs().max())
        assert torch.equal(a, c)
    empty = lay.dst_ptr[1:] == lay.dst_ptr[:-1]
    for i, a in enumerate(got):
        if name.endswith("_acc"):
            assert torch.equal(a[empty], acc[i][empty])
        else:
            assert not a[empty].any()
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", FWD_KERNELS)
@pytest.mark.parametrize("case", list(DENSE_TILE_CASES))
def test_cuda_bf16_tri_fwd_jvp_fwd_dense_tiles(cuda, case, name):
    """K4, K4-acc and K6 (both forms) in bf16 on streams whose tiles cross
    node boundaries in every way (split destinations through both carry
    slots), with padding nodes, against their twins; masked slots poisoned
    with NaN change nothing."""
    kind, degrees = DENSE_TILE_CASES[case]
    degrees = list(degrees) + [0] * 3
    plan, lay, n_real, (x, tx, sh, tsh, w, dw, _, _), acc = _bf16_tri_operands(kind, cuda, degrees, seed=13)
    got = _bf16_fwd_check(name, *_fwd_call(name, plan, lay, x, tx, sh, tsh, w, dw, acc), lay, acc)
    poisoned = [v.clone() for v in (sh, tsh, w, dw)]
    for v in poisoned:
        v[n_real:] = float("nan")
    for a, b in zip(_fwd_call(name, plan, lay, x, tx, *poisoned, acc)[0](), got):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tri_bwd", "jvp_bwd"])
@pytest.mark.parametrize("case", list(DENSE_TILE_CASES))
def test_cuda_bf16_tri_bwd_jvp_bwd_dense_tiles(cuda, bf16_sums, case, name):
    """K5 and K7 in bf16 on every dense-tile pattern against their twins
    (each output rounded once) within two bf16 ulps of max|out|, bitwise
    equal on a repeat call, masked slots zero and unread."""
    kind, degrees = DENSE_TILE_CASES[case]
    plan, lay, n_real, ops, _ = _bf16_tri_operands(kind, cuda, degrees, seed=11)
    run, plain = _tri_call(name, plan, lay, *ops)
    before = K.KERNELS[name].launches
    got = run()
    torch.cuda.synchronize()
    assert K.KERNELS[name].launches == before + 1
    _bf16_check(got, plain())
    assert all(torch.equal(a, b) for a, b in zip(got, run()))
    for a in got:
        assert not a[n_real:].any()
    poisoned = [v.clone() for v in ops]
    for v in poisoned[2:6]:
        v[n_real:] = float("nan")
    for a, b in zip(_tri_call(name, plan, lay, *poisoned)[0](), got):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tri_fwd_acc", "jvp_fwd_acc", "tri_bwd", "jvp_bwd"])
@pytest.mark.parametrize("case", list(SLICE_STARTS))
def test_cuda_bf16_kernels_on_slices(cuda, case, name):
    """K4-acc, K6-acc, K5 and K7 in bf16 on both slices of a two-slice cut of
    the flagship's layer-1 stream (a destination split over the slices, or
    an odd first row: bf16 rows at any 2-byte phase), against their twins;
    both slices in turn onto the same float32 accumulators give the whole
    stream's sum, rounded to bf16, within two bf16 ulps of max|out|."""
    degrees = [18] * 40 + [7]
    plan, lay, n_real, ops, acc = _bf16_tri_operands("flagship1", cuda, degrees, seed=14)
    x, tx, sh, tsh, w, dw, g, gt = ops
    slices = K.edge_slices(lay, 2, [0, SLICE_STARTS[case], n_real])
    running = tuple(a.clone() for a in acc)
    for sl in slices:
        rows = slice(sl.start, sl.stop)
        s_ops = (x, tx, sh[rows], tsh[rows], w[rows], dw[rows])
        if name.endswith("_acc"):
            _bf16_fwd_check(name, *_fwd_call(name, plan, sl.layout, *s_ops, acc), sl.layout, acc)
            if name == "tri_fwd_acc":
                K.tri_fwd(plan, x, s_ops[2], s_ops[4], sl.layout, acc=running[0])
            else:
                K.jvp_fwd(plan, *s_ops, sl.layout, acc=running)
        else:
            run, plain = _tri_call(name, plan, sl.layout, *s_ops, g, gt)
            got = run()
            _bf16_check(got, plain())
            assert all(torch.equal(a, b) for a, b in zip(got, run()))
    if name.endswith("_acc"):
        whole = _fwd_call(name, plan, lay, x, tx, sh, tsh, w, dw, acc)[1]()
        _bf16_check(tuple(a.to(torch.bfloat16) for a in running), tuple(b.to(torch.bfloat16) for b in whole))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["flagship1", "odd"])
@pytest.mark.parametrize("phase", range(8))
def test_cuda_bf16_tri_bwd_every_y_phase(cuda, bf16_sums, phase, kind):
    """K5 in bf16, whose tiles are staged raw as bf16, on an fr slice whose
    y = sh[rows] starts at each 16-byte phase of bf16 values: a row is 9
    values, so a slice from row 96 + phase starts at phase (mod 8), inside a
    destination's segment.  The odd model (WN 75, dim_in 45) puts w's rows
    at other phases than dw's and its x rows off 16 bytes.  Against the
    twin within two bf16 ulps of max|out|, bitwise equal on a repeat call,
    one launch."""
    degrees = [18] * 40 + [7]
    plan, lay, n_real, (x, _, sh, _, w, _, g, _), _ = _bf16_tri_operands(kind, cuda, degrees, seed=16)
    start = 96 + phase
    assert sh.data_ptr() % 16 == 0 and start not in lay.dst_ptr.tolist()
    sl = K.edge_slices(lay, 2, [0, start, n_real])[1]
    y, ws = sh[sl.start:sl.stop], w[sl.start:sl.stop]
    assert (y.data_ptr() % 16) // 2 == phase
    before = K.KERNELS["tri_bwd"].launches
    got = K.tri_bwd(plan, x, y, ws, sl.layout, g)
    torch.cuda.synchronize()
    assert K.KERNELS["tri_bwd"].launches == before + 1
    _bf16_check(got, K.tri_bwd_plain(plan, x, y, ws, sl.layout, g))
    assert all(torch.equal(a, b) for a, b in zip(got, K.tri_bwd(plan, x, y, ws, sl.layout, g)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tri_fwd_acc", "jvp_fwd_acc"])
@pytest.mark.parametrize("kind", ["flagship1", "odd"])
@pytest.mark.parametrize("phase", range(8))
def test_cuda_bf16_tri_fwd_jvp_fwd_every_y_phase(cuda, phase, kind, name):
    """K4-acc and K6-acc in bf16, whose operand tiles are staged raw as bf16,
    on an fr slice whose y = sh[rows] (and ty) starts at each 16-byte phase
    of bf16 values, inside a destination's segment (as in
    ``test_cuda_bf16_tri_bwd_every_y_phase``; the odd model also puts w's
    rows at other phases and its x rows off 16 bytes).  Against the twin
    within two bf16 ulps of max|out|, bitwise equal on a repeat call, one
    launch, rows of nodes without an edge in the slice left as they were."""
    degrees = [18] * 40 + [7]
    plan, lay, n_real, (x, tx, sh, tsh, w, dw, _, _), acc = _bf16_tri_operands(kind, cuda, degrees, seed=17)
    start = 96 + phase
    assert sh.data_ptr() % 16 == 0 and start not in lay.dst_ptr.tolist()
    sl = K.edge_slices(lay, 2, [0, start, n_real])[1]
    rows = slice(sl.start, sl.stop)
    assert (sh[rows].data_ptr() % 16) // 2 == phase
    _bf16_fwd_check(name, *_fwd_call(name, plan, sl.layout, x, tx, sh[rows], tsh[rows], w[rows], dw[rows], acc),
                    sl.layout, acc)


@pytest.mark.cuda
@pytest.mark.parametrize("name", FWD_KERNELS)
@pytest.mark.parametrize("kind", ["odd", "preset_m1"])
def test_cuda_bf16_tri_fwd_jvp_fwd_widths(cuda, kind, name):
    """K4, K4-acc and K6 (both forms) in bf16 at odd widths (dim_in 45: x
    rows gathered by 2-byte copies; WN 75) and at preset M's layer-1 widths
    (dim_in 480, WN 768, mid_dim 2368), against their twins within two bf16
    ulps of max|out|, bitwise equal on a repeat call."""
    degrees = [18] * 40 + [7]
    plan, lay, n_real, (x, tx, sh, tsh, w, dw, _, _), acc = _bf16_tri_operands(kind, cuda, degrees, seed=18)
    _bf16_fwd_check(name, *_fwd_call(name, plan, lay, x, tx, sh, tsh, w, dw, acc), lay, acc)


@pytest.mark.cuda
def test_cuda_bf16_fused_tp_op_takes_float32_tables(cuda, bf16_sums):
    """The registered ops of the fused_tp route (a traced program's K4 and
    K5) in bf16 take float32 term tables (``acc_dtype``) and agree with the
    eager route (TriConv) within two bf16 ulps of max|out|, forward and
    backward."""
    kind, degrees = DENSE_TILE_CASES["flagship_layer1"]
    plan, lay, n_real, (x, _, sh, _, w, _, g, _), _ = _bf16_tri_operands(kind, cuda, degrees, seed=15)
    traced = K.layout_from_fields(K.layout_fields(lay))  # the real-edge count stays on the card
    outs = []
    for layout in (lay, traced):
        xx = x.clone().requires_grad_(True)
        out = K.fused_tp_scatter(plan, xx, sh, w, layout, frozen=True)
        (dx,) = torch.autograd.grad(out, xx, g)
        outs.append((out.detach(), dx))
    _bf16_check(outs[1], outs[0])


@pytest.mark.cuda
def test_cuda_bf16_model_trains_on_fused_tp_and_in_sliced_fr(cuda, bf16_sums):
    """A bf16 depth-2 model on the fused_tp route serves through K4, K5 and
    K3 only, its forces within 5e-2 of max|F| of the float32 model's; a
    bf16 rr step on each kernel route and an fr step over 3 edge slices on
    both launch K4, K5 and K3 (rr on fused_tp), K1, K2's training variant,
    the dW reduction, K3, K4 and K5 (rr on fused) or K4-acc, K5, K6, K7 and
    K3 (fr) and give float32 gradients within 0.1 of max|grad| of the
    float32 model's (the CPU tests hold the bf16 steps to the float64
    golden at that gate, which JAX's own bf16 step meets)."""
    from nequip_tpu_torch.integrations import NequIPCalculator
    from nequip_tpu_torch.model import NequIPGNNModel
    from nequip_tpu_torch.model.modify_utils import modify
    from nequip_tpu_torch.train import EnergyForceLoss, NequIPTrainModule

    cfg = dict(seed=0, model_dtype="float32", type_names=["Cu"], r_max=4.0, num_layers=2, l_max=2,
               parity=False, num_features=16, avg_num_neighbors=18.0)
    r = np.random.RandomState(3)
    a = 3.61
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]) * a
    pos = np.concatenate([base + np.array([i, j, k]) * a for i in range(3) for j in range(3) for k in range(3)])
    raw = {"pos": pos + r.normal(0, 0.1, pos.shape), "cell": np.diag([3 * a] * 3), "pbc": np.array([True] * 3),
           "atomic_numbers": np.full(len(pos), 29)}
    frame = from_dict(dict(raw, total_energy=np.array([-380.0]), forces=r.normal(0, 0.3, pos.shape)))
    from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper

    data = compute_neighborlist_(ChemicalSpeciesToAtomTypeMapper(["Cu"])(frame), 4.0)
    batch = to_tensors(pad_batch(batched_from_list([data]), 128, round_up(data["edge_index"].shape[1], 256), 2),
                       cuda)

    serving = []
    for bf16 in (False, True):
        model = NequIPGNNModel(tp_impl="fused", radial_mlp_depth=2, **cfg)
        if bf16:
            model = modify(model, [{"modifier": "enable_bf16_fast_mode"}])
        K.reset_launch_counts()
        serving.append(NequIPCalculator.from_model(model, device=cuda).calculate(raw))
    assert {k for k, fn in K.KERNELS.items() if fn.launches} == {"tri_fwd", "tri_bwd", "scatter_rows"}
    f32, f16 = (res["forces"] for res in serving)
    assert np.isfinite(f16).all() and np.abs(f16 - f32).max() <= 5e-2 * np.abs(f32).max()

    def grads(tp_impl, mode, chunks, bf16):
        model = NequIPGNNModel(tp_impl=tp_impl, **cfg)
        if bf16:
            model = modify(model, [{"modifier": "enable_bf16_fast_mode"}])
        m = NequIPTrainModule(model, loss=EnergyForceLoss(type_names=["Cu"]), force_grad_mode=mode,
                              fr_edge_chunks=chunks, device=cuda)
        m.training_step(batch)
        return {n: p.grad for n, p in model.named_parameters() if p.grad is not None}

    for tp_impl, mode, chunks in (("fused_tp", "rr", 0), ("fused", "rr", 0), ("fused", "fr", 3),
                                  ("fused_tp", "fr", 3)):
        want = grads(tp_impl, mode, chunks, False)
        K.reset_launch_counts()
        got = grads(tp_impl, mode, chunks, True)
        launched = {k for k, fn in K.KERNELS.items() if fn.launches}
        if mode == "rr" and tp_impl == "fused":
            assert launched == {"conv_fwd", "conv_bwd_train", "dw_reduce", "scatter_rows", "tri_fwd", "tri_bwd"}
        elif mode == "rr":
            assert launched == {"tri_fwd", "tri_bwd", "scatter_rows"}
        else:
            assert launched == {"tri_fwd_acc", "tri_bwd", "jvp_fwd", "jvp_bwd", "scatter_rows"}
        assert set(got) == set(want)
        for k, gr in got.items():
            assert gr.dtype == torch.float32 and bool(gr.isfinite().all()), k
            scale = float(want[k].abs().max())
            assert float((gr - want[k]).abs().max()) <= 0.1 * scale + 1e-30, k


# --- bfloat16: K1 and K7 on bf16 tiles (K1's W2 product on the tensor cores) -------
# The launch shapes of the bf16 forms, whose shared memory counts bf16 tiles:
# K1's tile (conv_fwd.cu pick_shape: 32 edges at two blocks an SM at the
# flagship's and preset M's widths, one block from 64 channels, 16- and
# 8-edge tiles wider still) and K7's (edges, stages, blocks an SM) from
# jvp_bwd.cu's ladder on an H100's 227 KB a block.
BF16_K1_TILES = {"flagship1": 32, "preset_m1": 32, "wide64": 32, "wide160": 16, "wide320": 8}
BF16_K7_SHAPES = {"small": (32, 2, 2), "wide16": (32, 1, 2), "flagship1": (32, 1, 2), "preset_m1": (16, 1, 2),
                  "wide64": (8, 1, 2), "wide160": (8, 1, 1), "wide320": (4, 1, 1)}


def _bf16_conv_fwd_args(kind, device, degrees, seed):
    """K1's bf16 arguments on the stream of ``degrees`` for ``_tile_plan(kind)``."""
    plan, (n_emb, hidden), (a0, a1) = _tile_plan(kind, device, torch.float32)
    r = np.random.RandomState(seed)
    lay, n_slots = _tile_stream(degrees, device, r)
    t = lambda *shape: torch.as_tensor(r.standard_normal(shape), dtype=torch.bfloat16, device=device)
    return (plan, t(len(degrees), plan.dim_in), t(n_slots, plan.sh_dim), t(n_slots, n_emb), t(n_emb, hidden),
            t(hidden, plan.weight_numel), a0, a1, lay)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(BF16_K1_TILES))
def test_cuda_bf16_conv_fwd_launch_shapes(cuda, bf16_sums, kind):
    """K1 in bf16 at widths that take each of its launch shapes (32-edge
    tiles at two blocks an SM and at one, 16- and 8-edge tiles, whose
    tile_mma runs one m16 tile a warp and an 8-row tile reads its rows
    again): the tile the library reports, the twin's values within two bf16
    ulps of max|out|, bitwise equal on a repeat call, one launch, rows of
    nodes without an edge zero."""
    degrees = [18] * 40 + [7] + [0] * 3
    args = _bf16_conv_fwd_args(kind, cuda, degrees, seed=26)
    plan, w1 = args[0], args[4]
    assert K.conv_fwd_tile(plan, w1.shape[0], w1.shape[1], torch.bfloat16, cuda) == BF16_K1_TILES[kind]
    before = K.KERNELS["conv_fwd"].launches
    got = K.conv_fwd(*args)
    torch.cuda.synchronize()
    assert K.KERNELS["conv_fwd"].launches == before + 1
    _bf16_check((got,), (K.conv_fwd_plain(*args),))
    assert torch.equal(got, K.conv_fwd(*args))
    assert not got[-3:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["flagship1", "preset_m1", "odd"])
def test_cuda_bf16_conv_fwd_zero_message_edges_change_nothing(cuda, bf16_sums, kind):
    """K1 in bf16 on two edge streams with the same real pairs, one of them
    with extra pairs whose messages are zero (their radial embedding is
    zero, as for pairs beyond r_max in an MD neighbour list rebuilt at
    another step) before and after each destination's pairs, so that the
    pairs fall into tiles otherwise: ``out`` bitwise equal.  A row's w does
    not depend on its place in a tile, and the sums over edges are
    compensated."""
    plan, (n_emb, hidden), (a0, a1) = _tile_plan(kind, cuda, torch.float32)
    r = np.random.RandomState(28)
    n_nodes = 41
    real = r.randint(6, 30, n_nodes)
    before_n, after_n = r.randint(0, 5, n_nodes), r.randint(0, 4, n_nodes)
    t = lambda *shape: torch.as_tensor(r.standard_normal(shape), dtype=torch.bfloat16, device=cuda)
    x, w1, w2 = t(n_nodes, plan.dim_in), t(n_emb, hidden), t(hidden, plan.weight_numel)
    n_real = int(real.sum())
    src, sh, emb = r.randint(0, n_nodes, n_real), t(n_real, plan.sh_dim), t(n_real, n_emb)

    def stream(with_extra):
        dst, srcs, rows = [], [], []  # rows: the real pair's index, or -1 for a zero-message pair
        k = 0
        for n in range(n_nodes):
            pre, post = (before_n[n], after_n[n]) if with_extra else (0, 0)
            rows += [-1] * pre + list(range(k, k + real[n])) + [-1] * post
            k += real[n]
            dst += [n] * (pre + real[n] + post)
        rows = np.asarray(rows)
        srcs = np.where(rows >= 0, src[np.maximum(rows, 0)], r.randint(0, n_nodes, rows.size))
        n_masked = 9
        mask = np.arange(rows.size + n_masked) < rows.size
        ei = np.stack([np.concatenate([dst, r.randint(0, n_nodes, n_masked)]),
                       np.concatenate([srcs, r.randint(0, n_nodes, n_masked)])])
        lay = K.relayout_edge_stream({
            _keys.POSITIONS_KEY: torch.zeros(n_nodes, 3, device=cuda),
            _keys.EDGE_INDEX_KEY: torch.as_tensor(ei, device=cuda),
            _keys.EDGE_MASK_KEY: torch.as_tensor(mask, device=cuda),
        })[K.LAYOUT_KEY]
        assert lay.n_real == rows.size
        pad = np.concatenate([rows, np.full(n_masked, -1)])
        take = torch.as_tensor(np.maximum(pad, 0), device=cuda)
        on = torch.as_tensor(pad >= 0, device=cuda)[:, None]
        e_sh = torch.where(on, sh[take], t(pad.size, plan.sh_dim))  # zero-message pairs keep their own SH
        e_emb = torch.where(on, emb[take], torch.zeros_like(emb[take]))
        return lay, e_sh, e_emb

    outs = []
    for with_extra in (False, True):
        lay, e_sh, e_emb = stream(with_extra)
        args = (plan, x, e_sh, e_emb, w1, w2, a0, a1, lay)
        got = K.conv_fwd(*args)
        _bf16_check((got,), (K.conv_fwd_plain(*args),))
        outs.append(got)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(BF16_K7_SHAPES))
def test_cuda_bf16_jvp_bwd_launch_shapes(cuda, bf16_sums, kind):
    """K7 in bf16, on bf16 tiles, at widths that take each of its launch
    shapes (32-edge tiles double- and single-buffered, 16-, 8- and 4-edge
    tiles, two blocks an SM or one): the twin's values within two bf16 ulps
    of max|out|, bitwise equal on a repeat call, one launch, masked slots
    zero."""
    plan, lay, n_real, ops, _ = _bf16_tri_operands(kind, cuda, [18] * 40 + [7], seed=27)
    run, plain = _tri_call("jvp_bwd", plan, lay, *ops)
    before = K.KERNELS["jvp_bwd"].launches
    got = run()
    torch.cuda.synchronize()
    assert K.KERNELS["jvp_bwd"].launches == before + 1
    _bf16_check(got, plain())
    assert all(torch.equal(a, b) for a, b in zip(got, run()))
    for a in got:
        assert not a[n_real:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["flagship1", "odd"])
@pytest.mark.parametrize("phase", range(8))
def test_cuda_bf16_jvp_bwd_every_y_phase(cuda, bf16_sums, phase, kind):
    """K7 in bf16, whose six operand tiles are staged raw as bf16, on an fr
    slice whose y = sh[rows] and ty start at each 16-byte phase of bf16
    values (odd phases among them), inside a destination's segment; the odd
    model (WN 75, dim_in 45) also puts w's and dw's rows at other phases
    and its x and tx rows off 16 bytes.  Against the twin within two bf16
    ulps of max|out|, bitwise equal on a repeat call, one launch."""
    plan, lay, n_real, (x, tx, sh, tsh, w, dw, g, gt), _ = _bf16_tri_operands(kind, cuda, [18] * 40 + [7], seed=29)
    start = 96 + phase
    assert sh.data_ptr() % 16 == 0 and start not in lay.dst_ptr.tolist()
    sl = K.edge_slices(lay, 2, [0, start, n_real])[1]
    rows = slice(sl.start, sl.stop)
    assert (sh[rows].data_ptr() % 16) // 2 == phase and (tsh[rows].data_ptr() % 16) // 2 == phase
    run, plain = _tri_call("jvp_bwd", plan, sl.layout, x, tx, sh[rows], tsh[rows], w[rows], dw[rows], g, gt)
    before = K.KERNELS["jvp_bwd"].launches
    got = run()
    torch.cuda.synchronize()
    assert K.KERNELS["jvp_bwd"].launches == before + 1
    _bf16_check(got, plain())
    assert all(torch.equal(a, b) for a, b in zip(got, run()))


# loads the ops library in a process where importing nequip_tpu_torch raises,
# runs each case's op on the card and prints the cases whose outputs are not
# bitwise the package's
_LIBRARY_RUNNER = """
import json, sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name == "nequip_tpu_torch" or name.startswith("nequip_tpu_torch."):
            raise ImportError(name + " is blocked")
        return None

sys.meta_path.insert(0, _Block())
import torch

torch.ops.load_library(sys.argv[1])
differ = []
for case in torch.load(sys.argv[2]):
    args = []
    for a in case["args"]:
        if isinstance(a, dict):  # a view `offset` values into a flat buffer
            flat = a["flat"].cuda()
            a = flat[a["offset"]:a["offset"] + a["numel"]].view(a["shape"])
        elif isinstance(a, torch.Tensor):
            a = a.cuda()
        args.append(a)
    got = getattr(torch.ops.nequip_torch, case["op"])(*args)
    got = got if isinstance(got, (tuple, list)) else (got,)
    for i, (g, w) in enumerate(zip(got, case["want"], strict=True)):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g.cpu(), w):
            differ.append(case["name"] + f"[{i}]")
torch.cuda.synchronize()
print(json.dumps(differ))
"""


def _library_cases(device, dtype):
    """The five registered ops through the package on the card, at the
    flagship's layer 1, preset M's layer 1 (dim_in 480) and the odd model
    (dim_in 45, WN 75), on a stream with masked slots, and K3 at D 32, 36,
    288 and 480 with D = 36 also as a view 2 bytes off 16-byte alignment;
    each case's arguments and the package's outputs, on the CPU."""
    cpu = lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t
    cases = []

    def call(name, op, args, views=()):
        want = getattr(torch.ops.nequip_torch, op)(*args)
        want = want if isinstance(want, tuple) else (want,)
        args = [views[i] if i in views else cpu(a) for i, a in enumerate(args)]
        cases.append({"name": name, "op": op, "args": args, "want": [cpu(w) for w in want]})

    for kind in ("flagship1", "preset_m1", "odd"):
        plan, (n_emb, hidden), (a0, a1) = _tile_plan(kind, device, torch.float64 if dtype == torch.float64
                                                     else torch.float32)
        r = np.random.RandomState(11)
        lay, n_slots = _tile_stream([18] * 40 + [7, 0, 3], device, r)
        t = lambda *shape: torch.as_tensor(r.standard_normal(shape), dtype=dtype, device=device)
        x, sh, emb, w1, w2 = (t(43, plan.dim_in), t(n_slots, plan.sh_dim), t(n_slots, n_emb), t(n_emb, hidden),
                              t(hidden, plan.weight_numel))
        w, g = t(n_slots, plan.weight_numel), t(43, plan.mid_dim)
        tables = list(plan.device_tables(device, K.acc_dtype(dtype)).values())
        full = (lay.edge_src, lay.dst_ptr, lay.src_perm, lay.src_ptr)
        call(f"conv_fwd {kind}", "conv_fwd", [x, sh, emb, w1, w2, *full, *tables, a0, a1])
        call(f"conv_bwd {kind}", "conv_bwd", [x, sh, emb, w1, w2, g, *full[:2], *tables, a0, a1])
        call(f"tri_fwd {kind}", "tri_fwd", [x, sh, w, *full, *tables])
        call(f"tri_bwd {kind}", "tri_bwd", [x, sh, w, g, *full[:2], *tables])
    for d, offset in ((32, 0), (36, 0), (36, 1), (288, 0), (480, 0)):
        r = np.random.RandomState(d)
        deg = r.randint(0, 25, 200)
        m = int(deg.sum()) + 37
        ptr = torch.as_tensor(np.concatenate([[0], np.cumsum(deg)]), dtype=torch.int32, device=device)
        perm = torch.as_tensor(r.permutation(m)[: int(deg.sum())], dtype=torch.int32, device=device)
        flat = torch.as_tensor(r.standard_normal(m * d + offset), dtype=dtype, device=device)
        v = flat[offset:].view(m, d)
        assert (v.data_ptr() % 16 == 0) == (offset == 0)
        call(f"scatter_rows D={d} offset={offset}", "scatter_rows", [v, perm, ptr],
             views={0: {"flat": cpu(flat), "offset": offset, "numel": m * d, "shape": [m, d]}})
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64], ids=["bf16", "f32", "f64"])
def test_cuda_ops_library_matches_the_package_bitwise(cuda, dtype, tmp_path):
    """The ops library (``csrc/torch_ops.cpp`` with K1-K5, which compiled
    artifacts carry), loaded in a process that cannot import the package,
    gives outputs bitwise the package's registered ops' on the same inputs:
    the two launch paths make the same tile queries, carry rows, zeroing
    and bf16 K3 geometry (misaligned D = 36 views among them)."""
    import json
    import subprocess
    import sys

    from nequip_tpu_torch.ops.kernels import build

    cases = _library_cases(cuda, dtype)
    path = tmp_path / "cases.pt"
    torch.save(cases, path)
    proc = subprocess.run([sys.executable, "-c", _LIBRARY_RUNNER, str(build.ops_library()), str(path)],
                          capture_output=True, text=True, timeout=600, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.splitlines()[-1]) == [], proc.stdout
