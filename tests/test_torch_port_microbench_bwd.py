"""The host side of T2/T4's grid of (step range, edge tile) blocks
(``ops/kernels/microbench.py``), on the CPU: the map of blocks to tiles and
steps, the step ranges, the shared memory a block takes, the C entry
points' arity, and a numpy model of the CG-VJP that the kernel runs from
TPPlan's tables on one resident tile, step after step, against the JAX
package's VJP (f64, 1e-12 of max)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nequip_tpu.ops import Irreps as JIrreps
from nequip_tpu.ops import TensorProduct as JTP
from nequip_tpu.ops import uvu_instructions as j_uvu
from nequip_tpu_torch.ops.kernels import build
from nequip_tpu_torch.ops.kernels import microbench as MB
from nequip_tpu_torch.tools import kernel_microbench as KM

CU = Path(MB.__file__).resolve().parents[2] / "csrc" / "microbench_bwd.cu"
SMEM_PER_SM = 233472  # bytes of shared memory an H100 SM holds for resident blocks (228 KB)
RESERVED = 1024  # bytes the runtime reserves beside each block


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def plan():
    return KM.make_inputs(8, 16)[0]


def _kernel_blocks(be, grid, n_ranges):
    """csrc/microbench_bwd.cu's map of block b to (tile, first step, end
    step, writes the results): tile b % n_tiles, steps [r grid / n_ranges,
    (r + 1) grid / n_ranges) of range r = b // n_tiles; the last range's
    blocks write."""
    n_tiles = -(-be // MB.BWD_TILE)
    return [(b % n_tiles, r * grid // n_ranges, (r + 1) * grid // n_ranges, r == n_ranges - 1)
            for b in range(n_tiles * n_ranges) for r in (b // n_tiles,)]


@pytest.mark.parametrize("be,grid,slots", [(256, 2048, 264), (256, 4, 132), (264, 7, 264), (8, 1, 264),
                                           (16, 3, 5), (512, 2048, 396), (40, 100, 1)])
def test_blocks_cover_every_step_of_every_tile_once(be, grid, slots):
    n_ranges = MB.bwd_ranges(be, grid, slots)
    n_tiles = -(-be // MB.BWD_TILE)
    assert 1 <= n_ranges <= grid and (n_ranges == 1 or n_ranges * n_tiles <= slots)
    blocks = _kernel_blocks(be, grid, n_ranges)
    assert len(blocks) == n_tiles * n_ranges
    for tile in range(n_tiles):
        mine = [(s0, s1, owner) for t, s0, s1, owner in blocks if t == tile]
        steps = [s for s0, s1, _ in mine for s in range(s0, s1)]
        assert sorted(steps) == list(range(grid))  # every step once
        assert all(s1 > s0 for s0, s1, _ in mine)  # no range is empty
        owners = [(s0, s1) for s0, s1, owner in mine if owner]
        assert len(owners) == 1 and owners[0][1] == grid  # one block writes, and it ran the last step


def test_ranges_fill_the_card_at_the_tools_defaults():
    # 32 tiles of 8 edges on 132 SMs x 3 blocks: 12 ranges of 170-171 steps, 384 of the 396 slots
    assert MB.bwd_ranges(256, 2048, 396) == 12
    assert MB.bwd_ranges(256, 4, 132) == 4  # f64 at G = 4, one block an SM
    assert MB.bwd_ranges(256, 2048, 16) == 1  # fewer slots than tiles: one range, tiles in waves


@pytest.mark.parametrize("itemsize", [4, 8])
def test_shared_memory_holds_the_tile_and_fits_a_block(plan, itemsize):
    t, V = MB.BWD_TILE, 16 // itemsize
    widths = dict(x=plan.dim_in, g=plan.mid_dim, w=plan.weight_numel, w_copy=plan.weight_numel, y=plan.sh_dim,
                  dx=plan.dim_in, dy=plan.sh_dim, partials=2 * len(plan.paths) * 9)
    raw = itemsize * t * sum(widths.values()) + 4 * (t + len(plan.paths))
    smem = MB.bwd_smem(plan, itemsize)
    assert raw <= smem <= raw + len(widths) * 2 * 16  # alignment and 16-byte phase room only
    assert smem <= MB.SMEM_LIMIT


@pytest.mark.parametrize("itemsize", [4, 8])
def test_shared_memory_at_the_tools_widths(itemsize):
    """be = 256 at the tool's widths: within a block's 227 KB in f32 and
    f64, with room for the resident blocks an SM the kernel's registers are
    sized for (kBwdMinBlocks: three in f32, one in f64)."""
    f32, f64 = re.search(r"kBwdMinBlocks = sizeof\(T\) == 4 \? (\d+) : (\d+);", CU.read_text()).groups()
    blocks = int(f32 if itemsize == 4 else f64)
    plan = KM.make_inputs(128, 256)[0]
    smem = MB.bwd_smem(plan, itemsize)
    assert smem <= MB.SMEM_LIMIT
    assert blocks * (smem + RESERVED) <= SMEM_PER_SM


@pytest.mark.parametrize("layout", ["r", "t"])
def test_edges_not_a_multiple_of_8_raise(plan, layout):
    _, a = KM.make_inputs(8, 16)
    ops = KM.to_tensors(a, "cpu", torch.float64)
    sfx = "_t" if layout == "t" else ""
    cut = {n + sfx: (ops[n + sfx][:, :12] if layout == "t" else ops[n + sfx][:12]) for n in ("x", "y", "g", "w")}
    with pytest.raises(ValueError, match="multiple of 8"):
        MB.chunk_bwd(plan, cut, 2, layout)
    with pytest.raises(ValueError, match="grid >= 1"):
        MB.chunk_bwd(plan, ops, 0, layout)


def test_entry_points_and_tile_match_the_kernel():
    src = CU.read_text()
    assert int(re.search(r"constexpr int kBwdTile = (\d+);", src).group(1)) == MB.BWD_TILE
    assert int(re.search(r"constexpr int kMaxYDim = (\d+);", (CU.parent / "tp_common.cuh").read_text()).group(1)) == 9

    def arity(name):
        params = re.search(rf"extern \"C\" int {name}_##SUFFIX\(([^)]*)\)", src).group(1)
        return len([p for p in params.replace("\\", " ").split(",") if p.strip()])

    assert arity("nequip_mb_bwd") == len(build._SIGNATURES["nequip_mb_bwd"])
    assert arity("nequip_mb_bwd_blocks") == len(build._SIGNATURES["nequip_mb_bwd_blocks"])


def _kernel_model(plan, x, y, g, w, steps=2):
    """The kernel's arithmetic from TPPlan's tables, tile by tile: dx over
    the dx groups' terms; per path and m2 run the sum A of c x g, folded
    into dW_e and the dy partials; dy as the partials summed in path order.
    Each step starts from the kept w rows and overwrites the last step's
    results, as the kernel's resident tile does."""
    t = plan._tables
    be = x.shape[0]
    dx, dy, dw = np.zeros_like(x), np.zeros_like(y), np.zeros_like(w)
    for base in range(0, be, MB.BWD_TILE):
        e = slice(base, min(be, base + MB.BWD_TILE))
        xe, ye, ge, w_kept = x[e], y[e], g[e], w[e].copy()
        for _ in range(steps):
            we = w_kept.copy()  # the working copy, restored every step
            sdx = np.zeros_like(xe)
            for gi, (x_row, _, t0, t1) in enumerate(t["dx_groups"]):
                cols = np.nonzero(t["dx_col"] == gi)[0]  # one input row's columns
                u = cols - x_row
                for k in range(t0, t1):
                    out_row, yi, wo = t["dx_terms"][k]
                    sdx[:, cols] += t["dx_coef"][k] * ye[:, yi, None] * ge[:, out_row + u] * we[:, wo + u]
            part = np.zeros((xe.shape[0], len(plan.paths), 9))
            for p, (w_off, mul, y_off, y_dim, t0, t1) in enumerate(t["paths"]):
                u = np.arange(mul)
                dwp = np.zeros((xe.shape[0], mul))
                for m in range(y_dim):
                    run = [k for k in range(t0, t1) if t["path_terms"][k, 2] == m]
                    if not run:
                        continue
                    am = sum(t["path_coef"][k] * xe[:, t["path_terms"][k, 0] + u] * ge[:, t["path_terms"][k, 1] + u]
                             for k in run)
                    dwp += ye[:, y_off + m, None] * am
                    part[:, p, m] += (we[:, w_off + u] * am).sum(axis=1)
                we[:, w_off + u] = dwp  # dW_e over the working copy
            sdy = np.zeros_like(ye)
            for p, (_, _, y_off, y_dim, _, _) in enumerate(t["paths"]):
                sdy[:, y_off:y_off + y_dim] += part[:, p, :y_dim]
            dx[e], dy[e], dw[e] = sdx, sdy, we
    return dx, dy, dw


def test_tables_on_a_resident_tile_reproduce_the_jax_vjp(plan):
    rng = np.random.RandomState(4)
    be = 12  # one whole tile and a part of one (the kernel masks it)
    x, y, w, g = (rng.standard_normal((be, n)) for n in (plan.dim_in, plan.sh_dim, plan.weight_numel, plan.mid_dim))
    feats, sh = JIrreps("32x0e+32x1e+32x2e"), JIrreps.spherical_harmonics(2)
    jtp = JTP(feats, sh, *j_uvu(feats, sh, feats), shared_weights=False)
    vjp = jax.jit(lambda x, y, w, g: jax.vjp(jtp, x, y, w)[1](g))
    for got, ref in zip(_kernel_model(plan, x, y, g, w), vjp(*(jnp.asarray(a) for a in (x, y, w, g)))):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max())
