"""The host side of T1/T3's column-split grid (``ops/kernels/microbench.py``):
the column groups, their shared-memory carve-up and the int32 table the
kernel reads, on the CPU.  The tables are checked by a numpy model of the
kernel's CG product, which must give the tensor product of the JAX package
(f64, 1e-12 of max)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nequip_tpu.ops import Irreps as JIrreps
from nequip_tpu.ops import TensorProduct as JTP
from nequip_tpu.ops import uvu_instructions as j_uvu
from nequip_tpu_torch.ops.kernels import microbench as MB
from nequip_tpu_torch.tools import kernel_microbench as KM

CU = Path(MB.__file__).resolve().parents[2] / "csrc" / "microbench_fwd.cu"
VARIANTS = MB.FWD_VARIANTS + MB.FWD_T_VARIANTS
CASES = [(v, s, tf) for v in VARIANTS for s in (4, 8) for tf in (False, True) if not tf or (s == 4 and v in MB.MLP_VARIANTS)]
IDS = [f"{v}-f{8 * s}{'-tf32' if tf else ''}" for v, s, tf in CASES]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def plan():
    return KM.make_inputs(8, 16)[0]


@pytest.mark.parametrize("variant,itemsize,tf32", CASES, ids=IDS)
def test_every_output_column_lies_in_one_group(plan, variant, itemsize, tf32):
    fg = MB.fwd_groups(plan, variant, 128, itemsize, tf32)
    assert sorted(p for g in fg.groups for p in g) == list(range(len(plan.paths)))
    cols = [c for g in fg.cols for c in g]
    assert sorted(cols) == list(range(plan.mid_dim))
    if variant not in ("mlp", "xpose"):
        assert all(len(c) <= 256 for c in fg.cols)  # one column a thread
    assert fg.tile == MB.TILE[itemsize]


@pytest.mark.parametrize("variant,itemsize,tf32", CASES, ids=IDS)
def test_group_w_columns_are_their_paths_w_ranges(plan, variant, itemsize, tf32):
    fg = MB.fwd_groups(plan, variant, 128, itemsize, tf32)
    for g, cols, wcols in zip(fg.groups, fg.cols, fg.wcols):
        want_w = [c for p in g for c in range(plan.paths[p]["w_off"], plan.paths[p]["w_off"] + plan.paths[p]["mul"])]
        want_o = [c for p in g for c in range(plan.paths[p]["out_off"],
                                               plan.paths[p]["out_off"] + plan.paths[p]["mul"] * plan.paths[p]["dim3"])]
        assert list(wcols) == want_w and list(cols) == want_o
    assert sorted(c for w in fg.wcols for c in w) == list(range(plan.weight_numel))


@pytest.mark.parametrize("variant,itemsize,tf32", CASES, ids=IDS)
def test_shared_memory_fits_a_block_at_128_rows(plan, variant, itemsize, tf32):
    fg = MB.fwd_groups(plan, variant, 128, itemsize, tf32)
    assert fg.smem == max(fg.group_smem) <= MB.SMEM_LIMIT == 227 * 1024
    for reg, total in zip(fg.regions, fg.group_smem):
        assert set(reg) == set(MB.REGIONS)
        assert all(off % 16 == 0 and 0 <= off <= total for off in reg.values())
    if variant in MB.SCATTER_VARIANTS:  # the slice itself is rows x cols
        assert all(b >= 128 * len(c) * itemsize for b, c in zip(fg.group_smem, fg.cols))


@pytest.mark.parametrize("variant", ["dot", "full", "full_t", "full_t_pre"])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_too_many_rows_raise_with_the_limit(plan, variant, itemsize):
    with pytest.raises(ValueError, match=r"at most rows=(\d+)") as info:
        MB.fwd_groups(plan, variant, 4096, itemsize)
    most = int(re.search(r"at most rows=(\d+)", str(info.value)).group(1))
    assert 128 <= most < 4096
    assert MB.fwd_groups(plan, variant, most, itemsize).smem <= MB.SMEM_LIMIT
    with pytest.raises(ValueError, match="does not fit"):
        MB.fwd_groups(plan, variant, most + 1, itemsize)


def test_row0_variants_take_any_rows(plan):
    for variant in ("mlp", "cg", "xpose", "cg_t"):
        assert MB.fwd_groups(plan, variant, 4096, 4).smem <= MB.SMEM_LIMIT


def test_table_names_match_the_kernel():
    src = CU.read_text()

    def enum(name, prefix):
        body = re.search(rf"enum {name} : int \{{([^}}]*)\}}", src).group(1)
        names = [n.strip() for n in body.split(",")]
        assert names[-1] == f"{prefix}count"
        return tuple(n[len(prefix):] for n in names[:-1])

    assert enum("Head", "h_") == MB.HEAD
    assert enum("GInfo", "g_") == MB.GINFO
    assert re.search(r"std::is_same<T, float>::value \? (\d+) : (\d+);", src).groups() == (
        str(MB.TILE[4]), str(MB.TILE[8]))


def _kernel_model(plan, variant, fg, x, y, w):
    """The kernel's per-edge messages [be, mid_dim] from its tables: each
    group's columns from its staged x chunks, local terms and w columns."""
    itab, coef = MB.fwd_tables(plan, variant, fg, 8)
    head = dict(zip(MB.HEAD, itab[: len(MB.HEAD)]))
    out = np.zeros((x.shape[0], plan.mid_dim))
    for g in range(head["n_groups"]):
        gi = dict(zip(MB.GINFO, itab[head["ginfo"] + len(MB.GINFO) * g:][: len(MB.GINFO)]))
        segs = itab[head["xsegs"] + 2 * gi["xseg_base"]:][: 2 * gi["n_xseg"]].reshape(-1, 2)
        xg = np.concatenate([x[:, off:off + width] for off, width in segs], axis=1)
        assert xg.shape[1] == gi["xw"]
        gtab = itab[head["gtab"]:].reshape(-1)[4 * gi["gtab_base"]:]
        terms = itab[head["terms"] + 2 * gi["term_base"]:][: 2 * gi["n_terms"]].reshape(-1, 2)
        c = coef[gi["term_base"]:][: gi["n_terms"]]
        wcols = itab[head["wcols"] + gi["w_base"]:][: gi["n_w"]]
        for i in range(gi["n_cols"]):
            row = gtab[4 * itab[head["gcol"] + gi["col_base"] + i]:][:4]
            u = i - row[0]
            m = sum(c[k] * y[:, terms[k, 1]] * xg[:, terms[k, 0] + u] for k in range(row[2], row[3]))
            out[:, itab[head["gout"] + gi["col_base"] + i]] = w[:, wcols[row[1] + u]] * m
    return out


@pytest.mark.parametrize("variant,itemsize,tf32", [c for c in CASES if c[0] in MB.CG_VARIANTS],
                         ids=[i for c, i in zip(CASES, IDS) if c[0] in MB.CG_VARIANTS])
def test_tables_reproduce_the_jax_tensor_product(plan, variant, itemsize, tf32):
    rng = np.random.RandomState(3)
    be = 5
    x, y, w = (rng.standard_normal((be, n)) for n in (plan.dim_in, plan.sh_dim, plan.weight_numel))
    feats, sh = JIrreps("32x0e+32x1e+32x2e"), JIrreps.spherical_harmonics(2)
    jtp = JTP(feats, sh, *j_uvu(feats, sh, feats), shared_weights=False)
    ref = np.asarray(jtp(*(jnp.asarray(a) for a in (x, y, w))))
    got = _kernel_model(plan, variant, MB.fwd_groups(plan, variant, 8, itemsize, tf32), x, y, w)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max())


def test_table_header_and_row0_columns(plan):
    for variant, n_cols, rows_p in (("full", plan.mid_dim, 8), ("dot", plan.mid_dim, 8), ("cg", plan.mid_dim, 1),
                                    ("mlp", plan.weight_numel, 1), ("cg_t", 1, 1), ("xpose", 1, 1)):
        fg = MB.fwd_groups(plan, variant, 8)
        itab, _ = MB.fwd_tables(plan, variant, fg, 8)
        head = dict(zip(MB.HEAD, itab[: len(MB.HEAD)]))
        assert (head["n_cols_out"], head["rows_p"], head["n_groups"]) == (n_cols, rows_p, len(fg.groups))
        assert head["ginfo"] == len(MB.HEAD) and itab.dtype == np.int32
    xpose = MB.fwd_groups(plan, "xpose", 8)
    assert xpose.xsegs == (((0, plan.dim_in),),)  # the whole x row is transposed
