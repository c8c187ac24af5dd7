"""The conv-block microbenchmark kernels: one constant chunk of edges, G steps.

Counterpart of the TPU kernels of ``tools/kernel_microbench.py`` (closures
of that tool's ``main``): T1 ``make`` and T3 ``make_t`` are
``chunk_fwd`` (``csrc/microbench_fwd.cu``), T2 ``make_bwd`` and T4
``make_bwd_t`` are ``chunk_bwd`` (``csrc/microbench_bwd.cu``).  Each grid
step computes one block of the fused conv on the same chunk of ``be``
edges, so the time per step is the block's compute time per chunk.

The operands are a dict with the names of
``nequip_tpu_torch.tools.kernel_microbench.make_inputs``: row layout ``x
[be, dim_in]``, ``y [be, sh_dim]``, ``emb [be, n_emb]``, ``rel [be]`` int32
(each edge's output row, in ``[0, rows)``), ``w1 [n_emb, H]``, ``w2 [H,
WN]``, ``g [be, mid_dim]``, ``w [be, WN]``; feature-major ``x_t``, ``y_t``,
``w1_t [H, n_emb]``, ``w2_t [WN, H]``, ``g_t [mid_dim, be]``, ``w_t [WN,
be]``.  Each variant reads the operands of the TPU kernel it replaces.

Precision ``"HIGHEST"`` is full f32 (or f64) arithmetic; ``"DEFAULT"`` runs
the radial MLP's two products in TF32 on the card's tensor cores (f32
accumulation).  The scatter and the CG product are f32 at both.  On the
CPU there is no TF32 and ``"DEFAULT"`` is f32, as JAX's CPU default is.

On the card T1/T3 split the block's output columns into groups of whole
uvu paths (``fwd_groups``): a block of the grid takes one group and a
range of steps, keeps its group's slice ``out[:, cols]`` in shared memory
and runs the MLP's second product only for its group's radial-weight
columns; the ranges' slices are summed in order by a second launch.
T2/T4 split the chunk into ``BWD_TILE``-edge tiles instead: a block takes
one tile and one of ``bwd_ranges`` ranges of steps, stages the tile once,
keeps each step's results in shared memory and, if its range holds the
last step, writes them out once (``bwd_smem`` bytes a block).

Each wrapper runs its plain PyTorch twin when the operands lie on the CPU,
launches its kernel when they lie on a CUDA device, and raises otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

import torch
import torch.nn.functional as F

from . import build
from .tp_scatter import KERNELS, TPPlan, _route

FWD_VARIANTS = ("dot", "mlp", "cg", "full")  # T1, row layout
FWD_T_VARIANTS = ("xpose", "cg_t", "full_t", "full_t_pre")  # T3, feature-major layout
PRECISIONS = ("HIGHEST", "DEFAULT")
MLP_VARIANTS = ("mlp", "full", "full_t", "full_t_pre")
_VARIANT_ID = {v: i for i, v in enumerate(FWD_VARIANTS + FWD_T_VARIANTS)}  # enum Variant of the .cu
# kernel argument slot -> operand, per variant (names ending in "_t" are feature-major)
_SLOTS: Dict[str, Dict[str, str]] = {
    "dot": dict(x="x", rel="rel"),
    "mlp": dict(emb="emb", w1="w1", w2="w2"),
    "cg": dict(x="x", y="y"),
    "full": dict(x="x", y="y", emb="emb", rel="rel", w1="w1", w2="w2"),
    "xpose": dict(x="x"),
    "cg_t": dict(x="x_t", y="y_t", w_in="w_t"),
    "full_t": dict(x="x", y="y", emb="emb", rel="rel", w1="w1_t", w2="w2_t"),
    "full_t_pre": dict(x="x_t", y="y_t", emb="emb", rel="rel", w1="w1_t", w2="w2_t"),
}
SCATTER_VARIANTS = ("dot", "full", "full_t", "full_t_pre")  # the block is summed into out's rows
CG_VARIANTS = ("cg", "full", "cg_t", "full_t", "full_t_pre")
SMEM_LIMIT = 232448  # bytes of shared memory a block may take on an H100 (227 KB)
TILE = {4: 32, 8: 8}  # edges a tile by itemsize: the tiles csrc/microbench_fwd.cu instantiates
BWD_TILE = 8  # edges a tile of T2/T4 (csrc/microbench_bwd.cu's kBwdTile), f32 and f64
_THREADS = 256  # threads a block; a group holds at most this many columns where each owns one
_RING = 3 * 16 * 512  # bytes of K1's W2 ring (radial_mlp.cuh: 3 stages x 16 rows x 32 lanes x 16 bytes)
# int32 table header and per-group record of csrc/microbench_fwd.cu (enum Head, enum GInfo)
HEAD = ("n_groups", "ginfo", "gtab", "gcol", "gout", "terms", "wcols", "xsegs", "ldh", "ldw1", "ldb", "rows_p",
        "n_cols_out")
REGIONS = ("slice", "blk", "row0", "w", "h", "w2", "w1", "emb", "x", "y", "cy", "x0", "rel")
GINFO = ("n_cols", "col_base", "gtab_base", "n_w", "w_base", "term_base", "n_terms", "xseg_base", "n_xseg",
         "xw") + REGIONS


def _ru(a: int, b: int) -> int:
    return -(-a // b) * b


@dataclass(frozen=True)
class FwdGroups:
    """How T1/T3 split one variant's block over the grid's second axis.

    ``groups`` holds each group's uvu paths; ``cols`` and ``wcols`` its
    output and radial-weight columns (the paths' ``out_off`` and ``w_off``
    ranges, in path order); ``regions`` each group's shared-memory carve-up
    (byte offsets of ``REGIONS``) and ``smem`` the largest of them."""

    tile: int
    groups: Tuple[Tuple[int, ...], ...]
    cols: Tuple[Tuple[int, ...], ...]
    wcols: Tuple[Tuple[int, ...], ...]
    xsegs: Tuple[Tuple[Tuple[int, int], ...], ...]  # (x offset, width) of the x chunks a group stages
    regions: Tuple[Dict[str, int], ...]
    group_smem: Tuple[int, ...]
    smem: int
    strides: Dict[str, int]

    def describe(self) -> str:
        return "; ".join(f"paths {list(g)}: {len(c)} cols, {len(w)} w cols, {b / 1024:.1f} KB"
                         for g, c, w, b in zip(self.groups, self.cols, self.wcols, self.group_smem))


def _strides(itemsize: int, tf32: bool, n_emb: int, hidden: int) -> Dict[str, int]:
    """Row strides (elements) of the MLP's tiles: h, the W1 copy, W2^T (TF32),
    each TF32 one 4 past a multiple of 32 so the fragment loads hit 32 banks."""
    V = 16 // itemsize
    return dict(ldh=_ru(hidden, 32) + 4 if tf32 else _ru(hidden, 16),
                ldw1=n_emb + 4 if tf32 else _ru(hidden, V), ldb=_ru(hidden, 32) + 4)


def _regions(variant: str, rows: int, itemsize: int, tf32: bool, tile: int, st: Dict[str, int], sh_dim: int,
             n_emb: int, hidden: int, n_cols: int, n_w: int, xw: int, n_terms: int) -> Tuple[Dict[str, int], int]:
    """Byte offsets of one group's shared-memory regions (16-byte aligned) and
    their total, as the kernel reads them."""
    ldt = tile + 1  # feature-major tiles: [features][tile + 1], conflict-free columns
    fm = variant in FWD_T_VARIANTS
    mlp, cg, scatter = variant in MLP_VARIANTS, variant in CG_VARIANTS, variant in SCATTER_VARIANTS
    elems = dict(
        slice=rows * n_cols if scatter else 0,
        blk={"cg": tile * n_cols, "cg_t": n_cols * ldt}.get(variant, 0),
        row0=0 if scatter else n_w if variant == "mlp" else n_cols,
        w=(n_w * ldt if fm else tile * n_w) if mlp or variant == "cg_t" else 0,
        h=tile * st["ldh"] if mlp else 0,
        w2=(n_w * st["ldb"] if tf32 else _RING // itemsize) if mlp else 0,
        w1=(hidden * st["ldw1"] if tf32 else n_emb * st["ldw1"]) if mlp else 0,
        emb=tile * (n_emb + 4 if tf32 else n_emb) if mlp else 0,
        x=(xw * ldt if fm else tile * xw) if variant not in ("dot", "mlp") else 0,
        y=(sh_dim * ldt if fm else tile * sh_dim) if cg else 0,
        cy=n_terms * tile if cg else 0,
        x0=tile if variant in ("dot", "cg") else 0,
    )
    shared_cy = mlp and elems["cy"] <= elems["h"]  # c * y in h's room: h is dead once w is computed
    off, o = {}, 0
    for name in REGIONS[:-1]:
        if name == "cy" and shared_cy:
            off[name] = off["h"]
            continue
        off[name] = o
        o += _ru(elems[name] * itemsize, 16)
    off["rel"] = o  # int32 [2][2 tile + 1]: two buffers of a tile's row order (perm, rows, ends)
    o += 4 * 2 * (2 * tile + 1) if scatter else 0
    return off, o


def fwd_groups(plan: TPPlan, variant: str, rows: int, itemsize: int = 4, tf32: bool = False, n_emb: int = 8,
               hidden: int = 128) -> FwdGroups:
    """The column groups of ``chunk_fwd`` for ``variant``: the plan's uvu
    paths packed first-fit by decreasing width into groups whose block fits
    ``SMEM_LIMIT`` (every output column in one group, every path whole).
    Groups of the variants with a CG product or a scatter hold at most 256
    columns (one a thread); ``mlp`` and ``xpose`` take one group.  Raises
    where one path's slice does not fit, with the largest ``rows`` that do."""
    if variant not in _SLOTS:
        raise ValueError(f"variant {variant!r}: one of {tuple(_SLOTS)}")
    if itemsize not in TILE:
        raise TypeError(f"itemsize {itemsize}: T1/T3 take f32 (4) or f64 (8)")
    if any(p["mul"] % 16 for p in plan.paths) or hidden % 16 or n_emb % 8:
        raise ValueError("T1/T3 take uvu paths of a multiple of 16 channels, hidden % 16 == 0, n_emb % 8 == 0")
    tile = TILE[itemsize]
    st = _strides(itemsize, tf32, n_emb, hidden)
    ins1 = plan.tp.irreps_in1
    x_width = [mi.dim for mi in ins1]
    x_off = [sl.start for sl in ins1.slices()]
    width = [p["mul"] * p["dim3"] for p in plan.paths]

    def stats(paths):
        chunks = sorted({plan.paths[p]["x_chunk"] for p in paths})
        segs = ((0, plan.dim_in),) if variant == "xpose" else tuple((x_off[c], x_width[c]) for c in chunks)
        return (sum(width[p] for p in paths), sum(plan.paths[p]["mul"] for p in paths), sum(w for _, w in segs),
                sum(len(plan.paths[p]["terms"]) for p in paths), segs)

    def layout(paths):
        n_cols, n_w, xw, n_terms, _ = stats(paths)
        return _regions(variant, rows, itemsize, tf32, tile, st, plan.sh_dim, n_emb, hidden, n_cols, n_w, xw, n_terms)

    cap = None if variant in ("mlp", "xpose") else _THREADS
    bins: List[List[int]] = []
    for p in sorted(range(len(plan.paths)), key=lambda q: -width[q]):
        for b in bins:
            if (cap is None or stats(b)[0] + width[p] <= cap) and layout(b + [p])[1] <= SMEM_LIMIT:
                b.append(p)
                break
        else:
            if layout([p])[1] > SMEM_LIMIT:
                slice_bytes = [_ru(rows * w * itemsize, 16) if variant in SCATTER_VARIANTS else 0 for w in width]
                most = max(0, min((SMEM_LIMIT - layout([q])[1] + slice_bytes[q]) // (width[q] * itemsize)
                                  for q in range(len(width))))
                raise ValueError(f"T1/T3 {variant}: rows={rows} does not fit one path's slice in a block's "
                                 f"{SMEM_LIMIT} bytes of shared memory ({itemsize}-byte floats, {tile}-edge tiles): "
                                 f"at most rows={most}")
            bins.append([p])
    groups = tuple(tuple(sorted(b)) for b in bins)
    cols = tuple(tuple(c for p in g for c in range(plan.paths[p]["out_off"], plan.paths[p]["out_off"] + width[p]))
                 for g in groups)
    wcols = tuple(tuple(c for p in g for c in range(plan.paths[p]["w_off"], plan.paths[p]["w_off"] + plan.paths[p]["mul"]))
                  for g in groups)
    lays = [layout(list(g)) for g in groups]
    return FwdGroups(tile=tile, groups=groups, cols=cols, wcols=wcols, xsegs=tuple(stats(g)[4] for g in groups),
                     regions=tuple(r for r, _ in lays), group_smem=tuple(b for _, b in lays),
                     smem=max(b for _, b in lays), strides=st)


def fwd_tables(plan: TPPlan, variant: str, fg: FwdGroups, rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's int32 table (``HEAD``, then per group ``GINFO``, then the
    sections) and the CG coefficients in the group-local term order.  Each
    group's CG tables are ``TPPlan``'s forward tables restricted to its paths:
    a (path, m3) row is (first local column, first local w column, local
    terms), a term is (x row in the group's staged x chunks, y index)."""
    ginfo, gtab, gcol, gout, terms, coef, wcols, xsegs = [], [], [], [], [], [], [], []
    for g, cols, wc, segs, reg in zip(fg.groups, fg.cols, fg.wcols, fg.xsegs, fg.regions):
        xloc, o = {}, 0
        for off, w in segs:
            xloc[off] = o
            o += w
        rec = dict(n_cols=len(cols), col_base=len(gcol), gtab_base=len(gtab), n_w=len(wc), w_base=len(wcols),
                   term_base=len(terms), xseg_base=len(xsegs), n_xseg=len(segs), xw=o, **reg)
        col0, w0 = 0, 0
        for p in g:
            path = plan.paths[p]
            x_at = plan.tp.irreps_in1.slices()[path["x_chunk"]].start
            x_base = next(xloc[off] + x_at - off for off, w in segs if off <= x_at < off + w)
            for m3 in range(path["dim3"]):
                t0 = len(terms) - rec["term_base"]
                for m1, m2, mm3, c in path["terms"]:
                    if mm3 == m3:
                        terms.append((x_base + m1 * path["mul"], path["y_off"] + m2))
                        coef.append(c)
                gcol.extend([len(gtab) - rec["gtab_base"]] * path["mul"])
                gtab.append((col0 + m3 * path["mul"], w0, t0, len(terms) - rec["term_base"]))
            col0 += path["mul"] * path["dim3"]
            w0 += path["mul"]
        rec["n_terms"] = len(terms) - rec["term_base"]
        gout.extend(cols)
        wcols.extend(wc)
        xsegs.extend(segs)
        ginfo.append([rec[k] for k in GINFO])
    n_cols_out = {"mlp": plan.weight_numel, "cg_t": 1, "xpose": 1}.get(variant, plan.mid_dim)
    sections = [np.asarray(ginfo, np.int32).reshape(-1), np.asarray(gtab, np.int32).reshape(-1),
                np.asarray(gcol, np.int32), np.asarray(gout, np.int32), np.asarray(terms, np.int32).reshape(-1),
                np.asarray(wcols, np.int32), np.asarray(xsegs, np.int32).reshape(-1)]
    offs, o = [], len(HEAD)
    for sec in sections:
        offs.append(o)
        o += sec.size
    head = [len(fg.groups), *offs, fg.strides["ldh"], fg.strides["ldw1"], fg.strides["ldb"],
            rows if variant in SCATTER_VARIANTS else 1, n_cols_out]
    assert len(head) == len(HEAD)
    return np.concatenate([np.asarray(head, np.int32), *sections]), np.asarray(coef, np.float64)


class LaunchCounter:
    """The launch count of a kernel that a wrapper shares with another
    (one wrapper per computation, one count per layout)."""

    def __init__(self):
        self.launches = 0


COUNTERS = {name: LaunchCounter() for name in ("mb_fwd", "mb_fwd_t", "mb_bwd", "mb_bwd_t")}
KERNELS.update(COUNTERS)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as ``cvt.rna.tf32.f32`` does (to nearest, ties
    away from zero; the low 13 mantissa bits cleared)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _row(ops: dict, variant: str, slot: str) -> torch.Tensor:
    name = _SLOTS[variant][slot]
    return ops[name].t() if name.endswith("_t") else ops[name]


def _radial(emb, w1, w2, tf32: bool):
    r = tf32_round if tf32 else (lambda t: t)
    return r(F.silu(r(emb) @ r(w1))) @ r(w2)


def _block(plan: TPPlan, variant: str, ops: dict, rows: int, tf32: bool) -> torch.Tensor:
    """What one grid step adds to ``out [rows, mid_dim]``."""
    op = lambda slot: _row(ops, variant, slot)  # noqa: E731
    x = op("x") if "x" in _SLOTS[variant] else None
    ref = x if x is not None else ops["emb"]
    out = ref.new_zeros(rows, plan.mid_dim)
    if variant == "dot":
        out.index_add_(0, op("rel").long(), x[:, :1].expand(-1, plan.mid_dim))
    elif variant == "mlp":
        out[0, : plan.weight_numel] = _radial(op("emb"), op("w1"), op("w2"), tf32)[0]
    elif variant == "cg":
        out[0] = plan.tp(x, op("y"), x[:, :1].expand(-1, plan.weight_numel))[0]
    elif variant == "xpose":
        out[0, 0] = x[0, 0]
    elif variant == "cg_t":
        out[0, 0] = plan.tp(x, op("y"), op("w_in"))[0, 0]
    else:  # full, full_t, full_t_pre
        w = _radial(op("emb"), op("w1"), op("w2"), tf32)
        out.index_add_(0, op("rel").long(), plan.tp(x, op("y"), w))
    return out


def chunk_fwd_plain(plan: TPPlan, variant: str, ops: dict, rows: int, grid: int, tf32: bool = False):
    """T1/T3 in plain PyTorch: the chunk's block once, added ``grid`` times
    into a zeroed ``out`` in grid order (the TPU's result, as every step sees
    the same inputs).  ``tf32`` rounds the MLP products' operands to TF32, as
    the kernel's ``"DEFAULT"`` does on the card."""
    block = _block(plan, variant, ops, rows, tf32)
    out = torch.zeros_like(block)
    for _ in range(grid):
        out += block
    return out


_FWD_CACHE: Dict[tuple, tuple] = {}


def _mlp_widths(variant: str, ops: dict) -> Tuple[int, int]:
    """(n_emb, hidden) of the variant's W1 (the tool's 8 and 128 where it has none)."""
    name = _SLOTS[variant].get("w1")
    if name is None:
        return 8, 128
    return tuple(ops[name].shape[::-1] if name.endswith("_t") else ops[name].shape)


def _suffix(dtype: torch.dtype) -> str:
    return {torch.float32: "f32", torch.float64: "f64"}[dtype]


def _fwd_setup(plan: TPPlan, variant: str, rows: int, dtype: torch.dtype, tf32: bool, n_emb: int, hidden: int,
               grid: int, device: torch.device, lib=None):
    """(groups, int32 table, coefficients, step ranges) of a launch, on the
    device, cached per shape and library."""
    lib = lib or build.load_library()
    key = (id(plan), variant, rows, dtype, tf32, n_emb, hidden, grid, device, id(lib))
    if key not in _FWD_CACHE:
        fg = fwd_groups(plan, variant, rows, torch.finfo(dtype).bits // 8, tf32, n_emb, hidden)
        itab, coef = fwd_tables(plan, variant, fg, rows)
        per_sm = getattr(lib, f"nequip_mb_fwd_blocks_{_suffix(dtype)}")(_VARIANT_ID[variant], int(tf32), fg.smem)
        if per_sm < 1:  # a CUDA error (as -err), or no block fits
            build.check(-per_sm if per_sm < 0 else 1, f"mb_fwd {variant}: blocks per SM at {fg.smem} bytes")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        n_ranges = max(1, min(grid, sms * per_sm // len(fg.groups)))
        _FWD_CACHE[key] = (plan, lib, fg, torch.as_tensor(itab, device=device),
                           torch.as_tensor(coef, dtype=dtype, device=device), n_ranges)
    return _FWD_CACHE[key][2:]


def chunk_fwd(plan: TPPlan, variant: str, ops: dict, rows: int, grid: int, prec: str = "HIGHEST"):
    """T1 (``FWD_VARIANTS``) or T3 (``FWD_T_VARIANTS``): ``out [rows,
    mid_dim]``, the sum over ``grid`` steps of the variant's block (see
    ``csrc/microbench_fwd.cu``); two calls give bitwise equal results."""
    if variant not in _SLOTS:
        raise ValueError(f"variant {variant!r}: one of {tuple(_SLOTS)}")
    if prec not in PRECISIONS:
        raise ValueError(f"precision {prec!r}: one of {PRECISIONS}")
    counter = "mb_fwd_t" if variant in FWD_T_VARIANTS else "mb_fwd"
    slots = {k: ops[v] for k, v in _SLOTS[variant].items()}
    floats = [t for k, t in slots.items() if k != "rel"]
    if not _route(counter, *floats):
        return chunk_fwd_plain(plan, variant, ops, rows, grid)
    out = launch_fwd(plan, variant, ops, rows, grid, prec == "DEFAULT" and variant in MLP_VARIANTS)
    COUNTERS[counter].launches += 1
    return out


def launch_fwd(plan: TPPlan, variant: str, ops: dict, rows: int, grid: int, tf32: bool, lib=None) -> torch.Tensor:
    """``chunk_fwd``'s launch on CUDA operands, through ``lib`` (default: the
    kernel library; a profiling build passes its own), counting no launch."""
    counter = "mb_fwd_t" if variant in FWD_T_VARIANTS else "mb_fwd"
    slots = {k: ops[v] for k, v in _SLOTS[variant].items()}
    ref = next(t for k, t in slots.items() if k != "rel")
    if tf32 and ref.dtype != torch.float32:
        raise TypeError(f"{counter} {variant}: TF32 (DEFAULT) has no {ref.dtype} form; use HIGHEST")
    rel = slots.get("rel")
    if rel is not None and (rel.device != ref.device or rel.dtype != torch.int32 or not rel.is_contiguous()):
        raise ValueError(f"{counter}: rel must be contiguous int32 on the operands' device")
    x_name = _SLOTS[variant].get("x", "emb")
    be = ops[x_name].shape[1] if x_name.endswith("_t") else ops[x_name].shape[0]
    tile = TILE[ref.element_size()]
    if be % tile or grid < 1:
        raise ValueError(f"{counter}: the chunk's edges ({be}) must be a multiple of the {tile}-edge tile, grid >= 1")
    w1 = slots.get("w1")
    n_emb, hidden = _mlp_widths(variant, ops)
    lib = lib or build.load_library()
    fg, itab, coef, n_ranges = _fwd_setup(plan, variant, rows, ref.dtype, tf32, n_emb, hidden, grid, ref.device, lib)
    rows_p = rows if variant in SCATTER_VARIANTS else 1
    partial = torch.empty(n_ranges, rows_p, plan.mid_dim, dtype=ref.dtype, device=ref.device)
    out = torch.empty(rows, plan.mid_dim, dtype=ref.dtype, device=ref.device)
    packed = torch.empty(hidden * plan.weight_numel if w1 is not None and not tf32 else 1, dtype=ref.dtype,
                         device=ref.device)  # W2 by group, for the HIGHEST block GEMM
    ptr = lambda k: slots[k].data_ptr() if k in slots else None  # noqa: E731
    err = getattr(lib, f"nequip_mb_fwd_{_suffix(ref.dtype)}")(
        ptr("x"), ptr("y"), ptr("emb"), ptr("rel"), ptr("w1"), ptr("w2"), ptr("w_in"), itab.data_ptr(),
        coef.data_ptr(), packed.data_ptr(), partial.data_ptr(), out.data_ptr(), rows, be, plan.dim_in, plan.sh_dim,
        n_emb, hidden, plan.weight_numel, plan.mid_dim, grid, n_ranges, len(fg.groups), fg.smem,
        _VARIANT_ID[variant], int(tf32), torch.cuda.current_stream(ref.device).cuda_stream,
    )
    build.check(err, f"{counter} {variant}")
    return out


def fwd_launch_shape(plan: TPPlan, variant: str, ops: dict, rows: int, grid: int, prec: str) -> dict:
    """What ``chunk_fwd`` launches for these arguments on the card: the
    groups, shared memory per block, step ranges and blocks."""
    ref = ops[_SLOTS[variant].get("x", "emb")]
    fg, _, _, n_ranges = _fwd_setup(plan, variant, rows, ref.dtype, prec == "DEFAULT" and variant in MLP_VARIANTS,
                                    *_mlp_widths(variant, ops), grid, ref.device)
    return dict(groups=fg.describe(), smem=fg.smem, n_ranges=n_ranges, n_blocks=n_ranges * len(fg.groups))


def _bwd_names(layout: str) -> Tuple[str, ...]:
    if layout not in ("r", "t"):
        raise ValueError(f"layout {layout!r}: 'r' (rows [be, dim]) or 't' (feature-major [dim, be])")
    return ("x", "y", "g", "w") if layout == "r" else ("x_t", "y_t", "g_t", "w_t")


def bwd_smem(plan: TPPlan, itemsize: int) -> int:
    """Bytes of shared memory a T2/T4 block takes (``bwd_smem`` of
    ``csrc/microbench_bwd.cu``, which refuses any other size): the tile's x,
    g, y rows and w twice (each with room for a 16-byte phase), the dx and
    dy tiles, two buffers of dy partials, and int32 [tile + paths]."""
    V = 16 // itemsize
    t, P = BWD_TILE, len(plan.paths)
    elems = (_ru(t * plan.dim_in + V - 1, V) + _ru(t * plan.mid_dim + V - 1, V) + 2 * _ru(t * plan.weight_numel + V - 1, V)
             + _ru(t * plan.sh_dim + V - 1, V) + _ru(t * plan.dim_in, V) + _ru(t * plan.sh_dim, V)
             + 2 * _ru(t * P * 9, V))  # kMaxYDim = 9 partials a (edge, path)
    return elems * itemsize + 4 * (t + P)


def bwd_ranges(be: int, grid: int, slots: int) -> int:
    """Step ranges of a T2/T4 launch: as many as the card's ``slots``
    resident blocks hold for every tile, at least 1, at most ``grid``."""
    return max(1, min(grid, slots // -(-be // BWD_TILE)))


def chunk_bwd_plain(plan: TPPlan, ops: dict, layout: str = "r"):
    """T2/T4 in plain PyTorch: ``(dx, dy, dw)`` of ``TP(x, y, w)`` for the
    cotangent ``g``, in the operands' layout (one step's result: every step
    recomputes the same)."""
    t = layout == "t"
    x, y, g, w = (ops[n].t() if t else ops[n] for n in _bwd_names(layout))
    with torch.enable_grad():
        ins = tuple(a.detach().requires_grad_(True) for a in (x, y, w))
        dx, dy, dw = torch.autograd.grad(plan.tp(*ins), ins, g)
    return tuple(d.t().contiguous() if t else d for d in (dx, dy, dw))


def chunk_bwd(plan: TPPlan, ops: dict, grid: int, layout: str = "r"):
    """T2 (``layout="r"``) or T4 (``"t"``): ``(dx, dy, dw)`` of the chunk,
    recomputed in each of ``grid`` steps (see ``csrc/microbench_bwd.cu``);
    the chunk's edges must be a multiple of 8."""
    names = _bwd_names(layout)
    counter = "mb_bwd_t" if layout == "t" else "mb_bwd"
    x, y, g, w = (ops[n] for n in names)
    be = x.shape[1] if layout == "t" else x.shape[0]
    if be % 8 or be < 1 or grid < 1:
        raise ValueError(f"{counter}: the chunk's edges ({be}) must be a positive multiple of 8, grid >= 1")
    if not _route(counter, x, y, g, w):
        return chunk_bwd_plain(plan, ops, layout)
    out = launch_bwd(plan, ops, grid, layout)
    COUNTERS[counter].launches += 1
    return out


_BWD_CACHE: Dict[tuple, Tuple[int, int]] = {}


def bwd_launch_shape(plan: TPPlan, ops: dict, grid: int, layout: str = "r", lib=None) -> dict:
    """What ``chunk_bwd`` launches on the card: the tile, shared memory a
    block, resident blocks an SM, step ranges and blocks (cached per shape
    and library)."""
    x = ops[_bwd_names(layout)[0]]
    be = x.shape[1] if layout == "t" else x.shape[0]
    lib = lib or build.load_library()
    key = (x.dtype, layout, plan.dim_in, plan.sh_dim, plan.mid_dim, plan.weight_numel, len(plan.paths), x.device,
           id(lib))
    if key not in _BWD_CACHE:
        smem = bwd_smem(plan, x.element_size())
        per_sm = getattr(lib, f"nequip_mb_bwd_blocks_{_suffix(x.dtype)}")(smem, int(layout == "t"))
        if per_sm < 1:  # a CUDA error (as -err), or no block fits
            build.check(-per_sm if per_sm < 0 else 1, f"mb_bwd: blocks per SM at {smem} bytes")
        _BWD_CACHE[key] = (smem, per_sm)
    smem, per_sm = _BWD_CACHE[key]
    n_ranges = bwd_ranges(be, grid, per_sm * torch.cuda.get_device_properties(x.device).multi_processor_count)
    return dict(tile=BWD_TILE, smem=smem, per_sm=per_sm, n_ranges=n_ranges,
                n_blocks=n_ranges * -(-be // BWD_TILE))


def launch_bwd(plan: TPPlan, ops: dict, grid: int, layout: str = "r", lib=None):
    """``chunk_bwd``'s launch on CUDA operands, through ``lib`` (default: the
    kernel library; a profiling build passes its own), counting no launch."""
    t = layout == "t"
    x, y, g, w = (ops[n] for n in _bwd_names(layout))
    be = x.shape[1] if t else x.shape[0]
    lib = lib or build.load_library()
    shape = bwd_launch_shape(plan, ops, grid, layout, lib)
    tab = plan.device_tables(x.device, x.dtype)
    outs = tuple(torch.empty((width, be) if t else (be, width), dtype=x.dtype, device=x.device)
                 for width in (plan.dim_in, plan.sh_dim, plan.weight_numel))
    err = getattr(lib, f"nequip_mb_bwd_{_suffix(x.dtype)}")(
        x.data_ptr(), y.data_ptr(), g.data_ptr(), w.data_ptr(), tab["dx_groups"].data_ptr(),
        tab["dx_terms"].data_ptr(), tab["dx_coef"].data_ptr(), tab["dx_col"].data_ptr(),
        tab["paths"].data_ptr(), tab["path_terms"].data_ptr(), tab["path_coef"].data_ptr(),
        *(o.data_ptr() for o in outs), len(plan.paths), be, plan.dim_in, plan.sh_dim,
        plan.weight_numel, plan.mid_dim, grid, shape["n_ranges"], shape["smem"], int(t),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "mb_bwd_t" if t else "mb_bwd")
    return outs
