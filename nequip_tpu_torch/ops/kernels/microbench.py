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

Each wrapper runs its plain PyTorch twin when the operands lie on the CPU,
launches its kernel when they lie on a CUDA device, and raises otherwise.
"""

from __future__ import annotations

from typing import Dict, Tuple

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
_BLOCKS_PER_SM = 2  # persistent grid: blocks per SM, each with its own [rows, mid_dim] partial


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


def _n_blocks(device: torch.device, grid: int) -> int:
    return min(grid, _BLOCKS_PER_SM * torch.cuda.get_device_properties(device).multi_processor_count)


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
    ref = floats[0]
    tf32 = prec == "DEFAULT" and variant in MLP_VARIANTS
    if tf32 and ref.dtype != torch.float32:
        raise TypeError(f"{counter} {variant}: TF32 (DEFAULT) has no {ref.dtype} form; use HIGHEST")
    rel = slots.get("rel")
    if rel is not None and (rel.device != ref.device or rel.dtype != torch.int32 or not rel.is_contiguous()):
        raise ValueError(f"{counter}: rel must be contiguous int32 on the operands' device")
    x_name = _SLOTS[variant].get("x", "emb")
    be = ops[x_name].shape[1] if x_name.endswith("_t") else ops[x_name].shape[0]
    if be % 8 or grid < 1:
        raise ValueError(f"{counter}: the chunk's edges ({be}) must be a multiple of 8, grid >= 1")
    w1 = slots.get("w1")
    n_emb, hidden = (0, 0) if w1 is None else (w1.shape[::-1] if _SLOTS[variant]["w1"].endswith("_t") else w1.shape)
    tab = plan.device_tables(ref.device, ref.dtype)
    n_blocks = _n_blocks(ref.device, grid)
    partial = torch.empty(n_blocks, rows, plan.mid_dim, dtype=ref.dtype, device=ref.device)
    out = torch.empty(rows, plan.mid_dim, dtype=ref.dtype, device=ref.device)
    ptr = lambda k: slots[k].data_ptr() if k in slots else None  # noqa: E731
    err = build.entry_point("nequip_mb_fwd", ref.dtype)(
        ptr("x"), ptr("y"), ptr("emb"), ptr("rel"), ptr("w1"), ptr("w2"), ptr("w_in"),
        tab["fwd_groups"].data_ptr(), tab["fwd_terms"].data_ptr(), tab["fwd_coef"].data_ptr(),
        tab["fwd_col"].data_ptr(), partial.data_ptr(), out.data_ptr(), rows, be, plan.dim_in,
        plan.sh_dim, n_emb, hidden, plan.weight_numel, plan.mid_dim, grid, n_blocks,
        _VARIANT_ID[variant], int(tf32), torch.cuda.current_stream(ref.device).cuda_stream,
    )
    build.check(err, f"{counter} {variant}")
    COUNTERS[counter].launches += 1
    return out


def _bwd_names(layout: str) -> Tuple[str, ...]:
    if layout not in ("r", "t"):
        raise ValueError(f"layout {layout!r}: 'r' (rows [be, dim]) or 't' (feature-major [dim, be])")
    return ("x", "y", "g", "w") if layout == "r" else ("x_t", "y_t", "g_t", "w_t")


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
    recomputed in each of ``grid`` steps (see ``csrc/microbench_bwd.cu``)."""
    names = _bwd_names(layout)
    counter = "mb_bwd_t" if layout == "t" else "mb_bwd"
    x, y, g, w = (ops[n] for n in names)
    if not _route(counter, x, y, g, w):
        return chunk_bwd_plain(plan, ops, layout)
    be = x.shape[1] if layout == "t" else x.shape[0]
    if be % 8 or grid < 1:
        raise ValueError(f"{counter}: the chunk's edges ({be}) must be a multiple of 8, grid >= 1")
    tab = plan.device_tables(x.device, x.dtype)
    n_blocks = _n_blocks(x.device, grid)
    # one slot of results per block; the last step's block holds the answer
    outs = tuple(
        torch.empty((n_blocks, width, be) if layout == "t" else (n_blocks, be, width), dtype=x.dtype, device=x.device)
        for width in (plan.dim_in, plan.sh_dim, plan.weight_numel)
    )
    err = build.entry_point("nequip_mb_bwd", x.dtype)(
        x.data_ptr(), y.data_ptr(), g.data_ptr(), w.data_ptr(), tab["dx_groups"].data_ptr(),
        tab["dx_terms"].data_ptr(), tab["dx_coef"].data_ptr(), tab["dx_col"].data_ptr(),
        tab["paths"].data_ptr(), tab["path_terms"].data_ptr(), tab["path_coef"].data_ptr(),
        *(o.data_ptr() for o in outs), len(plan.paths), be, plan.dim_in, plan.sh_dim,
        plan.weight_numel, plan.mid_dim, grid, n_blocks, int(layout == "t"),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, counter)
    COUNTERS[counter].launches += 1
    last = (grid - 1) % n_blocks
    return tuple(o[last] for o in outs)
