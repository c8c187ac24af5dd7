"""Compute-isolated microbenchmark of the fused conv's building blocks.

Times each block of the fused conv kernel (radial MLP, CG contraction,
scatter) on one CONSTANT chunk of ``be`` edges, repeated over a grid of
``G`` steps, so the time per step is the block's compute per chunk (the
chunk stays in L2).  Port of ``tools/kernel_microbench.py``: the same
variants, inputs (the same numpy streams) and printed lines, with the CUDA
kernels T1-T4 of ``nequip_tpu_torch/ops/kernels/microbench.py``.

    python -m nequip_tpu_torch.tools.kernel_microbench [--grid 2048] [--rows 128] [--be 256]
        [--reps 10] [--only dot,_t] [--device cuda|cpu]

It runs on the card and raises without one unless ``--device cpu`` is
given, which runs the plain PyTorch versions.  Times come from CUDA events.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops.irreps import Irreps
from ..ops.kernels.microbench import FWD_T_VARIANTS, FWD_VARIANTS, chunk_bwd, chunk_fwd
from ..ops.kernels.tp_scatter import TPPlan
from ..ops.tensor_product import TensorProduct, uvu_instructions
from ..utils.device import resolve_device
from . import F32_FLOP_S, HBM_BYTES_S, TF32_FLOP_S, card_line, time_ms

N_EMB, HIDDEN = 8, 128


def make_inputs(rows: int, be: int) -> Tuple[TPPlan, Dict[str, np.ndarray]]:
    """The tool's TP plan (``32x0e+32x1e+32x2e`` x SH(l<=2) -> the same
    irreps, ``uvu``: dim_in 288, sh_dim 9, mid_dim 992, WN 288) and its
    chunk, drawn from numpy in the JAX tool's order and seeds (f32; ``rel``
    int32 ``[be]``)."""
    feats = Irreps("32x0e+32x1e+32x2e")
    sh = Irreps.spherical_harmonics(2)
    mid, ins = uvu_instructions(feats, sh, feats)
    plan = TPPlan(TensorProduct(feats, sh, mid, ins, shared_weights=False))
    wn = plan.weight_numel

    def f32(a):
        return np.asarray(a, np.float32)

    rng = np.random.RandomState(0)
    a = dict(
        x=f32(rng.standard_normal((be, plan.dim_in))),
        y=f32(rng.standard_normal((be, plan.sh_dim))),
        emb=f32(rng.standard_normal((be, N_EMB))),
        rel=rng.randint(0, rows, (be, 1)).astype(np.int32).reshape(be),
        w1=f32(rng.standard_normal((N_EMB, HIDDEN)) * 0.1),
        w2=f32(rng.standard_normal((HIDDEN, wn)) * 0.1),
        g=f32(np.random.RandomState(1).standard_normal((be, plan.mid_dim))),
        g_t=f32(np.random.RandomState(1).standard_normal((plan.mid_dim, be))),
        w=f32(np.random.RandomState(2).standard_normal((be, wn))),
        w_t=f32(np.random.RandomState(2).standard_normal((wn, be))),
    )
    for k in ("x", "y", "w1", "w2"):
        a[f"{k}_t"] = np.ascontiguousarray(a[k].T)
    return plan, a


def to_tensors(arrays: Dict[str, np.ndarray], device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The chunk on ``device``: floats in ``dtype``, ``rel`` int32."""
    return {
        k: torch.as_tensor(v, dtype=torch.int32 if k == "rel" else dtype, device=device).contiguous()
        for k, v in arrays.items()
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", type=int, default=2048)
    ap.add_argument("--rows", type=int, default=128)
    ap.add_argument("--be", type=int, default=256)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--only", type=str, default="",
                    help="comma-separated variant filter (substring match), e.g. '_t,xpose'")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu (plain versions)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> List[dict]:
    """Print the tool's lines; returns one dict per variant run: ``name``,
    ``out`` (``dx`` for the CG-VJP, with ``dy`` and ``dw`` beside it) and
    ``ms``."""
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    rows, be, G = args.rows, args.be, args.grid
    plan, arrays = make_inputs(rows, be)
    ops = to_tensors(arrays, dev)
    wn = plan.weight_numel
    print(f"dims: in={plan.dim_in} mid={plan.mid_dim} WN={wn} rows={rows} be={be} G={G} "
          f"(scatter and CG in f32 at both precisions; DEFAULT: the MLP products in TF32)", flush=True)
    only = [s for s in args.only.split(",") if s]
    results = []

    def timeit(name, fn):
        if only and not any(s in name for s in only):
            return
        out = fn()
        ms = time_ms(fn, args.reps, dev)
        print(f"{name}: {ms:.2f} ms  ({ms / G * 1e3:.2f} us/chunk)", flush=True)
        r = dict(name=name, ms=ms)
        if isinstance(out, tuple):
            r.update(out=out[0], dy=out[1], dw=out[2])
        else:
            r["out"] = out
        results.append(r)

    for v in FWD_VARIANTS:
        for prec in ("HIGHEST", "DEFAULT"):
            timeit(f"{v} {prec}", lambda v=v, prec=prec: chunk_fwd(plan, v, ops, rows, G, prec))
    timeit("cgvjp (bwd core)", lambda: chunk_bwd(plan, ops, G))
    for v in FWD_T_VARIANTS:
        timeit(f"{v} DEFAULT", lambda v=v: chunk_fwd(plan, v, ops, rows, G, "DEFAULT"))
    timeit("cgvjp_t (bwd core)", lambda: chunk_bwd(plan, ops, G, layout="t"))
    flop_dot = G * be * rows * plan.mid_dim * 2  # the TPU's one-hot matmul form of the scatter
    flop_mlp = G * be * (N_EMB * HIDDEN + HIDDEN * wn) * 2
    chunk_bytes = 4 * (sum(v.size for v in arrays.values()) + rows * plan.mid_dim)
    print(
        f"theory: dot {flop_dot / 1e9:.0f} GF "
        f"(67TF/s={flop_dot / F32_FLOP_S * 1e3:.1f}ms, 495TF/s={flop_dot / TF32_FLOP_S * 1e3:.1f}ms); "
        f"mlp {flop_mlp / 1e9:.0f} GF "
        f"(67TF/s={flop_mlp / F32_FLOP_S * 1e3:.2f}ms, 495TF/s={flop_mlp / TF32_FLOP_S * 1e3:.2f}ms); "
        f"chunk+out {chunk_bytes / 1e6:.1f} MB (3.35TB/s={chunk_bytes / HBM_BYTES_S * 1e6:.1f}us)",
        flush=True,
    )
    return results


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
