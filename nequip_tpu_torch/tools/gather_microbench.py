"""Row-gather microbenchmark: torch.index_select against the row_gather kernel.

Every conv gathers ``x[src]``, an ``[E, D]`` row gather (D = 288 node
features at the flagship's width): if a hand-written gather beats
``torch.index_select`` on the card, the gathers of the conv path are worth
a kernel of their own.  Port of ``tools/gather_microbench.py``: the same
arguments, index patterns (the same numpy stream) and printed lines, with
the CUDA kernel T5 of ``nequip_tpu_torch/ops/kernels/row_gather.py``.

    python -m nequip_tpu_torch.tools.gather_microbench [--rows 430080] [--src-rows 430080]
        [--dim 288] [--dtype float32|bfloat16] [--block-e 512] [--n-buf 16]
        [--pattern random|sorted|local|tilewin] [--skip-kernel] [--device cuda|cpu]

It runs on the card and raises without one unless ``--device cpu`` is
given, which runs the plain version.  Times come from CUDA events.
"""

from __future__ import annotations

import argparse
from typing import List

import numpy as np
import torch

from ..ops.kernels.row_gather import row_gather
from ..utils.device import resolve_device
from . import card_line, time_ms

PATTERNS = ("random", "sorted", "local", "tilewin")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}


def make_idx(pattern: str, rows: int, src_rows: int, block_e: int, rng: np.random.RandomState) -> np.ndarray:
    """Index streams with different locality, modelling layout choices
    (int32 ``[rows]``, the JAX tool's draws):

    * ``random``  -- uniform rows (the un-sorted x[src] gather).
    * ``sorted``  -- globally ascending with duplicates (best case).
    * ``local``   -- per-``block_e`` chunk: ascending draws from a +-window
      around the chunk's node-tile position (a within-tile src-sort of the
      edge stream).
    * ``tilewin`` -- like ``local`` but not sorted within the chunk.

    For ``local``/``tilewin`` rows past the last whole chunk are 0.
    """
    if pattern == "random":
        v = rng.randint(0, src_rows, rows)
    elif pattern == "sorted":
        v = np.sort(rng.randint(0, src_rows, rows))
    elif pattern in ("local", "tilewin"):
        G = rows // block_e
        win = max(4 * block_e, src_rows // 16)  # ~6k-row window at 23k scale
        v = np.zeros(rows, np.int64)
        for g in range(G):
            center = int((g + 0.5) * src_rows / G)
            lo = max(0, min(center - win // 2, src_rows - win))
            chunk = lo + rng.randint(0, win, block_e)
            if pattern == "local":
                chunk = np.sort(chunk)
            v[g * block_e : (g + 1) * block_e] = chunk
    else:
        raise SystemExit(f"unknown --pattern {pattern}")
    return v.astype(np.int32)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=430080)  # the 23k-atom edge stream
    ap.add_argument("--src-rows", type=int, default=430080)
    ap.add_argument("--dim", type=int, default=288)
    ap.add_argument("--dtype", type=str, default="float32", choices=tuple(DTYPES))
    ap.add_argument("--block-e", type=int, default=512)
    ap.add_argument("--n-buf", type=int, default=16)
    ap.add_argument("--pattern", type=str, default="random", help="|".join(PATTERNS) + " (see make_idx)")
    ap.add_argument("--skip-kernel", action="store_true")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu (plain version)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, steps: int = 8) -> List[dict]:
    """Print the tool's lines; returns one dict per timed gather: ``name``,
    ``out`` and ``ms``.  Raises if the kernel differs from
    ``torch.index_select`` (a copy is exact)."""
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    dtype = DTYPES[args.dtype]
    rng = np.random.RandomState(0)
    idx = torch.as_tensor(make_idx(args.pattern, args.rows, args.src_rows, args.block_e, rng), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def source(d):
        return torch.randn(args.src_rows, d, generator=gen, device=dev).to(dtype)

    results = []
    # index_select bandwidth against row width (is the library gather width-bound?)
    for D in (128, 288, 352, 1024, 1120):
        src = source(D)
        nbytes = args.rows * D * src.element_size()
        ms = time_ms(lambda: torch.index_select(src, 0, idx), steps, dev)
        print(f"index_select[{args.pattern}]  D={D:5d} : {ms:8.2f} ms  {nbytes / ms / 1e6:7.1f} GB/s", flush=True)
        results.append(dict(name=f"index_select D={D}", out=torch.index_select(src, 0, idx), ms=ms))
        del src

    src = source(args.dim)
    nbytes = args.rows * args.dim * src.element_size()
    if args.skip_kernel:
        return results
    for n_buf in (8, 16, 32):
        ms = time_ms(lambda: row_gather(src, idx, args.block_e, n_buf), steps, dev)
        print(
            f"row_gather kernel  : {ms:8.2f} ms  {nbytes / ms / 1e6:7.1f} GB/s useful"
            f"   (block_e={args.block_e}, n_buf={n_buf})",
            flush=True,
        )
        results.append(dict(name=f"row_gather n_buf={n_buf}", out=row_gather(src, idx, args.block_e, n_buf), ms=ms))

    # correctness
    if not torch.equal(row_gather(src, idx, args.block_e, args.n_buf), torch.index_select(src, 0, idx)):
        raise RuntimeError("row_gather differs from torch.index_select")
    print("parity OK", flush=True)
    return results


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
