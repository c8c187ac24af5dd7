#!/usr/bin/env python3
"""K3 in bfloat16 (the row scatter-sum, ``csrc/scatter_rows.cu``) on the card:
its geometry against others, its load against other loads, and against
another tree's K3, each bitwise checked.

    python3 chip_k3_profile.py [--parent DIR] [--reps N] [--rounds R]

On the 23k-atom fcc graph of ``chip_smoke.py`` (its source-sorted
permutation and row pointers), for rows of D = 32, 288 (the flagship's
layers 0 and 1-2) and 480 (preset M's), with random bf16 values of [E, D]:

- ``port``: the wrapper (``tp_scatter.scatter_rows``), as phase 16a times it;
- ``kernel``: the same launch through the C entry point alone, into a
  given output (``port`` less ``kernel`` is the wrapper's Python when the
  card waits for it);
- ``L<lanes>xK<per_lane>``: the kernel at other geometries of 16-byte loads;
- copies of this tree's source built with changes (``PATCHES``): ``ldg``,
  the 16-byte load without the ``L1::no_allocate`` hint; ``l2_256`` and
  ``l2_128``, with an L2 prefetch-size hint; ``u16k1``, 16 edges a step at
  one vector a lane; ``t256``, blocks of 256 threads;
- ``parent``: DIR's ``scatter_rows.cu`` (a ``git archive`` of another commit)
  built alone, called through its bf16 entry with the f32 form's arguments.

Each output must be bitwise ``tp_scatter.scatter_rows_edge_order``'s (the
run fails otherwise).  Then the variants, the f32 kernel on the same values
and ``index_add_`` in bf16 are timed one call at a time in turns (CUDA
events, median of ``reps`` a round, median of ``rounds`` rounds) and 20
calls back to back (the device time a call), beside the bound (bytes at 2 B
a value over 3.35 TB/s), with the host time a call of the wrapper and of the
bare launch (at D = 288 also of the wrapper's parts and the registered op),
and the flagship's three layers summed (D = 288 counted twice).
Needs nvcc and a card; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_S = 3.35e12
GEOMETRIES = {32: [(2, 2), (8, 1)], 288: [(12, 3), (18, 2), (32, 2)], 480: [(15, 4), (20, 3), (32, 2)]}


LOAD = "ld.global.nc.L1::no_allocate.v4.u32"
# copies of this tree's scatter_rows.cu with some of its text replaced
PATCHES = {
    "ldg": [(LOAD, "ld.global.nc.v4.u32")],
    "l2_256": [(LOAD, "ld.global.nc.L1::no_allocate.L2::256B.v4.u32")],
    "l2_128": [(LOAD, "ld.global.nc.L1::no_allocate.L2::128B.v4.u32")],
    "u16k1": [("constexpr int U = K == 1 ? 8 : 4;", "constexpr int U = K == 1 ? 16 : 4;")],
    "t256": [("constexpr int kScatterThreads = 128;", "constexpr int kScatterThreads = 256;")],
}


def build_one(src: Path, csrc: Path, out: Path, patches=()) -> ctypes.CDLL:
    """One source built alone into a shared library (the package's nvcc
    flags), after the (old, new) replacements ``patches`` of its text."""
    from nequip_tpu_torch.ops.kernels import build

    text = src.read_text()
    for old, new in patches:
        if old not in text:
            raise SystemExit(f"{src}: patch target not found: {old!r}")
        text = text.replace(old, new)
    copy = out.with_suffix(".cu")
    copy.write_text(text)
    cmd = [build._find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
           "-fPIC", "-shared", f"-I{csrc}", str(copy), "-o", str(out)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {src}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return ctypes.CDLL(str(out))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as c
    from nequip_tpu_torch.ops.kernels import build
    from nequip_tpu_torch.ops.kernels import tp_scatter as K

    smi = c.phase0_device()
    c.phase1_build()
    P, I = ctypes.c_void_p, ctypes.c_int
    tmp = Path(tempfile.mkdtemp(prefix="k3_profile_", dir=build.BUILD_DIR))
    patched = {}
    for name, patch in PATCHES.items():
        patched[name] = build_one(build.CSRC / "scatter_rows.cu", build.CSRC, tmp / f"{name}.so", patch)
        patched[name].nequip_scatter_rows_bf16.argtypes = [P] * 4 + [I] * 5 + [P]
    parent = None
    if args.parent is not None:
        csrc = args.parent / "nequip_tpu_torch" / "csrc"
        parent = build_one(csrc / "scatter_rows.cu", csrc, tmp / "parent.so")
        parent.nequip_scatter_rows_bf16.argtypes = [P] * 4 + [I, I, P]

    dev = torch.device("cuda")
    data, _, _ = c.graph(23000, dev)
    lay = data[K.LAYOUT_KEY]
    perm, ptr = lay.src_perm, lay.src_ptr
    E, N, n_real = data["edge_index"].shape[1], ptr.shape[0] - 1, lay.n_real
    n_dst = int((ptr[1:] > ptr[:-1]).sum())
    src_idx = lay.edge_src[:n_real].long()  # index_add_ as phase 16a times it: the edges in stream order
    index = torch.cuda.current_device()
    stream = lambda: torch._C._cuda_getCurrentRawStream(index)  # noqa: E731  (as the wrapper takes it)
    rng = np.random.RandomState(27)
    sums: dict = {}
    print(f"chip_k3_profile ({smi}): {N} rows, {E} value rows, {n_real} real edges, {n_dst} non-empty rows; "
          f"reps {args.reps}, rounds {args.rounds}", flush=True)
    main_lib = build.load_library()

    def burst_ms(fn, n: int = 20) -> float:
        """Device time a call: CUDA events around n calls back to back, so the
        card does not wait for the host between them; median of 5."""
        for _ in range(2):
            fn()
        times = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / n)
        return float(np.median(times))

    def host_us(fn, n: int = 200) -> float:
        """Host time a call (enqueue only: no synchronisation inside the n
        calls), after 10 calls that take any first-call cost."""
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / n * 1e6

    for d in (32, 288, 480):
        v = torch.as_tensor(rng.standard_normal((E, d)), dtype=torch.bfloat16, device=dev)
        v32 = v.float()
        buf = torch.zeros(N, d, dtype=torch.bfloat16, device=dev)
        want = K.scatter_rows_edge_order(v, perm, ptr)
        geom = K.scatter_rows_geometry(d, v.data_ptr() % 16 == 0)
        out = torch.empty(N, d, dtype=torch.bfloat16, device=dev)

        def raw(lib, *extra):
            fn = lib.nequip_scatter_rows_bf16

            def run():
                build.check(fn(v.data_ptr(), perm.data_ptr(), ptr.data_ptr(), out.data_ptr(), N, d, *extra,
                               stream()), "scatter_rows variant")
                return out
            return run

        variants = {"port": lambda: K.scatter_rows(v, perm, ptr), "kernel": raw(main_lib, *geom)}
        for lanes, per_lane in GEOMETRIES[d]:
            variants[f"L{lanes}xK{per_lane}"] = raw(main_lib, 8, lanes, per_lane)
        for name, lib in patched.items():
            variants[name] = raw(lib, *geom)
        if parent is not None:
            variants["parent"] = raw(parent)
        for name, fn in variants.items():
            got = fn().clone()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                diff = float((got.float() - want.float()).abs().max())
                raise SystemExit(f"D {d} {name}: not bitwise the edge-order reference (max |diff| {diff:.3e})")
        timed = dict(variants)
        timed["f32 kernel"] = lambda: K.scatter_rows(v32, perm, ptr)
        timed["index_add_ bf16"] = lambda: buf.index_add_(0, src_idx, v[:n_real])
        ms = c.interleaved_median_ms(list(timed.values()), args.reps, args.rounds)
        b2b = [burst_ms(fn) for fn in timed.values()]
        nbytes = 2 * (n_real * d + N * d) + 4 * (n_real + n_dst + 1)
        bound = nbytes / HBM_BYTES_S * 1e3
        print(f"D {d}: geometry {geom}; bound {bound:.4f} ms (bytes); every output bitwise the edge-order "
              f"reference; host time a call (enqueue): port {host_us(variants['port']):.1f} us, kernel "
              f"{host_us(variants['kernel']):.1f} us"
              + ("" if parent is None else f", parent {host_us(variants['parent']):.1f} us"), flush=True)
        if d == 288:
            pieces = {
                "current_stream(device).cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
                "_cuda_getCurrentRawStream": stream,
                "torch.empty of the output": lambda: torch.empty(N, d, dtype=torch.bfloat16, device=dev),
                "wrapper (tp_scatter.scatter_rows)": variants["port"],
                "registered op (nequip_torch::scatter_rows)": lambda: torch.ops.nequip_torch.scatter_rows(v, perm,
                                                                                                          ptr),
            }
            print("  host time a call: " + ", ".join(f"{k} {host_us(f):.2f} us" for k, f in pieces.items()),
                  flush=True)
        for (name, _), t, tb in zip(timed.items(), ms, b2b):
            print(f"  {name:>16}: one call {t:.4f} ms ({100 * bound / t:.1f}% of the bound); back to back "
                  f"{tb:.4f} ms a call, {nbytes / tb / 1e9:.2f} TB/s ({100 * bound / tb:.1f}%)", flush=True)
            if d in (32, 288):
                for key, val in ((name, t), (name + " b2b", tb)):
                    sums[key] = sums.get(key, 0.0) + val * (1 if d == 32 else 2)
        del v, v32, buf, want, out, variants, timed
        torch.cuda.empty_cache()
    print("flagship's three layers (D 32 + 2 x 288; b2b: back to back): "
          + ", ".join(f"{k} {t:.4f} ms" for k, t in sums.items() if not k.startswith("L")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
