#!/usr/bin/env python3
"""Where K5 and K7 spend their time, and what their variants cost, on one
NVIDIA GPU.

    python3 chip_cg_profile.py [VARIANT ...]     (default: base clocks)

K5 (``csrc/tri_bwd.cu``) and K7 (``csrc/jvp_bwd.cu``) are built once per
variant, each from a patched copy of its source in its own library under
``nequip_tpu_torch/_build/``, and timed (CUDA events, median of 3 x 10
calls, the variants in turns) at the f32 shapes phase 2 of ``chip_smoke.py``
gives them: K5 on the whole 23k-atom stream, K7 on the second of 4 edge
slices, at each of the flagship's 3 conv layers.  Each result is checked
against the plain version (f32, rtol 1e-4 with atol 1e-5 max|ref|).
Variants:

  base          the kernels as they are;
  clocks        clock64 marks: cycles per tile of thread 0 in each phase
                (staging and destinations, dx, dW and dy partials, dy sum,
                per-edge stores), summed over the blocks;
  shuffle_sums  each m2 run's dy partial summed edge by edge (5 shuffles an
                edge) instead of by a reduce-scatter;
  edges<N>      N edges an item (8 in K5, 4 in K7);
  g_rows0       no g rows staged in shared memory (K5; K7 stages none);
  tile<T>x<S>x<B>  the launch shape forced: T edges, S stages, B blocks an SM;
  prefetch      the next tile's weight rows prefetched into L2;
  unroll4       the term loops unrolled by 4 instead of 2.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import chip_smoke as CS
from nequip_tpu_torch.ops.kernels import build
from nequip_tpu_torch.ops.kernels import tp_scatter as K

KERNELS = ("tri_bwd", "jvp_bwd")

MARKS = """
__device__ unsigned long long cg_clk[8];
extern "C" int cg_read_clk(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, cg_clk, sizeof(cg_clk)));
}
extern "C" int cg_zero_clk() {
  const unsigned long long z[8] = {};
  return static_cast<int>(cudaMemcpyToSymbol(cg_clk, z, sizeof(z)));
}
#define CG_MARK(i) if (tid == 0) { const long long t_ = clock64(); cg_acc[i] += t_ - cg_t; cg_t = t_; }
"""
PHASES = ("staging", "dx", "dW and dy partials", "dy sum", "stores")


def _once(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"source anchor not found once: {old!r}")
    return src.replace(old, new)


def clocks(src: str) -> str:
    src = _once(src, '#include "dense_tiles.cuh"\n', '#include "dense_tiles.cuh"\n' + MARKS)
    src = _once(src, "  if (STAGES == 2) stage(blockIdx.x, 0);\n",
                "  if (STAGES == 2) stage(blockIdx.x, 0);\n"
                "  long long cg_acc[5] = {0, 0, 0, 0, 0}, cg_t = clock64();\n  int cg_n = 0;\n")
    src = _once(src, "    if (STAGES == 1) cp_async_wait<0>();\n    __syncthreads();\n",
                "    if (STAGES == 1) cp_async_wait<0>();\n    __syncthreads();\n    CG_MARK(0);\n    ++cg_n;\n")
    src = re.sub(r"(\n\s+__syncthreads\(\);  // dx[^\n]*\n)", r"\1      CG_MARK(1);\n", src, count=1)
    src = _once(src, "    __syncthreads();\n    cg::path_sum",
                "    __syncthreads();\n    CG_MARK(2);\n    cg::path_sum")
    lines = src.split("\n")
    lines.insert(max(j for j, ln in enumerate(lines) if "store_flat<T, NT>(" in ln) + 1, "    CG_MARK(4);")
    lines.insert(max(j for j, ln in enumerate(lines) if "cg::path_sum<T, NT>(" in ln) + 1, "    CG_MARK(3);")
    src = "\n".join(lines)
    launcher = src.index("template <typename T, int TILE, int STAGES, int MIN_BLOCKS>\ncudaError_t launch_tile")
    end = src.rindex("}\n", 0, launcher)  # the kernel's last line
    return src[:end] + (
        "  if (tid == 0) {\n"
        "    for (int i = 0; i < 5; ++i) atomicAdd(&cg_clk[i], static_cast<unsigned long long>(cg_acc[i]));\n"
        "    atomicAdd(&cg_clk[5], static_cast<unsigned long long>(cg_n));\n  }\n") + src[end:]


def force(tile: int, stages: int, blocks: int):
    def patch(src: str) -> str:
        i = src.index("  cudaError_t e;\n")
        j = src.index("  return static_cast<int>(e);\n", i)
        if "auto fits = " in src:  # K5: fits() picks the staged g rows and sets smem
            check, smem = f"fits({tile}, {stages}, {blocks})", "smem"
        else:
            check, smem = f"lim.fit(smem({tile}, {stages}), {blocks})", f"smem({tile}, {stages})"
        launch = f"launch_tile<T, {tile}, {stages}, {blocks}>(a, lim.dev, {smem}, s)"
        forced = f"  if (!{check}) return 999;  // no such shape here\n  const cudaError_t e = {launch};\n"
        return src[:i] + forced + src[j:]
    return patch


def prefetch(src: str) -> str:
    rows = ("a.w", "a.dw") if "a.cdw" in src else ("a.w",)
    body = "".join(
        f"        for (int i = tid * 128; i < nbytes; i += NT * 128)\n"
        f"          asm volatile(\"prefetch.global.L2 [%0];\" ::\"l\"(reinterpret_cast<const char*>({r} + "
        f"static_cast<int64_t>(nb) * wn) + i));\n" for r in rows)
    return _once(src, "    if (STAGES == 1) cp_async_wait<0>();\n    __syncthreads();\n",
                 "    if (STAGES == 1) cp_async_wait<0>();\n    __syncthreads();\n"
                 "    {\n      const int nb = (tile + static_cast<int>(gridDim.x)) * TILE;\n"
                 "      if (nb < n_real) {\n"
                 "        const int nbytes = min(TILE, n_real - nb) * wn * static_cast<int>(sizeof(T));\n"
                 + body + "      }\n    }\n")


# cg::add_run summing each edge's partial over the lanes on its own
SHUFFLE_SUMS = ("""  const T s = reduce_scatter<T, TC>(v, lane);
  if ((lane & (32 / TC - 1)) == 0) part[((e0 + edge_of<TC>(lane)) * n_paths + p) * kMaxYDim + m] += s;
""", """  for (int i = 0; i < TC; ++i) {
    T s = v[i];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) part[((e0 + i) * n_paths + p) * kMaxYDim + m] += s;
  }
""")


def _sub(pattern: str, repl: str):
    return lambda src: re.sub(pattern, repl, src)


# variant -> (patch of a kernel's .cu, patch of the headers)
VARIANTS = {
    "base": (None, None),
    "clocks": (clocks, None),
    "shuffle_sums": (None, lambda src: src.replace(*SHUFFLE_SUMS)),
    "g_rows0": (_sub(r"constexpr int kGRows = \d+;", "constexpr int kGRows = 0;"), None),
    "prefetch": (prefetch, None),
    "unroll4": (None, _sub(r"#pragma unroll 2", "#pragma unroll 4")),
}


def variant(name: str):
    m = re.fullmatch(r"tile(\d+)x(\d+)x(\d+)", name)
    if m:
        return force(*map(int, m.groups())), None
    m = re.fullmatch(r"edges(\d+)", name)
    if m:
        return _sub(r"constexpr int kCgEdges = \d+;", f"constexpr int kCgEdges = {m.group(1)};"), None
    if name not in VARIANTS:
        raise SystemExit(f"unknown variant {name!r}: {', '.join(VARIANTS)}, edges<N> or tile<T>x<S>x<B>")
    return VARIANTS[name]


def build_variant(name: str, kernel: str, root: str) -> str:
    cu_patch, h_patch = variant(name)
    d = os.path.join(root, f"{name}_{kernel}")
    os.makedirs(d)
    for f in os.listdir(build.CSRC):
        if f.endswith(".cuh") or f == f"{kernel}.cu":
            src = (build.CSRC / f).read_text()
            patch = h_patch if f.endswith(".cuh") else cu_patch
            with open(os.path.join(d, f), "w") as out:
                out.write(patch(src) if patch else src)
    lib = os.path.join(d, f"lib{kernel}.so")
    r = subprocess.run([build._find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-Xcompiler", "-fPIC", "-shared", f"-I{d}", os.path.join(d, f"{kernel}.cu"), "-o", lib],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{name} {kernel}: nvcc failed\n{r.stderr[-3000:]}")
    return lib


def flagship_inputs(seed=0):
    """The 23k-atom graph, its second of 4 edge slices (boundaries 7 edges into
    a segment, as chip_smoke.py's phase 2) and the flagship's conv plans."""
    from nequip_tpu_torch.model import NequIPGNNModel
    from nequip_tpu_torch.nn.interaction_block import InteractionBlock

    dev = torch.device("cuda")
    data, _, _ = CS.graph(23000, dev)
    layout = data[K.LAYOUT_KEY]
    n_real = layout.n_real
    bounds = [0] + [s * n_real // CS.N_CHUNKS + 7 for s in range(1, CS.N_CHUNKS)] + [n_real]
    sl = K.edge_slices(layout, CS.N_CHUNKS, bounds)[1]
    model = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", **CS.FLAGSHIP)
    blocks = [m for m in model.modules() if isinstance(m, InteractionBlock)]
    return data, layout, sl, blocks, np.random.RandomState(seed)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_cg_profile.py needs an NVIDIA GPU")
    names = sys.argv[1:] or ["base", "clocks"]
    keys = [f"{n}#{i}" if names.count(n) > 1 else n for i, n in enumerate(names)]  # a variant may repeat
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as root, ThreadPoolExecutor(os.cpu_count()) as ex:
        futs = {(k, kern): ex.submit(build_variant, k.split("#")[0], kern, os.path.join(root, k.replace("#", "_")))
                for k in keys for kern in KERNELS}
        libs = {key: ctypes.CDLL(f.result()) for key, f in futs.items()}
        print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
        for (k, kern), lib in libs.items():
            fn = getattr(lib, f"nequip_{kern}_f32")
            fn.argtypes, fn.restype = build._SIGNATURES[f"nequip_{kern}"], ctypes.c_int
        run(keys, libs)
    return 0


def run(keys, libs) -> None:
    dev = torch.device("cuda")
    dtype = torch.float32
    data, layout, sl, blocks, rng = flagship_inputs()
    N, E = data["pos"].shape[0], data["edge_index"].shape[1]
    lay_s, rows = sl.layout, slice(sl.start, sl.stop)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    sums = {}
    for li, blk in enumerate(blocks):
        plan = blk.tp_scatter.plan
        t = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=dtype, device=dev)  # noqa: E731
        x, sh, g, w = t(N, plan.dim_in), t(E, plan.sh_dim), t(N, plan.mid_dim), t(E, plan.weight_numel)
        tx, tsh, dw, gt = t(N, plan.dim_in), t(E, plan.sh_dim), t(E, plan.weight_numel), t(N, plan.mid_dim)
        tab = plan.device_tables(dev, dtype)
        tabs = [tab[k].data_ptr() for k in ("dx_groups", "dx_terms", "dx_coef", "dx_col", "paths", "path_terms",
                                            "path_coef")]
        widths = {"tri_bwd": (plan.dim_in, plan.sh_dim, plan.weight_numel),
                  "jvp_bwd": (plan.dim_in, plan.dim_in, plan.sh_dim, plan.sh_dim, plan.weight_numel,
                              plan.weight_numel)}
        refs = {"tri_bwd": K.tri_bwd_plain(plan, x, sh, w, layout, g),
                "jvp_bwd": K.jvp_bwd_plain(plan, x, tx, sh[rows], tsh[rows], w[rows], dw[rows], lay_s, g, gt)}

        def call(kern, lib, outs):
            if kern == "tri_bwd":
                ops = [x, sh, w, layout.edge_src, layout.dst_ptr, g]
                n_nodes = layout.num_nodes
            else:
                ops = [x, tx, sh[rows], tsh[rows], w[rows], dw[rows], lay_s.edge_src, lay_s.dst_ptr, g, gt]
                n_nodes = lay_s.num_nodes
            err = getattr(lib, f"nequip_{kern}_f32")(
                *(o.data_ptr() for o in ops), *tabs, *(o.data_ptr() for o in outs), len(plan.paths), n_nodes,
                plan.dim_in, plan.sh_dim, plan.weight_numel, plan.mid_dim, stream())
            if err:
                raise RuntimeError(f"{kern}: cudaError {err}")

        for (k, kern), lib in libs.items():
            rows_out = E if kern == "tri_bwd" else sl.stop - sl.start
            outs = tuple(torch.zeros(rows_out, wd, dtype=dtype, device=dev) for wd in widths[kern])
            rec = dict(variant=k, kernel=kern, layer=li)
            try:
                clk = k.startswith("clocks")
                if clk:
                    lib.cg_zero_clk()
                call(kern, lib, outs)
                torch.cuda.synchronize()
                rec["ok"] = all(bool(((a - b).abs() <= 1e-4 * b.abs() + 1e-5 * float(b.abs().max())).all())
                                for a, b in zip(outs, refs[kern]))
                if clk:
                    buf = (ctypes.c_ulonglong * 8)()
                    lib.cg_read_clk(buf)
                    rec["cycles_per_tile"] = {p: buf[i] / buf[5] for i, p in enumerate(PHASES)}
                rec["ms"] = float(np.median([CS.cuda_median_ms(lambda: call(kern, lib, outs), 10) for _ in range(3)]))
            except RuntimeError as exc:  # a forced shape that does not fit
                rec.update(ok=False, ms=float("nan"), error=str(exc))
            sums.setdefault((k, kern), []).append(rec["ms"])
            print(json.dumps(rec), flush=True)
        del refs
        torch.cuda.empty_cache()
    for (k, kern), ms in sums.items():
        print(f"{kern} {k} f32, sum of 3 layers: {sum(ms):.3f} ms ({', '.join(f'{m:.3f}' for m in ms)})",
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
