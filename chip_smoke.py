#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (nequip_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero):
  0. device: require CUDA, print the card's name and power limit, TF32 off;
  1. build the CUDA kernels with nvcc from nequip_tpu_torch/csrc;
  2. K1/K2/K3 against their plain PyTorch versions on the card, at the three
     conv-layer shapes of the flagship on the 23k-atom fcc Cu graph, f32 and
     f64, with median kernel and plain times (CUDA events);
  3. the port in f64, kernels on the card, against the golden E/F/stress the
     JAX package wrote (tests/data/torch_port_golden.npz);
  4. serving: the flagship in f32 with tp_impl="fused" answers three
     calculator requests on the 23k-atom frame; the kernel launch counts of
     those requests are reported, and one request is checked against
     tp_impl="torch".
The second-to-last line is the kernel report as JSON ("launches": the
kernel's launches during the phase-4 requests; "ms"/"plain_ms": phase-2 f32
medians summed over the three layer shapes; "max_abs_err": the largest f32
difference from plain); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_port_golden.npz"
# the TPU kernels the CUDA kernels replace (pl.pallas_call sites)
REPLACES = {
    "conv_fwd": "nequip_tpu/ops/pallas/tp_scatter.py:1649",
    "conv_bwd": "nequip_tpu/ops/pallas/tp_scatter.py:1733",
    "scatter_rows": "nequip_tpu/ops/pallas/tp_scatter.py:1059",
}
FLAGSHIP = dict(
    type_names=["Cu"], r_max=4.0, num_layers=3, l_max=2, parity=False, num_features=32,
    avg_num_neighbors=18.0, per_type_energy_shifts={"Cu": -3.5},
    per_type_energy_scales={"Cu": 0.5},
)


def fcc_frame(n_atoms: int, seed: int = 0, jitter: float = 0.05) -> dict:
    """Bulk-Cu fcc supercell (nearest cube >= n_atoms), as __graft_entry__._fcc_frame."""
    rng = np.random.RandomState(seed)
    a = 3.61
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]) * a
    reps = max(1, int(round((n_atoms / 4) ** (1 / 3))))
    if 4 * reps**3 < n_atoms:
        reps += 1
    pos = np.concatenate(
        [base + np.array([i, j, k]) * a for i in range(reps) for j in range(reps) for k in range(reps)]
    )
    pos = pos + rng.normal(0, jitter, pos.shape)
    return {
        "pos": pos,
        "cell": np.diag([reps * a] * 3),
        "pbc": np.array([True] * 3),
        "atomic_numbers": np.full(len(pos), 29),
    }


def phase0_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("phase 0: torch.cuda.is_available() is False; this check needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(
        f"phase 0 device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}",
        flush=True,
    )
    return smi


def phase1_build():
    from nequip_tpu_torch.ops.kernels import build

    path, seconds = build.build()
    build.load_library()
    print(f"phase 1 build: {path.name} in {seconds:.1f} s", flush=True)


def graph(n_atoms: int, device, seed: int = 0, jitter: float = 0.05):
    """Padded, kernel-ordered 23k-style graph as the calculator builds it."""
    from nequip_tpu_torch.data import (
        batched_from_list, compute_neighborlist_, from_dict, pad_batch, round_up, to_tensors,
    )
    from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper
    from nequip_tpu_torch.ops.kernels.tp_scatter import relayout_edge_stream

    frame = compute_neighborlist_(
        ChemicalSpeciesToAtomTypeMapper(["Cu"])(from_dict(fcc_frame(n_atoms, seed, jitter))), 4.0
    )
    batch = batched_from_list([frame])
    n, e = batch["pos"].shape[0], batch["edge_index"].shape[1]
    padded = pad_batch(batch, round_up(n, 128), round_up(e, 256), 2)
    return relayout_edge_stream(to_tensors(padded, device)), n, e


def cuda_median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase2_kernels(n_atoms: int, reps: int):
    """Each kernel against its plain version at the flagship's layer shapes."""
    import torch

    from nequip_tpu_torch.model import NequIPGNNModel
    from nequip_tpu_torch.nn.interaction_block import InteractionBlock
    from nequip_tpu_torch.ops.kernels import tp_scatter as K

    dev = torch.device("cuda")
    data, n, e = graph(n_atoms, dev)
    layout = data[K.LAYOUT_KEY]
    N, E = data["pos"].shape[0], data["edge_index"].shape[1]
    print(f"phase 2 graph: {n} atoms, {e} edges, padded to {N} nodes, {E} edges", flush=True)
    model = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", **FLAGSHIP)
    blocks = [m for m in model.modules() if isinstance(m, InteractionBlock)]
    rng = np.random.RandomState(0)
    report = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0} for k in K.KERNELS}
    for dtype, rtol, atol_rel in ((torch.float32, 1e-4, 1e-5), (torch.float64, 1e-10, 1e-10)):
        for li, blk in enumerate(blocks):
            plan = blk.tp_scatter.plan
            a0, a1 = blk.edge_mlp.alphas
            n_emb, hidden = blk.edge_mlp.w0.shape

            def t(*shape):
                return torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=dev)

            x, sh, emb = t(N, plan.dim_in), t(E, plan.sh_dim), t(E, n_emb)
            w1, w2, g = t(n_emb, hidden), t(hidden, plan.weight_numel), t(N, plan.mid_dim)
            calls = {
                "conv_fwd": (
                    lambda: K.conv_fwd(plan, x, sh, emb, w1, w2, a0, a1, layout),
                    lambda: K.conv_fwd_plain(plan, x, sh, emb, w1, w2, a0, a1, layout),
                ),
                "conv_bwd": (
                    lambda: K.conv_bwd(plan, x, sh, emb, w1, w2, a0, a1, layout, g),
                    lambda: K.conv_bwd_plain(plan, x, sh, emb, w1, w2, a0, a1, layout, g),
                ),
            }
            dx_edge = K.conv_bwd_plain(plan, x, sh, emb, w1, w2, a0, a1, layout, g)[0]
            calls["scatter_rows"] = (
                lambda: K.scatter_rows(dx_edge, layout.src_perm, layout.src_ptr),
                lambda: K.scatter_rows_plain(dx_edge, layout.src_perm, layout.src_ptr),
            )
            for name, (kern, plain) in calls.items():
                before = K.KERNELS[name].launches
                got, ref = kern(), plain()
                torch.cuda.synchronize()
                if K.KERNELS[name].launches != before + 1:
                    raise RuntimeError(f"phase 2: {name} launch counter did not move")
                got = got if isinstance(got, tuple) else (got,)
                ref = ref if isinstance(ref, tuple) else (ref,)
                err = 0.0
                for out_i, (a, b) in enumerate(zip(got, ref)):
                    scale = float(b.abs().max())
                    diff = (a - b).abs()
                    if not bool(torch.isfinite(a).all()) or bool((diff > rtol * b.abs() + atol_rel * scale).any()):
                        raise RuntimeError(
                            f"phase 2: {name} output {out_i} layer {li} {dtype} disagrees with plain: "
                            f"max |diff| {float(diff.max()):.3e}, max |ref| {scale:.3e}"
                        )
                    err = max(err, float(diff.max()))
                ms = cuda_median_ms(kern, reps)
                plain_ms = cuda_median_ms(plain, reps)
                print(
                    f"phase 2 {name} layer {li} {str(dtype).split('.')[-1]}: max_abs_err {err:.3e}, "
                    f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms",
                    flush=True,
                )
                if dtype == torch.float32:
                    r = report[name]
                    r["max_abs_err"] = max(r["max_abs_err"], err)
                    r["ms"] += ms
                    r["plain_ms"] += plain_ms
            del x, sh, emb, w1, w2, g, dx_edge, calls
            torch.cuda.empty_cache()
    return report


def phase3_golden():
    import torch

    from nequip_tpu_torch.integrations import NequIPCalculator
    from nequip_tpu_torch.model import NequIPGNNModel, load_jax_params

    if not GOLDEN.exists():
        raise RuntimeError(f"phase 3: golden file {GOLDEN} is missing")
    z = np.load(GOLDEN)
    model = NequIPGNNModel(seed=0, model_dtype="float64", tp_impl="fused", **FLAGSHIP)
    load_jax_params(model, {k[len("params/"):]: z[k] for k in z.files if k.startswith("params/")})
    calc = NequIPCalculator.from_model(model, device="cuda")
    frame = {"pos": z["pos"], "cell": z["cell"], "pbc": z["pbc"], "atomic_numbers": z["atomic_numbers"]}
    res = calc.calculate(frame)
    e_err = abs(res["energy"] - float(z["energy"])) / abs(float(z["energy"]))
    f_err = float(np.abs(res["forces"] - z["forces"]).max())
    s_err = float(np.abs(res["stress"] - z["stress"]).max())
    print(
        f"phase 3 golden (f64, kernels): energy rel err {e_err:.3e}, forces max err {f_err:.3e}, "
        f"stress max err {s_err:.3e}",
        flush=True,
    )
    if not (e_err <= 1e-10 and f_err <= 1e-8 and s_err <= 1e-8):
        raise RuntimeError("phase 3: the port disagrees with the JAX golden")
    del model, calc
    torch.cuda.empty_cache()


def phase4_serve(n_atoms: int, n_requests: int = 3):
    import torch

    from nequip_tpu_torch.integrations import NequIPCalculator
    from nequip_tpu_torch.model import NequIPGNNModel
    from nequip_tpu_torch.ops.kernels import tp_scatter as K

    model = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", **FLAGSHIP)
    calc = NequIPCalculator.from_model(model, device="cuda")
    frames = [fcc_frame(n_atoms, seed=s, jitter=0.05) for s in range(1, n_requests + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    results = []
    for i, frame in enumerate(frames):
        res = calc.calculate(frame)
        results.append(res)
        print(
            f"phase 4 request {i}: {len(frame['pos'])} atoms, neighbour list "
            f"{calc.timings['neighbor_list_s'] * 1e3:.1f} ms (of prep {calc.timings['prepare_s'] * 1e3:.1f} ms), "
            f"model {calc.timings['model_s'] * 1e3:.1f} ms, "
            f"E {res['energy']:.6f}",
            flush=True,
        )
    launches = {k: fn.launches for k, fn in K.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 4 launches {launches}, max_memory_allocated {peak / 2**30:.3f} GiB", flush=True)
    for name, count in launches.items():
        if count == 0:
            raise RuntimeError(f"phase 4: kernel {name} was not launched on the main path")
    for i, res in enumerate(results):
        F = res["forces"]
        n = F.shape[0]
        drift = float(np.abs(F.sum(axis=0)).max())
        if not (math.isfinite(res["energy"]) and np.isfinite(F).all()):
            raise RuntimeError(f"phase 4: request {i} returned non-finite values")
        if drift > 1e-3 * float(np.abs(F).max()) * math.sqrt(n):
            raise RuntimeError(f"phase 4: request {i} net force {drift:.3e} breaks translation invariance")

    ref_model = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="torch", **FLAGSHIP)
    ref_model.load_state_dict(model.state_dict())
    ref = NequIPCalculator.from_model(ref_model, device="cuda").calculate(frames[0])
    e_rel = abs(ref["energy"] - results[0]["energy"]) / abs(ref["energy"])
    f_err = float(np.abs(ref["forces"] - results[0]["forces"]).max())
    f_scale = float(np.abs(ref["forces"]).max())
    print(
        f"phase 4 fused vs torch (f32, card): energy rel err {e_rel:.3e}, "
        f"forces max err {f_err:.3e} (max |F| {f_scale:.3e})",
        flush=True,
    )
    if not (e_rel <= 1e-5 and f_err <= 1e-4 * f_scale):
        raise RuntimeError("phase 4: fused and torch paths disagree")
    return launches


def main() -> int:
    sys.path.insert(0, str(ROOT))
    phase0_device()
    import torch

    t0 = time.perf_counter()
    phase1_build()
    report = phase2_kernels(n_atoms=23000, reps=10)
    phase3_golden()
    launches = phase4_serve(n_atoms=23000)

    from nequip_tpu_torch.ops.kernels.build import KERNEL_SOURCES

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": report[name]["max_abs_err"],
            "ms": report[name]["ms"],
            "plain_ms": report[name]["plain_ms"],
        }
        for name in REPLACES
    ]
    print(f"total {time.perf_counter() - t0:.1f} s after phase 0", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
