"""Profile the flagship's training step and serving on one NVIDIA GPU.

    python3 chip_profile.py [--out build/profile]

For each training case, ``tp_impl`` x ``force_grad_mode`` x
``fr_edge_chunks`` (rr with ``"fused"`` and ``"fused_tp"``; fr with
``"fused"`` unchunked and over 4 slices, and ``"fused_tp"`` over 4
slices; rr ``"fused"`` again with the ZBL prior of ``tutorial.yaml``):
two warm-up training steps (f32, one 23,328-atom LJ frame,
``EnergyForceLoss``, Adam), five timed steps (host clock, synchronised)
with their peak device memory, then two steps under ``torch.profiler``
whose device kernel time per step is printed by kernel name, with the busy
share (kernel time / profiled wall time).  The full profiler table goes to
``<out>/profile_train_<impl>_<mode><chunks>[_zbl].txt``.  Then the model time of
warm 23k-atom calculator requests per impl, two rounds each (``--serve-only``:
these alone).  Needs CUDA;
the flagship and frame generator are those of ``chip_smoke.py``.
"""

import argparse
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import FLAGSHIP, ZBL, fcc_frame
from nequip_tpu_torch.data import DataLoader
from nequip_tpu_torch.data.dataset import LJTestDataset
from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper, NeighborListTransform
from nequip_tpu_torch.integrations import NequIPCalculator
from nequip_tpu_torch.model import NequIPGNNModel
from nequip_tpu_torch.ops.kernels.tp_scatter import relayout_edge_stream
from nequip_tpu_torch.train import EnergyForceLoss, NequIPTrainModule

IMPLS = ("fused", "fused_tp")
# (tp_impl, force_grad_mode, fr_edge_chunks, with the ZBL prior)
TRAIN_CASES = (("fused", "rr", 0, False), ("fused_tp", "rr", 0, False), ("fused", "fr", 0, False),
               ("fused", "fr", 4, False), ("fused_tp", "fr", 4, False), ("fused", "rr", 0, True))


def profile_training(impl: str, mode: str, n_chunks: int, zbl: bool, batch: dict, out_dir: Path, smi: str) -> None:
    model = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl=impl, pair_potential=ZBL if zbl else None,
                           **FLAGSHIP).to("cuda")
    module = NequIPTrainModule(model, loss=EnergyForceLoss(type_names=["Cu"]), force_grad_mode=mode,
                               fr_edge_chunks=n_chunks)
    for _ in range(2):
        module.training_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        module.training_step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            module.training_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / 2 * 1e3
    ka = prof.key_averages()
    dev = sorted(
        ((e.key, e.device_time_total / 1e3 / 2, e.count / 2) for e in ka
         if e.device_time_total > 0 and e.device_type.name == "CUDA"),
        key=lambda r: -r[1],
    )
    total = sum(r[1] for r in dev)
    print(f"train {impl} {mode} chunks {n_chunks}{' zbl' if zbl else ''}: step ms {[round(t * 1e3, 1) for t in times]} median {np.median(times) * 1e3:.1f}; "
          f"peak {peak / 2**30:.3f} GiB; profiled wall/step {wall_ms:.1f} ms, device kernel time/step "
          f"{total:.1f} ms, busy {total / wall_ms:.1%} ({smi})", flush=True)
    for key, ms, count in dev[:25]:
        print(f"  {ms:9.3f} ms/step {count:6.1f}x  {key[:110]}")
    (out_dir / f"profile_train_{impl}_{mode}{n_chunks}{'_zbl' if zbl else ''}.txt").write_text(ka.table(sort_by="device_time_total", row_limit=60))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=Path("build/profile"))
    ap.add_argument("--serve-only", action="store_true", help="time the calculator requests only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    args.out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if not args.serve_only:
        ds = LJTestDataset(supercell=(18,) * 3, num_frames=1, seed=0,
                           transforms=[ChemicalSpeciesToAtomTypeMapper(["Cu"]), NeighborListTransform(4.0)])
        batch = relayout_edge_stream(next(iter(DataLoader(ds, batch_size=1, device="cuda"))))
        for case in TRAIN_CASES:
            profile_training(*case, batch, args.out, smi)
            torch.cuda.empty_cache()
    for impl in IMPLS * 2:
        calc = NequIPCalculator.from_model(
            NequIPGNNModel(seed=0, model_dtype="float32", tp_impl=impl, **FLAGSHIP), device="cuda")
        ms = []
        for seed in range(1, 5):
            calc.calculate(fcc_frame(23000, seed=seed))
            ms.append(calc.timings["model_s"] * 1e3)
        print(f"serve {impl}: model ms {[round(m, 1) for m in ms]} (the first is warm-up; {smi})", flush=True)


if __name__ == "__main__":
    main()
