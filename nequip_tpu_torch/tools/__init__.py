"""Command-line tools of the port (``python -m nequip_tpu_torch.tools.<name>``).

``kernel_microbench`` times the conv-block kernels T1-T4 on one constant
chunk of edges; ``gather_microbench`` times the row gather T5 against
``torch.index_select``.  Both run on the card unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable

import torch

# published peaks of one H100 SXM (700 W)
HBM_BYTES_S, F32_FLOP_S, TF32_FLOP_S = 3.35e12, 67e12, 495e12


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or a
    line saying that the run is on the CPU."""
    if device.type != "cuda":
        return "device: cpu (plain PyTorch versions, no card)"
    index = device.index if device.index is not None else torch.cuda.current_device()
    smi = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return smi.stdout.strip().splitlines()[0]


def time_ms(fn: Callable[[], object], reps: int, device: torch.device) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls after one warm-up
    call; CUDA events around the calls on the card, the host clock on the
    CPU."""
    fn()
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3
