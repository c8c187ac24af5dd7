"""The device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising when a CUDA device is asked for and
    none is available, rather than carrying on on the CPU.  Entry points
    default to ``"cuda"``; a caller asks for the CPU with ``"cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r}: no CUDA device is available (torch.cuda.is_available() is False); "
            "pass device='cpu' to run on the CPU"
        )
    return dev
