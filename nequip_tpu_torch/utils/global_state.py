"""Process-wide numerical state.

Port of ``nequip_tpu/utils/global_state.py`` for PyTorch: the TF32 switch
sets ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` (PyTorch's matmuls and convolutions;
the port's CUDA kernels compute in the model's dtype either way), and a
seed seeds PyTorch's global generators.  Model weights come from their
own seeded generator (``model/utils.py``), so the seed does not
change them.
"""

from __future__ import annotations

from typing import Optional

import torch

_GLOBAL_STATE = {"initialized": False, "allow_tf32": False}


def set_global_state(allow_tf32: bool = False, seed: Optional[int] = None) -> None:
    _GLOBAL_STATE["initialized"] = True
    set_tf32(allow_tf32)
    if seed is not None:
        torch.manual_seed(int(seed))


def set_tf32(enabled: bool) -> None:
    _GLOBAL_STATE["allow_tf32"] = bool(enabled)
    torch.backends.cuda.matmul.allow_tf32 = bool(enabled)
    torch.backends.cudnn.allow_tf32 = bool(enabled)


def tf32_enabled() -> bool:
    return bool(_GLOBAL_STATE["allow_tf32"])
