"""Version capture for package and artifact metadata.

Port of ``nequip_tpu/utils/versions.py``: the port's own version, torch's
(with the CUDA it was built for) and numpy's.
"""

from __future__ import annotations

import logging
from typing import Dict


def get_current_code_versions() -> Dict[str, str]:
    import numpy
    import torch

    from .. import __version__

    return {
        "nequip_tpu_torch": __version__,
        "torch": torch.__version__,
        "torch_cuda": str(torch.version.cuda),
        "numpy": numpy.__version__,
    }


def check_version_compatibility(saved: Dict[str, str]) -> None:
    """Warn (not fail) on version mismatches, like the reference's loaders."""
    current = get_current_code_versions()
    log = logging.getLogger("nequip_tpu_torch")
    for k, v in (saved or {}).items():
        if k in current and current[k] != v:
            log.warning(f"version mismatch for {k}: saved with {v}, running {current[k]}")
