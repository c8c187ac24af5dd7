"""Rank-aware logging.

Port of ``nequip_tpu/utils/logger.py``: under ``torch.distributed`` only
rank 0 logs by default; the rank is the process group's when one is
initialized, else 0.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch.distributed as dist


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class RankedLogger(logging.LoggerAdapter):
    def __init__(self, name: str = "nequip_tpu_torch", rank_zero_only: bool = True):
        super().__init__(logging.getLogger(name), {})
        self.rank_zero_only = rank_zero_only

    def log(self, level, msg, *args, rank: Optional[int] = None, **kwargs):
        if self.isEnabledFor(level):
            current = _rank()
            if self.rank_zero_only and current != 0 and rank is None:
                return
            if rank is not None and current != rank:
                return
            msg, kwargs = self.process(f"[rank {current}] {msg}", kwargs)
            self.logger.log(level, msg, *args, **kwargs)
