"""Segment sums with padding masks.

Port of ``nequip_tpu/ops/scatter.py``: masked rows are replaced by zeros
(``where``, so NaN or Inf in padding cannot leak) before an ``index_add``;
``scatter_mean`` divides by the unmasked count (at least 1).
"""

from __future__ import annotations

from typing import Optional

import torch


def scatter_sum(
    src: torch.Tensor,
    index: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sum rows of ``src`` (M, ...) into ``num_segments`` buckets by ``index`` (M,)."""
    if mask is not None:
        m = mask.reshape((-1,) + (1,) * (src.dim() - 1))
        src = torch.where(m, src, torch.zeros((), dtype=src.dtype, device=src.device))
    out = src.new_zeros((num_segments,) + tuple(src.shape[1:]))
    return out.index_add(0, index, src)


def scatter_mean(
    src: torch.Tensor,
    index: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    total = scatter_sum(src, index, num_segments, mask)
    count = scatter_sum(torch.ones(src.shape[:1], dtype=src.dtype, device=src.device), index, num_segments, mask)
    return total / torch.clamp(count, min=1).reshape((-1,) + (1,) * (src.dim() - 1))


def masked_gather(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[index]`` along the first axis (padded edges point at a real slot)."""
    return torch.index_select(x, 0, index)
