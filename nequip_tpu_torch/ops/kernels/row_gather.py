"""Row gather ``out[i] = src[idx[i]]``, the ``x[src]`` gather of every conv.

Counterpart of ``pallas_row_gather`` of ``tools/gather_microbench.py`` (T5):
``row_gather`` launches ``csrc/row_gather.cu`` on CUDA tensors and runs its
plain twin ``row_gather_plain`` on CPU tensors.  The result is ``[E, D]``
with no padding (the TPU's row padding to 1024 floats was a Mosaic tiling
artefact, not part of the function).  ``block_e`` is the rows a block
copies, as on the TPU; ``n_buf`` is the warps of a block (``32 * n_buf``
threads).  The block copies its rows as one flat range of (row, 16-byte
unit) pairs, each thread with 8 loads in flight, so a block keeps ``n_buf *
32 * 8`` units in flight (on the TPU ``n_buf`` was the rows in flight).  The
defaults, 32 rows and 8 warps, were the fastest of the block shapes
measured on an H100 (PERF.md, T5 findings).
"""

from __future__ import annotations

import torch

from . import build
from .tp_scatter import KERNELS, _route


def row_gather_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return src[idx.long()]


def row_gather(src: torch.Tensor, idx: torch.Tensor, block_e: int = 32, n_buf: int = 8) -> torch.Tensor:
    """``out [E, D] = src [S, D] [idx [E]]`` for any dtype; ``idx`` is int32
    with every value in ``[0, S)`` (the kernel does not check; the plain
    twin raises on a bad index)."""
    if not _route("row_gather", src):
        return row_gather_plain(src, idx)
    if src.dim() != 2 or idx.dim() != 1:
        raise ValueError("row_gather: src must be [S, D] and idx [E]")
    if idx.device != src.device or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError("row_gather: idx must be contiguous int32 on src's device")
    if not (1 <= n_buf <= 32 and block_e >= 1):
        raise ValueError(f"row_gather: n_buf {n_buf} must lie in [1, 32] and block_e {block_e} be >= 1")
    out = torch.empty(idx.shape[0], src.shape[1], dtype=src.dtype, device=src.device)
    err = build.byte_entry_point("nequip_row_gather_bytes")(
        src.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0], src.shape[1] * src.element_size(),
        block_e, n_buf, torch.cuda.current_stream(src.device).cuda_stream,
    )
    build.check(err, "row_gather")
    row_gather.launches += 1
    return out


row_gather.launches = 0
KERNELS["row_gather"] = row_gather
