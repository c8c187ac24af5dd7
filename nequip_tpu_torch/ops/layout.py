"""Feature-layout converters: e3nn's mul_ir <-> this package's ir_mul.

Port of ``nequip_tpu/ops/layout.py`` for numpy arrays and torch tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .irreps import Irreps


def _convert(x, irreps, to_ir_mul: bool):
    irreps = Irreps(irreps)
    if x.shape[-1] != irreps.dim:
        raise ValueError(f"last axis {x.shape[-1]} != irreps dim {irreps.dim}")
    if all(mi.mul == 1 or mi.ir.dim == 1 for mi in irreps):
        return x
    base = tuple(x.shape[:-1])
    chunks = []
    for sl, mi in zip(irreps.slices(), irreps):
        c = x[..., sl]
        if mi.mul > 1 and mi.ir.dim > 1:
            shape = (mi.mul, mi.ir.dim) if to_ir_mul else (mi.ir.dim, mi.mul)
            c = c.reshape(base + shape).swapaxes(-1, -2).reshape(base + (mi.dim,))
        chunks.append(c)
    if isinstance(x, torch.Tensor):
        return torch.cat(chunks, dim=-1)
    return np.concatenate(chunks, axis=-1)


def mul_ir_to_ir_mul(x, irreps):
    """Convert the last axis from e3nn (mul-major) to ir_mul (m-major)."""
    return _convert(x, irreps, to_ir_mul=True)


def ir_mul_to_mul_ir(x, irreps):
    """Convert the last axis from ir_mul (m-major) to e3nn (mul-major)."""
    return _convert(x, irreps, to_ir_mul=False)
