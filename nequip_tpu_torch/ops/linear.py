"""Equivariant linear maps over irreps (per-l block matmuls).

Port of ``nequip_tpu/ops/linear.py``.  In the ir_mul layout a linear map is,
per output chunk, a sum of ``(..., 2l+1, mul_in) @ (mul_in, mul_out)``
matmuls over the input chunks with the same irrep.  Weights ``w{i}_{j}``
are stored with unit variance and each path is scaled at apply time by
``1/sqrt(sum of contributing mul_in)`` (e3nn's "element" normalisation).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ..utils.dtype import param_dtype
from .irreps import Irreps


class Linear(nn.Module):
    def __init__(self, irreps_in, irreps_out):
        super().__init__()
        self.irreps_in = Irreps(irreps_in)
        self.irreps_out = Irreps(irreps_out)
        self.instructions: List[Tuple[int, int]] = [
            (i, j)
            for i, mi_in in enumerate(self.irreps_in)
            for j, mi_out in enumerate(self.irreps_out)
            if mi_in.ir == mi_out.ir
        ]
        fan = [0] * len(self.irreps_out)
        for i, j in self.instructions:
            fan[j] += self.irreps_in[i].mul
        self._alpha = [float(f) ** -0.5 if f > 0 else 0.0 for f in fan]
        dtype = param_dtype()  # float32 in a bfloat16 model: cast at use
        for i, j in self.instructions:
            shape = (self.irreps_in[i].mul, self.irreps_out[j].mul)
            self.register_parameter(f"w{i}_{j}", nn.Parameter(torch.empty(shape, dtype=dtype)))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for i, j in self.instructions:
            w = getattr(self, f"w{i}_{j}")
            w.copy_(torch.randn(w.shape, generator=generator, dtype=torch.float64))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.irreps_in.dim:
            raise ValueError(f"input dim {x.shape[-1]} != {self.irreps_in}")
        sl_in = self.irreps_in.slices()
        batch = tuple(x.shape[:-1])
        out: List[Optional[torch.Tensor]] = [None] * len(self.irreps_out)
        for i, j in self.instructions:
            mi = self.irreps_in[i]
            c = x[..., sl_in[i]].reshape(batch + (mi.ir.dim, mi.mul))
            y = c @ (getattr(self, f"w{i}_{j}").to(x.dtype) * self._alpha[j])
            out[j] = y if out[j] is None else out[j] + y
        pieces = [
            x.new_zeros(batch + (mi.dim,)) if c is None else c.reshape(batch + (mi.dim,))
            for mi, c in zip(self.irreps_out, out)
        ]
        return torch.cat(pieces, dim=-1)
