"""Clebsch-Gordan tensor products over irreps (the unfused oracle).

Port of ``nequip_tpu/ops/tensor_product.py``: the same instruction list,
the same normalisation (CG scaled by ``sqrt(2 l_out + 1)``, each path by
``1/sqrt(sum of fans into its output chunk)``) and the same flat weight
layout, so the radial MLP's output and the self-connection's shared weight
vector (``layer1_convnet.conv.sc``: 163,840 entries at the flagship's
width) carry over from the JAX package unchanged.  This plain-PyTorch TP is
what every hand-written kernel is held against.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .cg import cg_component_normalized
from .irreps import Irreps, MulIrrep


@dataclass(frozen=True)
class Instruction:
    i_in1: int
    i_in2: int
    i_out: int
    mode: str  # "uvu" | "uvw" | "uuu"
    has_weight: bool
    path_weight: float = 1.0


def _fan(mode: str, mul1: int, mul2: int) -> int:
    if mode == "uvw":
        return mul1 * mul2
    if mode == "uvu":
        return mul2
    if mode == "uuu":
        return 1
    raise ValueError(f"unknown TP mode {mode}")


class TensorProduct:
    """Static spec + apply for an instruction-based CG tensor product.

    Weights for ``uvu`` paths have shape ``(mul1, mul2)``, for ``uvw``
    ``(mul1, mul2, mul_out)``, for ``uuu`` ``(mul1,)``; flattened and
    concatenated in instruction order into ``weight_numel`` entries.
    """

    def __init__(self, irreps_in1, irreps_in2, irreps_out, instructions: Sequence[Tuple],
                 shared_weights: bool = False):
        self.irreps_in1 = Irreps(irreps_in1)
        self.irreps_in2 = Irreps(irreps_in2)
        self.irreps_out = Irreps(irreps_out)
        self.shared_weights = shared_weights

        ins = [Instruction(t[0], t[1], t[2], t[3], bool(t[4])) for t in instructions]
        for i in ins:
            ir1 = self.irreps_in1[i.i_in1].ir
            ir2 = self.irreps_in2[i.i_in2].ir
            ir3 = self.irreps_out[i.i_out].ir
            if ir3 not in set(ir1 * ir2):
                raise ValueError(f"invalid path {i}: {ir1} x {ir2} -/-> {ir3}")
            if i.mode == "uvu" and self.irreps_in1[i.i_in1].mul != self.irreps_out[i.i_out].mul:
                raise ValueError(f"uvu path {i} needs mul_in1 == mul_out")

        fan = [0.0] * len(self.irreps_out)
        for i in ins:
            fan[i.i_out] += _fan(i.mode, self.irreps_in1[i.i_in1].mul, self.irreps_in2[i.i_in2].mul)
        self.instructions: List[Instruction] = [
            replace(i, path_weight=float(fan[i.i_out]) ** -0.5) for i in ins
        ]

        self._weight_slices: List[Optional[slice]] = []
        self._weight_shapes: List[Optional[Tuple[int, ...]]] = []
        off = 0
        for i in self.instructions:
            if not i.has_weight:
                self._weight_slices.append(None)
                self._weight_shapes.append(None)
                continue
            mul1 = self.irreps_in1[i.i_in1].mul
            mul2 = self.irreps_in2[i.i_in2].mul
            shape = {
                "uvu": (mul1, mul2),
                "uvw": (mul1, mul2, self.irreps_out[i.i_out].mul),
                "uuu": (mul1,),
            }[i.mode]
            n = int(np.prod(shape))
            self._weight_slices.append(slice(off, off + n))
            self._weight_shapes.append(shape)
            off += n
        self.weight_numel = off
        self._cg_cache: Dict[Tuple[torch.dtype, torch.device], List[torch.Tensor]] = {}

    def _cgs(self, dtype: torch.dtype, device: torch.device) -> List[torch.Tensor]:
        key = (dtype, device)
        if key not in self._cg_cache:
            self._cg_cache[key] = [
                torch.as_tensor(
                    cg_component_normalized(
                        self.irreps_in1[i.i_in1].ir.l,
                        self.irreps_in2[i.i_in2].ir.l,
                        self.irreps_out[i.i_out].ir.l,
                    ),
                    dtype=dtype,
                    device=device,
                )
                for i in self.instructions
            ]
        return self._cg_cache[key]

    def __call__(self, x1: torch.Tensor, x2: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
        """x1 (..., dim1), x2 (..., dim2), weights (..., weight_numel) or
        (weight_numel,) when shared -> (..., dim_out)."""
        if x1.shape[-1] != self.irreps_in1.dim or x2.shape[-1] != self.irreps_in2.dim:
            raise ValueError(f"inputs {x1.shape}, {x2.shape} do not match {self.irreps_in1} x {self.irreps_in2}")
        batch = tuple(torch.broadcast_shapes(x1.shape[:-1], x2.shape[:-1]))
        sl1, sl2 = self.irreps_in1.slices(), self.irreps_in2.slices()
        cgs = self._cgs(x1.dtype, x1.device)

        chunks: List[Optional[torch.Tensor]] = [None] * len(self.irreps_out)
        for idx, ins in enumerate(self.instructions):
            mi1, mi2, mi3 = self.irreps_in1[ins.i_in1], self.irreps_in2[ins.i_in2], self.irreps_out[ins.i_out]
            c1 = x1[..., sl1[ins.i_in1]].reshape(tuple(x1.shape[:-1]) + (mi1.ir.dim, mi1.mul))
            c2 = x2[..., sl2[ins.i_in2]].reshape(tuple(x2.shape[:-1]) + (mi2.ir.dim, mi2.mul))
            cg = cgs[idx]
            w = None
            if ins.has_weight:
                if weights is None:
                    raise ValueError("weighted TP called without weights")
                w = weights[..., self._weight_slices[idx]]
                w = w.reshape(tuple(w.shape[:-1]) + self._weight_shapes[idx])

            if ins.mode == "uvu" and mi2.mul == 1:
                # conv hot path: outer product, then one CG matmul
                d1, d2, d3 = mi1.ir.dim, mi2.ir.dim, mi3.ir.dim
                z = (c1.unsqueeze(-2) * c2.unsqueeze(-3)).reshape(batch + (d1 * d2, mi1.mul))
                out = torch.einsum("...pu,pk->...ku", z, cg.reshape(d1 * d2, d3))
                if w is not None:
                    out = out * w[..., 0].unsqueeze(-2)
            elif ins.mode == "uvu":
                if w is None:
                    out = torch.einsum("ijk,...iu,...jv->...ku", cg, c1, c2)
                else:
                    out = torch.einsum("ijk,...iu,...jv,...uv->...ku", cg, c1, c2, w)
            elif ins.mode == "uvw":
                spec = "ijk,...iu,...jv,uvw->...kw" if self.shared_weights else "ijk,...iu,...jv,...uvw->...kw"
                out = torch.einsum(spec, cg, c1, c2, w)
            elif ins.mode == "uuu":
                if w is None:
                    out = torch.einsum("ijk,...iu,...ju->...ku", cg, c1, c2)
                else:
                    out = torch.einsum("ijk,...iu,...ju,...u->...ku", cg, c1, c2, w)
            else:
                raise ValueError(ins.mode)

            out = (out * ins.path_weight).reshape(batch + (mi3.dim,))
            prev = chunks[ins.i_out]
            chunks[ins.i_out] = out if prev is None else prev + out

        pieces = [
            x1.new_zeros(batch + (mi.dim,)) if c is None else c
            for mi, c in zip(self.irreps_out, chunks)
        ]
        return torch.cat(pieces, dim=-1)


def fully_connected_tensor_product(irreps_in1, irreps_in2, irreps_out) -> TensorProduct:
    """All-paths 'uvw' TP with shared weights (the self-connection)."""
    irreps_in1, irreps_in2, irreps_out = Irreps(irreps_in1), Irreps(irreps_in2), Irreps(irreps_out)
    instructions = [
        (i, j, k, "uvw", True)
        for i, mi1 in enumerate(irreps_in1)
        for j, mi2 in enumerate(irreps_in2)
        for k, mi3 in enumerate(irreps_out)
        if mi3.ir in set(mi1.ir * mi2.ir)
    ]
    return TensorProduct(irreps_in1, irreps_in2, irreps_out, instructions, shared_weights=True)


def uvu_instructions(
    irreps_in1: Irreps, irreps_in2: Irreps, irreps_out_filter: Irreps
) -> Tuple[Irreps, List[Tuple[int, int, int, str, bool]]]:
    """The NequIP conv instruction list, output irreps sorted by (l, p)."""
    irreps_mid: List[MulIrrep] = []
    instructions: List[Tuple[int, int, int, str, bool]] = []
    for i, mi1 in enumerate(irreps_in1):
        for j, mi2 in enumerate(irreps_in2):
            for ir_out in mi1.ir * mi2.ir:
                if ir_out in irreps_out_filter:
                    instructions.append((i, j, len(irreps_mid), "uvu", True))
                    irreps_mid.append(MulIrrep(mi1.mul, ir_out))
    irreps_mid, perm, _ = Irreps(irreps_mid).sort()
    instructions = [(i1, i2, perm[io], mode, w) for (i1, i2, io, mode, w) in instructions]
    return irreps_mid, instructions
