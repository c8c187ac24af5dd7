"""Gated equivariant nonlinearity.

Port of ``nequip_tpu/ops/gate.py``.  Input layout
``irreps_scalars + irreps_gates + irreps_gated``; output
``act_s(scalars) + act_g(gates) * gated`` (gates broadcast over the
m-dimension), i.e. ``irreps_scalars + irreps_gated``.  Scalar activations
are second-moment normalised.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .activations import activation_parity, normalized_activation
from .irreps import Irreps


class Gate:
    def __init__(
        self,
        irreps_scalars,
        act_scalars: Sequence[Optional[str]],
        irreps_gates,
        act_gates: Sequence[Optional[str]],
        irreps_gated,
    ):
        self.irreps_scalars = Irreps(irreps_scalars)
        self.irreps_gates = Irreps(irreps_gates)
        self.irreps_gated = Irreps(irreps_gated)
        if len(act_scalars) != len(self.irreps_scalars) or len(act_gates) != len(self.irreps_gates):
            raise ValueError("one activation per scalar and per gate chunk")
        if self.irreps_gates.num_irreps != self.irreps_gated.num_irreps:
            raise ValueError(
                f"need one gate per gated channel: {self.irreps_gates} vs {self.irreps_gated}"
            )
        for mi, act in zip(self.irreps_scalars, act_scalars):
            if mi.ir.l != 0 or (mi.ir.p == -1 and activation_parity(act) != -1):
                raise ValueError(f"scalar chunk {mi} cannot take activation {act}")
        self._act_scalars = [normalized_activation(a) for a in act_scalars]
        self._act_gates = [normalized_activation(a) for a in act_gates]
        self.irreps_in = self.irreps_scalars + self.irreps_gates + self.irreps_gated
        self.irreps_out = (self.irreps_scalars + self.irreps_gated).simplify()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.irreps_in.dim:
            raise ValueError(f"input dim {x.shape[-1]} != {self.irreps_in}")
        batch = tuple(x.shape[:-1])
        d_s, d_g = self.irreps_scalars.dim, self.irreps_gates.dim
        scalars, gates, gated = x[..., :d_s], x[..., d_s : d_s + d_g], x[..., d_s + d_g :]
        out = [act(scalars[..., sl]) for sl, act in zip(self.irreps_scalars.slices(), self._act_scalars)]
        g_chunks = [act(gates[..., sl]) for sl, act in zip(self.irreps_gates.slices(), self._act_gates)]
        g = torch.cat(g_chunks, dim=-1) if g_chunks else gates
        off = 0
        for mi, sl in zip(self.irreps_gated, self.irreps_gated.slices()):
            chunk = gated[..., sl].reshape(batch + (mi.ir.dim, mi.mul))
            gate = g[..., off : off + mi.mul].unsqueeze(-2)
            out.append((chunk * gate).reshape(batch + (mi.dim,)))
            off += mi.mul
        return torch.cat(out, dim=-1)
