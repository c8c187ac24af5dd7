"""Radial basis functions and cutoff envelopes.

Port of ``nequip_tpu/ops/radial.py``: the DimeNet polynomial envelope and
the ``sinc(x n) n`` Bessel basis of upstream NequIP.
"""

from __future__ import annotations

import math

import torch


def polynomial_cutoff(x: torch.Tensor, p: float = 6.0) -> torch.Tensor:
    """1 at x=0, 0 (with p-1 vanishing derivatives) at x=1; exactly 0 for x >= 1."""
    p = float(p)
    out = 1.0 - ((p + 1.0) * (p + 2.0) / 2.0) * torch.pow(x, p)
    out = out + p * (p + 2.0) * torch.pow(x, p + 1.0)
    out = out - (p * (p + 1.0) / 2.0) * torch.pow(x, p + 2.0)
    return out * (x < 1.0)


def sinc(x: torch.Tensor) -> torch.Tensor:
    """sin(pi x)/(pi x) with sinc(0) = 1 and a finite gradient there."""
    zero = x == 0
    px = math.pi * torch.where(zero, torch.ones_like(x), x)
    return torch.where(zero, torch.ones_like(x), torch.sin(px) / px)


def bessel_basis(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(..., 1) normalised lengths, (num_bessels,) weights -> (..., num_bessels)."""
    return sinc(x * weights) * weights
