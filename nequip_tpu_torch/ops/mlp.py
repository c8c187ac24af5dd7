"""Scalar MLP with variance-preserving alpha-scaled weights.

Port of ``nequip_tpu/ops/mlp.py`` as the model uses it (bias-free, forward
weight init, uniform weights): weights are stored with unit variance
(uniform in [-sqrt(3), sqrt(3)]) as ``w{layer}`` of shape ``(h_in, h_out)``
and scaled at apply time by ``alpha = gain / sqrt(fan_in)`` (gain sqrt(2)
after a nonlinearity).  The MLP applies the RAW activation; the sqrt(2)
gain plays the variance-preserving role.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch import nn

from ..utils.dtype import get_default_dtype
from .activations import raw_activation

_SQRT3 = math.sqrt(3.0)


class ScalarMLP(nn.Module):
    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        hidden_layers_depth: int = 0,
        hidden_layers_width: Optional[int] = None,
        nonlinearity: Optional[str] = "silu",
    ):
        super().__init__()
        if hidden_layers_depth != 0 and not (hidden_layers_depth > 0 and hidden_layers_width):
            raise ValueError("hidden layers need a positive depth and width")
        self.dims: List[int] = (
            [input_dim] + hidden_layers_depth * [hidden_layers_width or 0] + [output_dim]
        )
        self.num_layers = len(self.dims) - 1
        self.nonlinearity = nonlinearity
        self._act = raw_activation(nonlinearity) if nonlinearity is not None else None
        self.alphas: List[float] = [
            (1.0 if nonlinearity is None or layer == 0 else math.sqrt(2.0)) / math.sqrt(h_in)
            for layer, h_in in enumerate(self.dims[:-1])
        ]
        dtype = get_default_dtype()
        for layer, (h_in, h_out) in enumerate(zip(self.dims, self.dims[1:])):
            self.register_parameter(f"w{layer}", nn.Parameter(torch.empty(h_in, h_out, dtype=dtype)))

    @property
    def output_dim(self) -> int:
        return self.dims[-1]

    def weight(self, layer: int) -> torch.Tensor:
        return getattr(self, f"w{layer}")

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in range(self.num_layers):
            w = self.weight(layer)
            w.copy_(torch.rand(w.shape, generator=generator, dtype=torch.float64) * (2 * _SQRT3) - _SQRT3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in range(self.num_layers):
            x = x @ (self.weight(layer).to(x.dtype) * self.alphas[layer])
            if self._act is not None and layer != self.num_layers - 1:
                x = self._act(x)
        return x
