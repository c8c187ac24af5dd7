"""Scalar MLP with variance-preserving alpha-scaled weights.

Port of ``nequip_tpu/ops/mlp.py``: weights are stored with unit variance
(uniform in [-sqrt(3), sqrt(3)], or standard normal) as ``w{layer}`` of
shape ``(h_in, h_out)`` and scaled at apply time by ``alpha = gain /
sqrt(norm_dim)``: ``norm_dim`` is the fan-in (forward init) or the fan-out
(backward init), and the gain is sqrt(2) for a layer next to a
nonlinearity.  The MLP applies the RAW activation; the sqrt(2) gain plays
the variance-preserving role.  Optional leaves: ``b{layer}`` (``bias``) and
``g{layer}`` (the ``weight_norm`` magnitudes).

``parametrization`` maps the stored ``w{layer}`` to the weight the layer
applies, as in JAX: ``weight_norm`` (``g * v / |v|`` row by row),
``spectral_norm`` (``v / sigma_max(v)``) or ``orthogonal`` (the sign-fixed
QR factor).  As in JAX, the last two compute in float32 whatever the model
dtype, so a float64 model agrees with JAX there at float32 tolerance only.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from ..utils.dtype import param_dtype
from .activations import raw_activation

_SQRT3 = math.sqrt(3.0)
PARAMETRIZATIONS = ("weight_norm", "spectral_norm", "orthogonal")


class ScalarMLP(nn.Module):
    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        hidden_layers_depth: int = 0,
        hidden_layers_width: Optional[int] = None,
        nonlinearity: Optional[str] = "silu",
        bias: bool = False,
        forward_weight_init: bool = True,
        init_mode: str = "uniform",
        parametrization: Optional[str] = None,
    ):
        super().__init__()
        if parametrization in ("None", "null"):
            parametrization = None
        if parametrization is not None and parametrization not in PARAMETRIZATIONS:
            raise ValueError(f"unknown parametrization {parametrization!r}")
        if init_mode not in ("uniform", "normal"):
            raise ValueError(f"init_mode must be 'uniform' or 'normal', got {init_mode!r}")
        if hidden_layers_depth != 0 and not (hidden_layers_depth > 0 and hidden_layers_width):
            raise ValueError("hidden layers need a positive depth and width")
        self.dims: List[int] = (
            [input_dim] + hidden_layers_depth * [hidden_layers_width or 0] + [output_dim]
        )
        self.num_layers = len(self.dims) - 1
        self.nonlinearity = nonlinearity
        self.bias = bool(bias)
        self.init_mode = init_mode
        self.parametrization = parametrization
        self._act = raw_activation(nonlinearity) if nonlinearity is not None else None
        self.alphas: List[float] = []
        for layer, (h_in, h_out) in enumerate(zip(self.dims, self.dims[1:])):
            if forward_weight_init:
                norm_dim, plain = h_in, nonlinearity is None or layer == 0
            else:
                norm_dim, plain = h_out, nonlinearity is None or layer == self.num_layers - 1
            self.alphas.append((1.0 if plain else math.sqrt(2.0)) / math.sqrt(norm_dim))
        dtype = param_dtype()  # float32 in a bfloat16 model: cast at use
        self._leaf_names: List[str] = []
        for layer, (h_in, h_out) in enumerate(zip(self.dims, self.dims[1:])):
            shapes = {f"w{layer}": (h_in, h_out)}
            if parametrization == "weight_norm":
                shapes[f"g{layer}"] = (h_in,)
            if self.bias:
                shapes[f"b{layer}"] = (h_out,)
            for name, shape in shapes.items():
                self.register_parameter(name, nn.Parameter(torch.empty(shape, dtype=dtype)))
                self._leaf_names.append(name)

    @property
    def output_dim(self) -> int:
        return self.dims[-1]

    def weight(self, layer: int) -> torch.Tensor:
        return getattr(self, f"w{layer}")

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in range(self.num_layers):
            w = self.weight(layer)
            if self.init_mode == "uniform":
                w.copy_(torch.rand(w.shape, generator=generator, dtype=torch.float64) * (2 * _SQRT3) - _SQRT3)
            else:
                w.copy_(torch.randn(w.shape, generator=generator, dtype=torch.float64))
            if self.parametrization == "weight_norm":
                # the row norms: the initial effective weight is the plain one
                getattr(self, f"g{layer}").copy_(torch.linalg.vector_norm(w, dim=1))
            if self.bias:
                getattr(self, f"b{layer}").zero_()

    def weights(self) -> List[torch.Tensor]:
        """Every leaf (``w``, ``g``, ``b`` of each layer, in layer order): the
        argument ``with_weights`` takes."""
        return [getattr(self, name) for name in self._leaf_names]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.with_weights(x, self.weights())

    def _parametrized(self, leaves: Dict[str, torch.Tensor], layer: int, dtype) -> torch.Tensor:
        v = leaves[f"w{layer}"].to(dtype)
        p = self.parametrization
        if p is None:
            return v
        if p == "weight_norm":
            g = leaves[f"g{layer}"].to(dtype)
            return g[:, None] * v / (torch.linalg.vector_norm(v, dim=1, keepdim=True) + 1e-12)
        if p == "spectral_norm":
            sigma = torch.linalg.matrix_norm(v.to(torch.float32), ord=2).to(dtype)
            return v / (sigma + 1e-12)
        # orthogonal: the QR factor with the signs of R's diagonal folded in
        tall = v.shape[0] >= v.shape[1]
        m = v.to(torch.float32) if tall else v.to(torch.float32).t()
        q, r = torch.linalg.qr(m)
        q = q * torch.sign(torch.diagonal(r))[None, :]
        return (q if tall else q.t()).to(dtype)

    def with_weights(self, x: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
        """The MLP with the given leaves (``weights()``'s order) in place of
        its own (the edge-chunked convolutions differentiate it with respect
        to them)."""
        leaves = dict(zip(self._leaf_names, weights))
        for layer in range(self.num_layers):
            x = x @ (self._parametrized(leaves, layer, x.dtype) * self.alphas[layer])
            if self.bias:
                x = x + leaves[f"b{layer}"].to(x.dtype)
            if self._act is not None and layer != self.num_layers - 1:
                x = self._act(x)
        return x
