"""Scalar activations, raw and second-moment normalised.

Port of ``nequip_tpu/ops/activations.py``.  ``normalized_activation``
rescales so that ``E_{z~N(0,1)}[act(z)^2] = 1`` (e3nn's convention, used by
the Gate); the constant comes from the same 128-point Gauss-Hermite
quadrature as the JAX package.  MLPs use the raw activation.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F


def shifted_softplus(x):
    return F.softplus(x) - math.log(2.0)


_BASE_ACTS = {
    "silu": F.silu,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "ssp": shifted_softplus,
    "tanh": torch.tanh,
    "abs": torch.abs,
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
    None: lambda x: x,
    "None": lambda x: x,
    "null": lambda x: x,
}

# parity of the activation itself: +1 even, -1 odd, 0 neither
_ACT_PARITY = {
    "tanh": -1,
    "abs": 1,
    None: -1,
    "None": -1,
    "null": -1,
}


def _np_softplus(x):
    return np.logaddexp(0.0, x)


_NP_ACTS = {
    "silu": lambda x: x / (1.0 + np.exp(-x)),
    "mish": lambda x: x * np.tanh(_np_softplus(x)),
    "gelu": lambda x: 0.5 * x * (1.0 + np.tanh(np.sqrt(2 / np.pi) * (x + 0.044715 * x**3))),
    "ssp": lambda x: _np_softplus(x) - math.log(2.0),
    "tanh": np.tanh,
    "abs": np.abs,
    "sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x)),
    "softplus": _np_softplus,
}


@lru_cache(maxsize=None)
def second_moment(name: Optional[str]) -> float:
    """E_{z~N(0,1)}[act(z)^2] via 128-point Gauss-Hermite quadrature."""
    if name in (None, "None", "null"):
        return 1.0
    nodes, weights = np.polynomial.hermite_e.hermegauss(128)
    w = weights / np.sqrt(2.0 * np.pi)
    return float(np.sum(w * _NP_ACTS[name](nodes) ** 2))


def raw_activation(name: Optional[str]) -> Callable:
    if name not in _BASE_ACTS:
        raise ValueError(f"unknown activation {name!r}; options: {list(_BASE_ACTS)}")
    return _BASE_ACTS[name]


def normalized_activation(name: Optional[str]) -> Callable:
    """Activation scaled so a unit-normal input keeps unit second moment."""
    fn = raw_activation(name)
    cst = second_moment(name) ** -0.5
    if cst == 1.0:
        return fn
    return lambda x: fn(x) * cst


def activation_parity(name: Optional[str]) -> int:
    return _ACT_PARITY.get(name, 0)
