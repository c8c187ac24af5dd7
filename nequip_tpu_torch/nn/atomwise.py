"""Atomwise operations: linear maps, per-type scale/shift, per-frame sums.

Port of ``nequip_tpu/nn/atomwise.py``.  The scale/shift runs in the global
dtype (float64); padded nodes are masked out of the frame sum.  Fixed
per-type scales and shifts are buffers, trainable ones parameters, at the
same paths of the JAX tree (a trainable single value becomes one value per
type, as in JAX).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..data import _keys
from ..data._key_registry import get_field_type
from ..ops.irreps import Irreps
from ..ops.linear import Linear
from ..ops.scatter import scatter_mean, scatter_sum
from ..utils.dtype import GLOBAL_DTYPE
from .module import GraphModule


class AtomwiseOperation(GraphModule):
    """Apply a per-atom operation to a field: a callable with ``irreps_in``
    and ``irreps_out``; an ``nn.Module``'s parameters sit under this
    module's own path, as in JAX."""

    _jax_transparent = ("operation",)

    def __init__(self, operation, field: str, irreps_in=None):
        super().__init__()
        self.operation = operation
        self.field = field
        self._init_irreps(
            irreps_in=irreps_in,
            my_irreps_in={field: getattr(operation, "irreps_in", None)},
            irreps_out={field: getattr(operation, "irreps_out", None)},
        )

    def forward(self, data: dict) -> dict:
        data = dict(data)
        data[self.field] = self.operation(data[self.field])
        return data


class AtomwiseLinear(GraphModule):
    """An equivariant linear map of a node field (``ops.linear.Linear``)."""

    _jax_transparent = ("linear",)

    def __init__(self, field: str = _keys.NODE_FEATURES_KEY, out_field: Optional[str] = None, irreps_in=None,
                 irreps_out=None):
        super().__init__()
        self.field = field
        self.out_field = out_field if out_field is not None else field
        if irreps_out is None:
            irreps_out = Irreps(irreps_in[field])
        self._init_irreps(irreps_in=irreps_in, required_irreps_in=[field],
                          irreps_out={self.out_field: Irreps(irreps_out)})
        self.linear = Linear(self.irreps_in[field], self.irreps_out[self.out_field])

    def forward(self, data: dict) -> dict:
        data = dict(data)
        data[self.out_field] = self.linear(data[self.field])
        return data

    def jvp(self, data: dict, tangents: dict):
        """Hand rule (JAX ``AtomwiseLinear.jvp``): the map is linear in the
        field, so the tangent goes through the same map."""
        out = self(data)
        t_out = dict(tangents)
        t_in = tangents.get(self.field)
        if t_in is not None:
            t_out[self.out_field] = self.linear(t_in)
        elif self.out_field != self.field:
            t_out.pop(self.out_field, None)
        return out, t_out


class AtomwiseReduce(GraphModule):
    """Sum (or mean, or sum over sqrt(avg_num_atoms): ``normalized_sum``) a
    node field into a per-frame field, padded nodes masked out."""

    def __init__(self, field: str, out_field: Optional[str] = None, reduce: str = "sum",
                 avg_num_atoms: Optional[float] = None, irreps_in=None):
        super().__init__()
        if reduce not in ("sum", "mean", "normalized_sum"):
            raise ValueError(f"reduce must be 'sum', 'mean' or 'normalized_sum', got {reduce!r}")
        self.constant = 1.0
        if reduce == "normalized_sum":
            if avg_num_atoms is None:
                raise ValueError("reduce='normalized_sum' needs avg_num_atoms")
            self.constant = float(avg_num_atoms) ** -0.5
            reduce = "sum"
        self.reduce = reduce
        self.field = field
        self.out_field = f"{reduce}_{field}" if out_field is None else out_field
        irreps_in = irreps_in or {}
        self._init_irreps(
            irreps_in=irreps_in,
            irreps_out={self.out_field: irreps_in[field]} if field in irreps_in else {},
        )

    def forward(self, data: dict) -> dict:
        field = data[self.field]
        num_frames = data[_keys.NUM_NODES_KEY].shape[0]
        batch = data[_keys.BATCH_KEY].reshape(-1)
        mask = data.get(_keys.NODE_MASK_KEY)
        reduce = scatter_sum if self.reduce == "sum" else scatter_mean
        result = reduce(field, batch, num_frames, mask=mask)
        data = dict(data)
        data[self.out_field] = result * self.constant if self.constant != 1.0 else result
        return data


class PerTypeScaleShift(GraphModule):
    """out = shift[type] + scale[type] * in, computed in float64."""

    def __init__(
        self,
        type_names: List[str],
        field: str,
        out_field: Optional[str] = None,
        scales: Optional[Union[float, Dict[str, float]]] = None,
        shifts: Optional[Union[float, Dict[str, float]]] = None,
        scales_trainable: bool = False,
        shifts_trainable: bool = False,
        irreps_in=None,
    ):
        super().__init__()
        self.type_names = list(type_names)
        self.num_types = len(type_names)
        self.field = field
        self.out_field = field if out_field is None else out_field
        if get_field_type(self.field) != "node" or get_field_type(self.out_field) != "node":
            raise ValueError("PerTypeScaleShift acts on node fields")
        self._init_irreps(
            irreps_in=irreps_in,
            my_irreps_in={self.field: Irreps("1x0e")},
            irreps_out={self.out_field: Irreps(irreps_in[self.field])},
        )
        self.scales_trainable = bool(scales_trainable)
        self.shifts_trainable = bool(shifts_trainable)
        for name, v, trainable in (("scales", scales, scales_trainable), ("shifts", shifts, shifts_trainable)):
            if v is None:
                setattr(self, name, None)
                continue
            if isinstance(v, (int, float)):
                vals = np.full(self.num_types if trainable else 1, float(v))
            elif isinstance(v, dict):
                if set(self.type_names) != set(v):
                    raise ValueError(f"per-type {name} must cover type_names {self.type_names}")
                vals = np.array([float(v[k]) for k in self.type_names])
            elif isinstance(v, (list, tuple, np.ndarray)):
                vals = np.asarray(v, dtype=float).reshape(-1)
                if vals.size not in (1, self.num_types):
                    raise ValueError(f"{name} must have one value or one per type")
                if trainable and vals.size == 1:
                    vals = np.full(self.num_types, vals[0])
            else:
                raise TypeError(f"{name} must be a float, a list or a dict over type_names")
            self.set_values(name, vals)

    def set_values(self, name: str, vals, device=None) -> None:
        """Set ``scales`` or ``shifts`` to ``vals`` (one value, or one per
        type): a parameter if that kind is trainable, else a buffer."""
        value = torch.as_tensor(np.asarray(vals, dtype=float).reshape(-1, 1), dtype=GLOBAL_DTYPE, device=device)
        if hasattr(self, name):
            delattr(self, name)
        if getattr(self, f"{name}_trainable"):
            setattr(self, name, torch.nn.Parameter(value))
        else:
            self.register_buffer(name, value)

    def forward(self, data: dict) -> dict:
        x = data[self.field].to(GLOBAL_DTYPE)
        types = data[_keys.ATOM_TYPE_KEY].reshape(-1)

        def lookup(v):
            return v if v.shape[0] == 1 else v[types]

        if self.scales is not None:
            x = lookup(self.scales) * x
        if self.shifts is not None:
            x = lookup(self.shifts) + x
        data = dict(data)
        data[self.out_field] = x
        return data
