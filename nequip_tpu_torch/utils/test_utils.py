"""Equivariance and permutation checks for models of the port.

Port of ``nequip_tpu/utils/test_utils.py``, an assertion library that
downstream model packages run on their own models:

* ``assert_permutation_equivariant``: outputs permute with a random node
  permutation;
* ``assert_O3_equivariant``: scalars invariant, forces rotating, cartesian
  rank-2 tensors (stress, virial) conjugated, under proper and improper
  rotations.

``model`` is a ``GraphModel``; the frames are host dicts with an edge list,
padded to ``capacities`` (nodes, edges, frames) and moved to ``device``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data import _keys, batched_from_list, pad_batch, to_tensors
from ..data._key_registry import _CARTESIAN_TENSOR_FIELDS, get_field_type
from ..ops.cg import random_rotation


def run_padded(model, frames, capacities=(128, 1024, 2), device="cpu") -> dict:
    """The model's outputs on ``frames`` padded to ``capacities``, as numpy."""
    out = model(to_tensors(pad_batch(batched_from_list(list(frames)), *capacities), device))
    return {k: v.detach().cpu().numpy() for k, v in out.items() if isinstance(v, torch.Tensor)}


def assert_permutation_equivariant(model, frame: dict, capacities=(128, 1024, 2), tol: Optional[float] = None,
                                   seed: int = 0, device="cpu"):
    tol = 1e-8 if tol is None else tol
    n = frame[_keys.POSITIONS_KEY].shape[0]
    perm = np.random.RandomState(seed).permutation(n)
    inv = np.empty(n, dtype=np.int32)
    inv[perm] = np.arange(n, dtype=np.int32)
    out = run_padded(model, [frame], capacities, device)
    frame_p = dict(frame)
    for k, v in frame.items():
        if get_field_type(k, error_on_unregistered=False) == "node":
            frame_p[k] = np.asarray(v)[perm]
    frame_p[_keys.EDGE_INDEX_KEY] = inv[frame[_keys.EDGE_INDEX_KEY]]
    out_p = run_padded(model, [frame_p], capacities, device)
    for k, v in out.items():
        if v.dtype.kind in "bi":
            continue  # masks and index fields
        ftype = get_field_type(k, error_on_unregistered=False)
        if ftype == "node":
            a, b = v[:n][perm], out_p[k][:n]
        elif ftype == "graph":
            a, b = v[:1], out_p[k][:1]
        else:
            continue
        err = np.abs(a - b).max() if a.size else 0.0
        assert err <= tol, f"permutation equivariance failed for {k}: {err:.2e}"


def assert_O3_equivariant(model, frame: dict, capacities=(128, 1024, 2), tol: float = 1e-8, n_trials: int = 2,
                          test_parity: bool = True, seed: int = 0, device="cpu"):
    rng = np.random.RandomState(seed)
    n = frame[_keys.POSITIONS_KEY].shape[0]
    out = run_padded(model, [frame], capacities, device)
    rotations = [random_rotation(rng) for _ in range(n_trials)]
    if test_parity:
        rotations += [-random_rotation(rng)]
    for R in rotations:
        frame_r = dict(frame)
        frame_r[_keys.POSITIONS_KEY] = frame[_keys.POSITIONS_KEY] @ R.T
        if _keys.CELL_KEY in frame:
            frame_r[_keys.CELL_KEY] = (np.asarray(frame[_keys.CELL_KEY]).reshape(3, 3) @ R.T).reshape(1, 3, 3)
        out_r = run_padded(model, [frame_r], capacities, device)
        for k in (_keys.TOTAL_ENERGY_KEY, _keys.PER_ATOM_ENERGY_KEY):
            if k in out:
                lim = n if get_field_type(k) == "node" else 1
                err = np.abs(out[k][:lim] - out_r[k][:lim]).max()
                assert err <= tol, f"O(3) invariance failed for {k}: {err:.2e}"
        if _keys.FORCE_KEY in out:
            err = np.abs(out[_keys.FORCE_KEY][:n] @ R.T - out_r[_keys.FORCE_KEY][:n]).max()
            assert err <= tol, f"O(3) equivariance failed for forces: {err:.2e}"
        for k in _CARTESIAN_TENSOR_FIELDS:
            if k in out and get_field_type(k) == "graph":
                err = np.abs(R @ out[k][0] @ R.T - out_r[k][0]).max()
                assert err <= tol, f"O(3) equivariance failed for {k}: {err:.2e}"
