"""AtomicDataDict: the single inter-module data structure.

Port of the parts of ``nequip_tpu/data/atomic_data_dict.py`` that the
single-point path uses.  Host-side frames are plain numpy dicts (float64);
``batched_from_list`` concatenates frames; ``pad_batch`` pads nodes, edges
and frames to fixed capacities with the same contract as the JAX package
(``docs/design.md`` section 1):

* padded edges point at the LAST node slot with zero shift and are masked;
* padded nodes belong to the last (padded) frame where one exists;
* masks ``node_mask``/``edge_mask``/``frame_mask`` are True for real rows.

``to_tensors`` moves a padded numpy dict onto a torch device: floats become
float64 (the global dtype the geometry and the energy sum run in), integers
int64 (torch's index type).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from . import _keys
from ._key_registry import (
    _CARTESIAN_TENSOR_FIELDS,
    _LONG_FIELDS,
    get_field_type,
)

Type = Dict[str, Any]

_INT_DTYPE = np.int32


def from_dict(data: Dict[str, Any]) -> Type:
    """Canonicalize a raw dict of arrays into AtomicDataDict conventions."""
    out: Type = {}
    for k, v in data.items():
        if v is None:
            continue
        arr = np.asarray(v)
        if k in _LONG_FIELDS:
            arr = arr.astype(_INT_DTYPE)
        elif arr.dtype.kind == "f":
            arr = arr.astype(np.float64)
        elif arr.dtype.kind == "b":
            arr = arr.astype(bool)
        out[k] = arr

    n_atoms = None
    if _keys.POSITIONS_KEY in out:
        pos = out[_keys.POSITIONS_KEY]
        if pos.ndim != 2 or pos.shape[1] != 3:
            raise ValueError(f"pos must be (N, 3), got {pos.shape}")
        n_atoms = pos.shape[0]

    if _keys.CELL_KEY in out:
        cell = out[_keys.CELL_KEY]
        if cell.shape == (3, 3):
            cell = cell.reshape(1, 3, 3)
        if cell.ndim != 3 or cell.shape[-2:] != (3, 3):
            raise ValueError(f"cell must be (3, 3) or (F, 3, 3), got {cell.shape}")
        out[_keys.CELL_KEY] = cell
    if _keys.PBC_KEY in out:
        pbc = out[_keys.PBC_KEY]
        if pbc.ndim == 0:
            pbc = np.full((1, 3), bool(pbc))
        elif pbc.shape == (3,):
            pbc = pbc.reshape(1, 3)
        out[_keys.PBC_KEY] = pbc.astype(bool)

    for k in _CARTESIAN_TENSOR_FIELDS:
        if k in out and get_field_type(k) == "graph":
            t = out[k]
            if t.ndim == 2 and t.shape == (3, 3):
                out[k] = t.reshape(1, 3, 3)

    for k in list(out.keys()):
        v = out[k]
        ftype = get_field_type(k, error_on_unregistered=False)
        if k in (_keys.ATOM_TYPE_KEY, _keys.ATOMIC_NUMBERS_KEY, _keys.BATCH_KEY):
            out[k] = v.reshape(-1)
        elif ftype == "node" and v.ndim == 1 and k != _keys.NODE_MASK_KEY:
            out[k] = v.reshape(-1, 1)
        elif ftype == "graph" and k not in (
            _keys.CELL_KEY,
            _keys.PBC_KEY,
            _keys.FRAME_MASK_KEY,
            _keys.NUM_NODES_KEY,
        ):
            if v.ndim == 0:
                out[k] = v.reshape(1, 1)
            elif v.ndim == 1 and k not in _CARTESIAN_TENSOR_FIELDS:
                out[k] = v.reshape(-1, 1)

    if _keys.EDGE_INDEX_KEY in out:
        ei = out[_keys.EDGE_INDEX_KEY]
        if ei.ndim != 2 or ei.shape[0] != 2:
            raise ValueError(f"edge_index must be (2, E), got {ei.shape}")

    if n_atoms is not None and _keys.NUM_NODES_KEY not in out:
        if _keys.BATCH_KEY in out:
            nf = int(out[_keys.BATCH_KEY].max()) + 1 if out[_keys.BATCH_KEY].size else 1
            out[_keys.NUM_NODES_KEY] = np.bincount(
                out[_keys.BATCH_KEY], minlength=nf
            ).astype(_INT_DTYPE)
        else:
            out[_keys.NUM_NODES_KEY] = np.array([n_atoms], dtype=_INT_DTYPE)
    return out


def num_nodes(data: Type) -> int:
    return int(data[_keys.POSITIONS_KEY].shape[0])


def num_edges(data: Type) -> int:
    return int(data[_keys.EDGE_INDEX_KEY].shape[1])


def num_frames(data: Type) -> int:
    return int(data[_keys.NUM_NODES_KEY].shape[0])


def with_batch_(data: Type) -> Type:
    """Ensure batch/num_nodes fields exist (trivial single-frame batch)."""
    if _keys.BATCH_KEY in data:
        return data
    n = num_nodes(data)
    data[_keys.BATCH_KEY] = np.zeros(n, dtype=_INT_DTYPE)
    data.setdefault(_keys.NUM_NODES_KEY, np.array([n], dtype=_INT_DTYPE))
    return data


def batched_from_list(frames: Sequence[Type]) -> Type:
    """Concatenate single frames into one batched graph (host-side, no padding)."""
    frames = [dict(f) for f in frames]
    if not frames:
        raise ValueError("cannot batch zero frames")
    keys = set(frames[0].keys())
    for f in frames[1:]:
        if set(f.keys()) != keys:
            raise KeyError(f"inconsistent keys across frames: {keys} vs {set(f.keys())}")
    keys.discard(_keys.BATCH_KEY)
    keys.discard(_keys.NUM_NODES_KEY)

    out: Type = {}
    node_counts = [f[_keys.POSITIONS_KEY].shape[0] for f in frames]
    node_offsets = np.concatenate([[0], np.cumsum(node_counts)[:-1]])
    for k in keys:
        ftype = get_field_type(k, error_on_unregistered=False)
        if k == _keys.EDGE_INDEX_KEY:
            out[k] = np.concatenate(
                [f[k] + off for f, off in zip(frames, node_offsets)], axis=1
            ).astype(_INT_DTYPE)
        elif ftype in ("node", "edge"):
            out[k] = np.concatenate([f[k] for f in frames], axis=0)
        elif ftype == "graph":
            out[k] = np.concatenate([np.atleast_1d(f[k]) for f in frames], axis=0)
        else:
            out[k] = [f[k] for f in frames]
    out[_keys.BATCH_KEY] = np.concatenate(
        [np.full(n, i, dtype=_INT_DTYPE) for i, n in enumerate(node_counts)]
    )
    out[_keys.NUM_NODES_KEY] = np.asarray(node_counts, dtype=_INT_DTYPE)
    return out


def frame_from_batched(data: Type, index: int) -> Type:
    """One frame of a batched (optionally padded) numpy dict, without its
    padding (the JAX package's ``frame_from_batched``)."""
    nf = num_frames(data)
    if index < 0:
        index += nf
    if not 0 <= index < nf:
        raise IndexError(f"frame {index} of {nf}")
    node_sel = np.asarray(data[_keys.BATCH_KEY]) == index
    if _keys.NODE_MASK_KEY in data:
        node_sel = node_sel & np.asarray(data[_keys.NODE_MASK_KEY])
    node_idx = np.nonzero(node_sel)[0]

    out: Type = {}
    edge_idx = None
    if _keys.EDGE_INDEX_KEY in data:
        ei = np.asarray(data[_keys.EDGE_INDEX_KEY])
        edge_sel = np.isin(ei[0], node_idx)
        if _keys.EDGE_MASK_KEY in data:
            edge_sel = edge_sel & np.asarray(data[_keys.EDGE_MASK_KEY])
        edge_idx = np.nonzero(edge_sel)[0]
        remap = np.full(num_nodes(data), -1, dtype=_INT_DTYPE)
        remap[node_idx] = np.arange(len(node_idx), dtype=_INT_DTYPE)
        out[_keys.EDGE_INDEX_KEY] = remap[ei[:, edge_idx]]

    skip = (_keys.EDGE_INDEX_KEY, _keys.BATCH_KEY, _keys.NUM_NODES_KEY, _keys.NODE_MASK_KEY,
            _keys.EDGE_MASK_KEY, _keys.FRAME_MASK_KEY)
    for k, v in data.items():
        if k in skip or k.startswith(_keys.EDGE_LAYOUT_KEY_PREFIX):
            continue
        ftype = get_field_type(k, error_on_unregistered=False)
        v = np.asarray(v)
        if ftype == "node":
            out[k] = v[node_idx]
        elif ftype == "edge":
            if edge_idx is None:
                raise KeyError(f"edge field {k} without {_keys.EDGE_INDEX_KEY}")
            out[k] = v[edge_idx]
        elif ftype == "graph":
            out[k] = v[index : index + 1]
        else:
            out[k] = v
    out[_keys.NUM_NODES_KEY] = np.array([len(node_idx)], dtype=_INT_DTYPE)
    return out


def without_nodes(data: Type, which_nodes: np.ndarray) -> Type:
    """A copy of an unpadded frame or batch with the given nodes removed, and
    every edge that touches one of them (JAX ``without_nodes``)."""
    n = num_nodes(data)
    mask = np.ones(n, dtype=bool)
    mask[np.asarray(which_nodes)] = False
    keep_idx = np.nonzero(mask)[0]
    remap = np.full(n, -1, dtype=_INT_DTYPE)
    remap[keep_idx] = np.arange(len(keep_idx), dtype=_INT_DTYPE)
    out: Type = {}
    if _keys.EDGE_INDEX_KEY in data:
        ei = np.asarray(data[_keys.EDGE_INDEX_KEY])
        edge_keep = mask[ei[0]] & mask[ei[1]]
        out[_keys.EDGE_INDEX_KEY] = remap[ei[:, edge_keep]]
    for k, v in data.items():
        if k in (_keys.EDGE_INDEX_KEY, _keys.NUM_NODES_KEY) or k.startswith(_keys.EDGE_LAYOUT_KEY_PREFIX):
            continue
        ftype = get_field_type(k, error_on_unregistered=False)
        v = np.asarray(v)
        out[k] = v[keep_idx] if ftype == "node" else v[edge_keep] if ftype == "edge" else v
    if _keys.BATCH_KEY in out:
        nf = int(out[_keys.BATCH_KEY].max()) + 1 if len(out[_keys.BATCH_KEY]) else 1
        out[_keys.NUM_NODES_KEY] = np.bincount(out[_keys.BATCH_KEY], minlength=nf).astype(_INT_DTYPE)
    else:
        out[_keys.NUM_NODES_KEY] = np.array([len(keep_idx)], dtype=_INT_DTYPE)
    return out


def pad_batch(data: Type, n_nodes: int, n_edges: int, n_frames: Optional[int] = None) -> Type:
    """Pad a batched dict to static capacities and attach masks.

    Same contract as the JAX package: padded nodes go to the last frame
    slot, padded edges to the last node slot with zero cell shift, float
    padding is zeros, and real data is never truncated.
    """
    data = with_batch_(dict(data))
    N = num_nodes(data)
    E = num_edges(data) if _keys.EDGE_INDEX_KEY in data else 0
    F = num_frames(data)
    n_frames = F if n_frames is None else n_frames
    if n_nodes < N or n_edges < E or n_frames < F:
        raise ValueError(
            f"capacities ({n_nodes}, {n_edges}, {n_frames}) below sizes ({N}, {E}, {F})"
        )

    out: Type = {}
    pad_frame_index = n_frames - 1 if n_frames > F else F - 1
    for k, v in data.items():
        v = np.asarray(v)
        if k == _keys.EDGE_INDEX_KEY:
            padded = np.full((2, n_edges), n_nodes - 1, dtype=_INT_DTYPE)
            padded[:, :E] = v
            out[k] = padded
            continue
        if k == _keys.BATCH_KEY:
            padded = np.full(n_nodes, pad_frame_index, dtype=_INT_DTYPE)
            padded[:N] = v
            out[k] = padded
            continue
        ftype = get_field_type(k, error_on_unregistered=False)
        pad_to = {"node": n_nodes, "edge": n_edges, "graph": n_frames}.get(ftype)
        if pad_to is None or v.shape[0] == pad_to:
            out[k] = v
            continue
        padded = np.zeros((pad_to,) + v.shape[1:], dtype=v.dtype)
        padded[: v.shape[0]] = v
        out[k] = padded

    out[_keys.NODE_MASK_KEY] = np.arange(n_nodes) < N
    out[_keys.EDGE_MASK_KEY] = np.arange(n_edges) < E
    out[_keys.FRAME_MASK_KEY] = np.arange(n_frames) < F
    return out


def to_tensors(data: Type, device=None) -> Dict[str, torch.Tensor]:
    """numpy dict -> torch tensors on ``device`` (float64 / int64 / bool).

    A read-only array (a ``ShardDataset`` frame is a view into its mmap) is
    copied here, where it becomes a tensor, and nowhere earlier."""
    out = {}
    for k, v in data.items():
        v = np.asarray(v)
        if not v.flags.writeable:
            v = v.copy()
        if v.dtype.kind == "f":
            t = torch.as_tensor(v, dtype=torch.float64)
        elif v.dtype.kind in "iu":
            t = torch.as_tensor(v.astype(np.int64))
        elif v.dtype.kind == "b":
            t = torch.as_tensor(v)
        else:
            continue
        out[k] = t.to(device)
    return out


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple
