"""Edge vectors and edge types (differentiable in positions and cell).

Port of ``nequip_tpu/nn/graph_utils.py``.
"""

from __future__ import annotations

import torch

from ..data import _keys


def with_edge_vectors(data: dict, with_lengths: bool = True) -> dict:
    """``vec = pos[src] - pos[dst] + edge_cell_shift @ cell[batch[dst]]``.

    Padded edges (src = dst, zero shift) get zero vectors; lengths use a
    guarded sqrt so gradients stay finite.
    """
    data = dict(data)
    if _keys.EDGE_VECTORS_KEY not in data:
        pos = data[_keys.POSITIONS_KEY]
        edge_index = data[_keys.EDGE_INDEX_KEY]
        # index_select: its backward is an index_add, where advanced
        # indexing's is a sort-based accumulate (most of a 23k-atom force
        # call's device time on an H100)
        vec = torch.index_select(pos, 0, edge_index[1]) - torch.index_select(pos, 0, edge_index[0])
        if _keys.CELL_KEY in data:
            cell = data[_keys.CELL_KEY].reshape(-1, 3, 3)
            shifts = data[_keys.EDGE_CELL_SHIFT_KEY].to(vec.dtype)
            vec = vec + per_frame_matmul(shifts, cell, data[_keys.BATCH_KEY][edge_index[0]])
        data[_keys.EDGE_VECTORS_KEY] = vec
    vec = data[_keys.EDGE_VECTORS_KEY]
    if with_lengths and _keys.EDGE_LENGTH_KEY not in data:
        n2 = torch.sum(vec * vec, dim=-1, keepdim=True)
        pos_n2 = n2 > 0
        safe = torch.where(pos_n2, n2, torch.ones_like(n2))
        data[_keys.EDGE_LENGTH_KEY] = torch.where(pos_n2, torch.sqrt(safe), torch.zeros_like(n2))
    return data


def per_frame_matmul(rows: torch.Tensor, mats: torch.Tensor, frame: torch.Tensor) -> torch.Tensor:
    """``rows[i] @ mats[frame[i]]`` for rows (M, 3), mats (F, 3, 3).

    Multiplies by every frame's matrix and picks one, so the gradient with
    respect to ``mats`` is a dense reduction over rows rather than a
    scatter of M rows onto F (usually 1 or 2) matrices.
    """
    all_frames = torch.einsum("mi,fij->mfj", rows, mats)
    return torch.gather(all_frames, 1, frame.view(-1, 1, 1).expand(-1, 1, 3)).squeeze(1)


def with_edge_types(data: dict) -> dict:
    if _keys.EDGE_TYPE_KEY not in data:
        data = dict(data)
        types = data[_keys.ATOM_TYPE_KEY].reshape(-1)
        ei = data[_keys.EDGE_INDEX_KEY]
        data[_keys.EDGE_TYPE_KEY] = torch.stack([types[ei[0]], types[ei[1]]])
    return data
