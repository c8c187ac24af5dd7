"""Host-side neighbour list (scipy cKDTree backend).

Port of ``nequip_tpu/data/neighborlist.py`` (``_kdtree_nl`` and
``compute_neighborlist_``).  The C++ cell list of the JAX package is not
ported yet.

Convention (same as the JAX package): ``edge_index[0]`` = center (dst),
``edge_index[1]`` = neighbour (src), integer ``edge_cell_shift`` such that
``vec = pos[src] - pos[dst] + shift @ cell``.  Full directed list; self-edges
through periodic images are kept, the trivial self-edge is not.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from . import _keys


def neighbor_list(
    pos: np.ndarray,
    r_max: float,
    cell: Optional[np.ndarray] = None,
    pbc=(False, False, False),
) -> Tuple[np.ndarray, np.ndarray]:
    """Return ``(edge_index (2, E) int32, edge_cell_shift (E, 3) float64)``."""
    from scipy.spatial import cKDTree

    pos = np.asarray(pos, dtype=np.float64)
    r_max = float(r_max)
    n = pos.shape[0]
    pbc = np.asarray(pbc, dtype=bool).reshape(-1)
    if pbc.size == 1:
        pbc = np.repeat(pbc, 3)

    if cell is None or not pbc.any():
        pairs = cKDTree(pos).query_pairs(r_max, output_type="ndarray")
        if pairs.size == 0:
            return np.zeros((2, 0), dtype=np.int32), np.zeros((0, 3))
        dst = np.concatenate([pairs[:, 0], pairs[:, 1]])
        src = np.concatenate([pairs[:, 1], pairs[:, 0]])
        edge_index = np.stack([dst, src]).astype(np.int32)
        return edge_index, np.zeros((edge_index.shape[1], 3))

    cell = np.asarray(cell, dtype=np.float64).reshape(3, 3)
    # periodic images per axis from the lattice-plane spacings
    inv = np.linalg.inv(cell)
    heights = 1.0 / np.linalg.norm(inv, axis=0)
    n_rep = np.where(pbc, np.ceil(r_max / heights).astype(int), 0)

    # wrap into the cell along periodic axes; the integer wrap vectors are
    # folded back into the shifts so the contract holds for the input positions
    frac = pos @ inv
    wrap = np.where(pbc, np.floor(frac), 0.0)
    pos = (frac - wrap) @ cell

    shifts = np.array(
        [
            (i, j, k)
            for i in range(-n_rep[0], n_rep[0] + 1)
            for j in range(-n_rep[1], n_rep[1] + 1)
            for k in range(-n_rep[2], n_rep[2] + 1)
        ],
        dtype=np.float64,
    )
    images = (pos[None, :, :] + (shifts @ cell)[:, None, :]).reshape(-1, 3)
    neigh = cKDTree(images).query_ball_point(pos, r_max)

    counts = np.fromiter((len(nb) for nb in neigh), dtype=np.int64, count=n)
    if counts.sum() == 0:
        return np.zeros((2, 0), dtype=np.int32), np.zeros((0, 3))
    flat = np.fromiter(
        (j for nb in neigh for j in nb), dtype=np.int64, count=int(counts.sum())
    )
    dst = np.repeat(np.arange(n, dtype=np.int64), counts)
    s_idx, src = np.divmod(flat, n)
    keep = ~((src == dst) & np.all(shifts[s_idx] == 0, axis=1))
    dst, src, s_idx = dst[keep], src[keep], s_idx[keep]
    edge_cell_shift = shifts[s_idx] + wrap[dst] - wrap[src]
    edge_index = np.stack([dst, src]).astype(np.int32)
    return edge_index, edge_cell_shift


def compute_neighborlist_(data: dict, r_max: float) -> dict:
    """In-place neighbour-list construction on a host AtomicDataDict."""
    cell = data.get(_keys.CELL_KEY)
    if cell is not None:
        cell = np.asarray(cell).reshape(3, 3)
    pbc = data.get(_keys.PBC_KEY, np.zeros(3, dtype=bool))
    edge_index, shifts = neighbor_list(
        data[_keys.POSITIONS_KEY], r_max, cell=cell, pbc=np.asarray(pbc).reshape(-1)
    )
    for k in [k for k in data if k.startswith(_keys.EDGE_LAYOUT_KEY_PREFIX)]:
        del data[k]  # layouts derive from the edge list and are stale now
    data[_keys.EDGE_INDEX_KEY] = edge_index
    if cell is not None:
        data[_keys.EDGE_CELL_SHIFT_KEY] = shifts
    return data
