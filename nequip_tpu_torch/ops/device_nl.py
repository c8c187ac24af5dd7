"""Fixed-capacity periodic cell-list neighbour list on the card.

Port of ``nequip_tpu/ops/device_nl.py`` (the JAX package's jittable list
for MD rebuilds on the device).  The host C++ cell list
(``data/_cpp_nl.py``) stays the default of data pipelines; this list is
the MD driver's ``nl_backend="device"``: skin rebuilds then never move
positions or edges across the host link, and a CUDA graph can hold them
(static shapes: a bucket capacity ``cell_cap`` and a per-atom capacity
``k_max``, with an overflow flag instead of dynamic sizes).

Algorithm (the JAX semantics):
  1. wrap the (possibly unwrapped) positions into the cell and bin them
     into a grid whose buckets are at least ``r_max`` thick, >= 3 a side;
  2. a bucket table of at most ``cell_cap`` atoms each (the lowest
     indices);
  3. every atom scans the 27 neighbouring buckets with their periodic
     image shifts; self-pairs are excluded in the zero image only;
  4. at most ``k_max`` neighbours an atom are kept, the nearest; the
     overflow flag is set when a bucket holds more than ``cell_cap`` atoms
     or an atom has more than ``k_max`` neighbours (and, for the stream
     form, when the real edges exceed the stream's capacity).

Output convention of ``data/neighborlist.py``: ``edge_index[0]`` = dst,
``edge_index[1]`` = src, and ``pos[src] + shift @ cell`` is the source
image within ``r_max`` of ``pos[dst]`` (raw positions).

``device_nl`` is the kernel's wrapper (``csrc/device_nl.cu`` on a CUDA
tensor, ``device_nl_plain`` on a CPU tensor; it counts its launches in
``.launches``).  It fills ``[N, k_max]`` neighbour slots (each atom's
neighbours in candidate order: bucket by bucket, each bucket by atom
index) and, given static buffers, the compacted edge stream in kernel
order (real edges first, by destination; padding edges after them).  The
geometry is computed with single roundings in the positions' dtype (no
matmul, so no TF32 and no reassociation): kernel and twin decide every
cutoff test alike.  ``device_neighbor_list`` returns the JAX package's
``[N * k_max]`` slot form; the MD driver's rebuild has ``device_nl`` fill
its padded batch's edge tensors in place.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..data import round_up
from .kernels import build
from .kernels.tp_scatter import KERNELS, _route

# the 27 neighbouring buckets, in the JAX order (i, j, k over -1, 0, 1)
_OFFSETS = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)]


def suggest_grid_dims(cell, r_max: float) -> Tuple[int, int, int]:
    """Largest grid whose buckets are at least ``r_max`` thick per axis.

    The 27-bucket search needs >= 3 buckets per axis; a box thinner than
    ``3 * r_max`` raises (use the host neighbour list)."""
    cell = np.asarray(cell, dtype=np.float64).reshape(3, 3)
    heights = 1.0 / np.linalg.norm(np.linalg.inv(cell), axis=0)
    dims = np.floor(heights / float(r_max)).astype(int)
    if not np.all(dims >= 3):
        raise ValueError(f"device_neighbor_list needs >= 3 grid cells per axis (got {dims}); box too thin "
                         "relative to r_max: use the host neighbour list")
    return tuple(int(d) for d in dims)


def size_capacities(pos, cell, grid_dims, edge_dst) -> Tuple[int, int]:
    """``(cell_cap, k_max)`` from a host build (numpy positions, cell and the
    real edges' destinations), with the JAX driver's headroom: 1.5x the
    fullest bucket and 1.25x the most neighbours an atom."""
    pos = np.asarray(pos, dtype=np.float64)
    dims = grid_dims
    fw = (pos @ np.linalg.inv(np.asarray(cell, dtype=np.float64).reshape(3, 3))) % 1.0
    cid = [np.clip((fw[:, i] * dims[i]).astype(int), 0, dims[i] - 1) for i in range(3)]
    flat = (cid[0] * dims[1] + cid[1]) * dims[2] + cid[2]
    cell_cap = round_up(int(np.bincount(flat).max() * 1.5) + 1, 4)
    k_max = round_up(int(np.bincount(np.asarray(edge_dst), minlength=len(pos)).max() * 1.25) + 1, 8)
    return int(cell_cap), int(k_max)


class CellGrid(NamedTuple):
    """A periodic box on the device: its cell and inverse in the positions'
    dtype, the grid and the cutoff.  Made once per box on the host
    (``cell_grid``): a CUDA graph of the list then copies nothing."""

    cell: torch.Tensor  # [3, 3]
    inv: torch.Tensor  # [3, 3]
    dims: Tuple[int, int, int]
    r_max: float


def cell_grid(cell, r_max: float, grid_dims, dtype: torch.dtype, device) -> CellGrid:
    cell = np.asarray(cell.cpu() if isinstance(cell, torch.Tensor) else cell, dtype=np.float64).reshape(3, 3)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device).contiguous()  # noqa: E731
    return CellGrid(as_t(cell), as_t(np.linalg.inv(cell)), tuple(int(d) for d in grid_dims), float(r_max))


class NeighborSlots(NamedTuple):
    """Neighbours an atom in ``k_max`` slots: ``src [N, k_max]`` and
    ``shift [N, k_max, 3]`` (int32, lattice units), the first ``count[i]``
    slots of row ``i`` real, the others ``src = i`` with a zero shift."""

    src: torch.Tensor
    shift: torch.Tensor
    count: torch.Tensor


# ---------------------------------------------------------------------------
# plain twin
# ---------------------------------------------------------------------------
def _vecmat(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``v @ m`` for ``v [..., 3]`` as ``(v0 m0 + v1 m1) + v2 m2``, each
    product and sum rounded once (the kernel's ``vecmat``)."""
    return v[..., 0:1] * m[0] + v[..., 1:2] * m[1] + v[..., 2:3] * m[2]


def device_nl_plain(pos, grid: CellGrid, cell_cap: int, k_max: int, overflow: torch.Tensor,
                    out=None, pad_index: int = 0) -> NeighborSlots:
    n, dev = pos.shape[0], pos.device
    dims = torch.tensor(grid.dims, dtype=torch.int64, device=dev)
    d0, d1, d2 = grid.dims
    n_cells = d0 * d1 * d2

    frac = _vecmat(pos, grid.inv)
    wrap_f = torch.floor(frac)
    fw = frac - wrap_f
    wrap = wrap_f.to(torch.int64)
    c3 = torch.minimum((fw * dims.to(pos.dtype)).to(torch.int64).clamp(min=0), dims - 1)
    wpos = _vecmat(fw, grid.cell)
    cid = (c3[:, 0] * d1 + c3[:, 1]) * d2 + c3[:, 2]

    # bucket table [n_cells, cell_cap] of atom indices (-1 empty), by index
    order = torch.argsort(cid, stable=True)
    counts = torch.bincount(cid, minlength=n_cells)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=dev) - starts[cid[order]]
    keep = rank < cell_cap
    table = torch.full((n_cells, cell_cap), -1, dtype=torch.int64, device=dev)
    table[cid[order][keep], rank[keep]] = order[keep]

    offs = torch.tensor(_OFFSETS, dtype=torch.int64, device=dev)  # [27, 3]
    ncoord = c3[:, None, :] + offs[None]
    img = torch.div(ncoord, dims, rounding_mode="floor")  # [N, 27, 3]
    w = ncoord - img * dims
    ncid = (w[..., 0] * d1 + w[..., 1]) * d2 + w[..., 2]
    cand = table[ncid]  # [N, 27, C]
    safe = cand.clamp(min=0)
    ic = _vecmat(img.to(pos.dtype), grid.cell)  # [N, 27, 3]
    ws = wpos[safe]  # [N, 27, C, 3]
    dl = [(ws[..., k] + ic[:, :, None, k]) - wpos[:, None, None, k] for k in range(3)]
    dist2 = (dl[0] * dl[0] + dl[1] * dl[1]) + dl[2] * dl[2]
    r = torch.tensor(grid.r_max, dtype=pos.dtype)
    is_self = (cand == torch.arange(n, device=dev)[:, None, None]) & (img == 0).all(-1)[:, :, None]
    valid = (cand >= 0) & (dist2 <= r * r) & ~is_self

    n_flat = 27 * cell_cap
    valid = valid.reshape(n, n_flat)
    key = torch.where(valid, dist2.reshape(n, n_flat), torch.full_like(dist2.reshape(n, n_flat), float("inf")))
    n_valid = valid.sum(1)
    # the k_max nearest (ties to the lower slot), then back in slot order
    nearest = torch.argsort(key, dim=1, stable=True)[:, :k_max]
    kept = torch.zeros_like(valid).scatter_(1, nearest, torch.gather(valid, 1, nearest))
    take = torch.argsort((~kept).to(torch.int8), dim=1, stable=True)[:, :k_max]
    count = kept.sum(1)
    width = take.shape[1]
    rows = torch.arange(n, device=dev)[:, None]
    real = torch.arange(width, device=dev)[None] < count[:, None]
    src = torch.where(real, torch.gather(cand.reshape(n, n_flat), 1, take), rows)
    img_flat = img[:, :, None, :].expand(n, 27, cell_cap, 3).reshape(n, n_flat, 3)
    shift = (wrap[:, None, :] - wrap[src]) + torch.gather(img_flat, 1, take[..., None].expand(n, width, 3))
    shift = torch.where(real[..., None], shift, torch.zeros_like(shift))
    if width < k_max:  # fewer candidate slots than the per-atom capacity
        src = torch.cat([src, rows.expand(n, k_max - width)], 1)
        shift = torch.cat([shift, shift.new_zeros(n, k_max - width, 3)], 1)

    over = bool((counts > cell_cap).any()) or bool((n_valid > k_max).any())
    if out is not None:
        edge_index, shifts, mask = out
        e_cap = mask.shape[0]
        off = torch.cumsum(count, 0) - count
        slot = torch.arange(k_max, device=dev)[None]
        e = (off[:, None] + slot).reshape(-1)
        write = (slot < count[:, None]).reshape(-1) & (e < e_cap)
        e = e[write]
        edge_index.fill_(pad_index)
        shifts.zero_()
        mask.zero_()
        edge_index[0, e] = rows.expand(n, k_max).reshape(-1)[write].to(edge_index.dtype)
        edge_index[1, e] = src.reshape(-1)[write].to(edge_index.dtype)
        shifts[e] = shift.reshape(-1, 3)[write].to(shifts.dtype)
        mask[e] = True
        over = over or int(count.sum()) > e_cap
    if over:
        overflow.fill_(1)
    return NeighborSlots(src.to(torch.int32), shift.to(torch.int32), count.to(torch.int32))


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------
def device_nl(pos, grid: CellGrid, cell_cap: int, k_max: int, overflow: torch.Tensor,
              out: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
              pad_index: int = 0) -> NeighborSlots:
    """The neighbour slots of ``pos [N, 3]`` (see ``NeighborSlots``) and,
    with ``out = (edge_index [2, E] int64, shifts [E, 3], mask [E] bool)``,
    the compacted stream written into them: real edges in the first slots
    in destination order, then padding edges ``(pad_index, pad_index)``
    with a zero shift.  Sets ``overflow`` (int32 ``[1]``) to 1 on a
    bucket, per-atom or stream overflow and never clears it.  Launches
    ``csrc/device_nl.cu`` for CUDA tensors, synchronising with nothing on
    the host; runs ``device_nl_plain`` for CPU tensors."""
    if not (isinstance(cell_cap, int) and isinstance(k_max, int) and cell_cap > 0 and k_max > 0):
        raise ValueError(f"cell_cap ({cell_cap!r}) and k_max ({k_max!r}) must be positive ints")
    if pos.dim() != 2 or pos.shape[1] != 3:
        raise ValueError(f"device_nl: positions must be [N, 3], not {tuple(pos.shape)}")
    if overflow.device != pos.device or overflow.dtype != torch.int32 or overflow.numel() != 1:
        raise ValueError("device_nl: overflow must be one int32 on the positions' device")
    if out is not None:
        edge_index, shifts, mask = out
        e_cap = mask.shape[0]
        if (edge_index.dtype != torch.int64 or tuple(edge_index.shape) != (2, e_cap) or mask.dtype != torch.bool
                or shifts.dtype != pos.dtype or tuple(shifts.shape) != (e_cap, 3)):
            raise ValueError("device_nl: out must be (edge_index [2, E] int64, shifts [E, 3] in the positions' "
                             "dtype, mask [E] bool)")
        if not all(t.device == pos.device and t.is_contiguous() for t in out):
            raise ValueError("device_nl: out must be contiguous on the positions' device")
    if not _route("device_nl", pos, grid.cell, grid.inv):
        return device_nl_plain(pos, grid, cell_cap, k_max, overflow, out, pad_index)
    n, dev = pos.shape[0], pos.device
    d0, d1, d2 = grid.dims
    n_cells = d0 * d1 * d2
    i32 = dict(dtype=torch.int32, device=dev)
    wpos = torch.empty(n, 3, dtype=pos.dtype, device=dev)
    wrap, cid = torch.empty(n, 3, **i32), torch.empty(n, **i32)
    count, start, cursor = torch.zeros(n_cells, **i32), torch.empty(n_cells + 1, **i32), torch.zeros(n_cells, **i32)
    order = torch.empty(n, **i32)
    slots = NeighborSlots(torch.empty(n, k_max, **i32), torch.empty(n, k_max, 3, **i32), torch.empty(n, **i32))
    off = torch.empty(n + 1, **i32)
    e_cap, ptrs = 0, (0, 0, 0)
    if out is not None:
        e_cap, ptrs = out[2].shape[0], tuple(t.data_ptr() for t in out)
    err = build.entry_point("nequip_device_nl", pos.dtype)(
        pos.data_ptr(), grid.cell.data_ptr(), grid.inv.data_ptr(), n, d0, d1, d2, grid.r_max, cell_cap, k_max,
        wpos.data_ptr(), wrap.data_ptr(), cid.data_ptr(), count.data_ptr(), start.data_ptr(), cursor.data_ptr(),
        order.data_ptr(), slots.src.data_ptr(), slots.shift.data_ptr(), slots.count.data_ptr(), off.data_ptr(),
        e_cap, pad_index, *ptrs, overflow.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "device_nl")
    device_nl.launches += 1
    return slots


device_nl.launches = 0
KERNELS["device_nl"] = device_nl


# ---------------------------------------------------------------------------
# the two forms
# ---------------------------------------------------------------------------
def device_neighbor_list(pos: torch.Tensor, cell, r_max: float, grid_dims, cell_cap: int, k_max: int):
    """The JAX package's form: ``(edge_index [2, N * k_max] int64, shifts
    [N * k_max, 3] in the positions' dtype, mask [N * k_max] bool,
    overflow (0-d bool))``, dst-major; masked slots have ``dst = src =``
    their row atom and a zero shift."""
    grid = cell_grid(cell, r_max, grid_dims, pos.dtype, pos.device)
    overflow = torch.zeros(1, dtype=torch.int32, device=pos.device)
    slots = device_nl(pos.contiguous(), grid, cell_cap, k_max, overflow)
    n = pos.shape[0]
    dst = torch.arange(n, device=pos.device).repeat_interleave(k_max)
    mask = (torch.arange(k_max, device=pos.device)[None] < slots.count[:, None]).reshape(-1)
    edge_index = torch.stack([dst, slots.src.reshape(-1).long()])
    return edge_index, slots.shift.reshape(-1, 3).to(pos.dtype), mask, overflow[0] != 0
