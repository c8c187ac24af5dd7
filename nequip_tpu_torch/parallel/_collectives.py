"""Differentiable collectives over a process group.

JAX differentiates its SPMD collectives itself: the transpose of
``all_gather`` is a sum of the cotangents over the mesh axis followed by a
slice.  With one process per device that transpose is written here, as a
pair of ``torch.autograd.Function``s that are each other's backward:

    Gather:       y = stack over ranks of x                 [D, *x.shape]
    ReduceSlice:  x = (sum over ranks of y)[rank]           [*x.shape]

Both backwards call ``apply`` of the other, so a graph built with
``create_graph=True`` (forces with the parameters' gradients still to come,
reverse over reverse) differentiates through them again.

The gather is an all-gather into one buffer (``all_gather_single``, or
``all_gather_into_tensor`` where torch predates it), which NCCL and gloo
both run on CUDA tensors (gloo copies them through host memory); the
reduce-slice is an ``all_reduce`` and a slice (a reduce-scatter would move
less, but gloo is not known to run one on CUDA tensors).  Every rank must
call the same collectives in the same order; the callers keep every rank's
graph the same shape (shared capacities), so the autograd engine reaches
them in the same order on every rank.

``group`` is a ``torch.distributed`` process group, or None outside a
distributed run (one process: the collectives are the identity on its one
slot).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def group_size(group) -> int:
    if group is None or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def group_rank(group) -> int:
    if group is None or not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A reduced copy of ``x`` over ``group`` (not differentiated)."""
    out = x.detach().clone()
    if group_size(group) > 1:
        dist.all_reduce(out, op=op, group=group)
    return out


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    d = group_size(group)
    if d == 1:
        return x.unsqueeze(0).clone()
    buf = x.new_empty((d, x.numel()))  # ranks' rows concatenated: the form every backend takes
    all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    all_gather(buf, x.contiguous().view(1, -1), group=group)
    return buf.view((d,) + tuple(x.shape))


def _reduce_slice(y: torch.Tensor, group) -> torch.Tensor:
    return all_reduce(y, group)[group_rank(group)]


class Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x.detach(), group)

    @staticmethod
    def backward(ctx, g):
        return ReduceSlice.apply(g.contiguous(), ctx.group), None


class ReduceSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return _reduce_slice(y.detach(), group)

    @staticmethod
    def backward(ctx, g):
        return Gather.apply(g.contiguous(), ctx.group), None


def gather(x: torch.Tensor, group) -> torch.Tensor:
    """``[D, *x.shape]``: every rank's ``x`` (JAX ``all_gather``), differentiable
    to any order."""
    return Gather.apply(x, group)


def gather_rows(x: torch.Tensor, group, owner_dev: torch.Tensor, owner_idx: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rows ``owner_idx`` of rank ``owner_dev``'s ``x`` (``[G, *x.shape[1:]]``),
    zero where ``mask`` is False: JAX's ``all_gather(x)[dev, idx]``."""
    flat = gather(x, group).reshape((-1,) + tuple(x.shape[1:]))
    rows = flat.index_select(0, owner_dev.long() * x.shape[0] + owner_idx.long())
    if mask is not None:
        rows = torch.where(mask.reshape((-1,) + (1,) * (rows.dim() - 1)), rows, torch.zeros_like(rows))
    return rows


def all_reduce_grads(grads, group) -> list:
    """The gradients summed over ``group`` in one collective (a flat buffer)."""
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
    out, i = [], 0
    for g in grads:
        out.append(flat[i: i + g.numel()].view_as(g))
        i += g.numel()
    return out
