"""Data-parallel training over ranks.

Port of ``nequip_tpu/parallel/dp.py`` with one process per device.  Every
rank runs the same seeded loader and ``group_batches`` hands rank r the
r-th micro-batch of each group of ``n_devices``; inside the step
(``NequIPTrainModule.training_step(..., group=)``) the masked loss sums are
merged over the ranks before the loss is formed and the gradients are
all-reduced after the backward; that merged loss is the value an optimizer
reading it (``polyak_sgd``, ``reduce_on_plateau``) is handed on every rank.  So every rank takes the exact global-batch
step, the JAX ``DataParallel`` step, which is the single-device step over
the same frames (no loss * world_size compensation, cf. DDP), and the
replicated parameters stay equal on every rank.  Metric sums merge the
same way, so epoch metrics do not depend on the device count.

JAX's ``stack_microbatches``, ``batch_pspecs`` and ``shard_batch_for_dp``
place one stacked super-batch on a device mesh for ``shard_map``; with a
process per device each rank holds only its own micro-batch, so they have
no counterpart here.
"""

from __future__ import annotations

import inspect
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from ..data import _keys
from .mesh import Mesh, make_mesh


def mask_out_batch(batch: dict) -> dict:
    """A copy of a padded batch with every padding mask set to False.

    The tail filler when the micro-batches do not divide among the ranks:
    a fully masked micro-batch adds exactly zero to the merged loss sums,
    the metric sums and (through the masked errors) the gradients, so the
    step stays exact with no rescaling and no dropped data.
    """
    out = dict(batch)
    for k in (_keys.NODE_MASK_KEY, _keys.EDGE_MASK_KEY, _keys.FRAME_MASK_KEY):
        if k in out:
            v = out[k]
            out[k] = torch.zeros_like(v) if isinstance(v, torch.Tensor) else np.zeros_like(v)
    return out


def _signature(batch: dict) -> tuple:
    return tuple(sorted((k, tuple(np.shape(v))) for k, v in batch.items()))


class DataParallel:
    """Runs a training module's steps data-parallel over the ``axis_name``
    axis of ``mesh`` (all ranks on one axis by default)."""

    def __init__(self, module, mesh: Optional[Mesh] = None, axis_name: str = "dp"):
        if "group" not in inspect.signature(module.training_step).parameters:
            raise NotImplementedError(f"{type(module).__name__} has no data-parallel training step")
        self.module = module
        self.mesh = mesh if mesh is not None else make_mesh(axis_names=(axis_name,))
        self.axis_name = axis_name
        self.n_devices = self.mesh.shape[axis_name]
        self.index = self.mesh.coords[axis_name]
        self.group = self.mesh.group(axis_name)

    def training_step(self, batch: dict, loss_coeffs=None) -> Dict[str, torch.Tensor]:
        return self.module.training_step(batch, loss_coeffs, group=self.group)

    def evaluation_step(self, metrics, state, batch: dict):
        """The merged metric state; no outputs (they stay on their ranks)."""
        state, _ = self.module.evaluation_step(metrics, state, batch, group=self.group)
        return state, None

    def group_batches(self, batches: Iterable[dict]) -> Iterator[dict]:
        """This rank's micro-batch of each group of ``n_devices``.

        Micro-batches are grouped by their padded shapes (so capacity
        buckets compose with data parallel: the ranks of a step always hold
        one shape), flushed in first-seen order; at the end each bucket's
        tail is filled with fully masked copies of its last micro-batch.
        The order and the groups are JAX ``DataParallel.group_batches``'.
        """
        bufs: Dict[tuple, List[dict]] = {}
        order: List[tuple] = []
        for b in batches:
            sig = _signature(b)
            if sig not in bufs:
                bufs[sig] = []
                order.append(sig)
            bufs[sig].append(b)
            if len(bufs[sig]) == self.n_devices:
                yield bufs[sig][self.index]
                bufs[sig] = []
        for sig in order:
            buf = bufs[sig]
            if buf:
                yield buf[self.index] if self.index < len(buf) else mask_out_batch(buf[-1])
