"""Meshes of ranks: one process group per axis.

Port of ``nequip_tpu/parallel/mesh.py``.  JAX lays devices out on a
``jax.sharding.Mesh`` and names an axis inside ``shard_map``; here a
``Mesh`` lays the ranks of the default process group out row-major (as
``jax.make_mesh`` lays out devices: rank ``i_dp * n_graph + i_graph`` on
``("dp", "graph")``) and holds, for each axis, the process group of the
ranks that differ only along it, plus this rank's coordinate.  Outside a
distributed run a mesh has one rank and no groups (collectives over it are
the identity).
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence

import numpy as np
import torch.distributed as dist


def device_count() -> int:
    """The world size: ranks (one device each) of the run."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class Mesh:
    """``shape`` ({axis: size}) and ``coords`` ({axis: this rank's index});
    ``group(axes)`` is the process group spanning one or several axes (the
    world for all of them; None in a single process)."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str]):
        sizes, names = tuple(int(s) for s in axis_sizes), tuple(axis_names)
        if len(sizes) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh axes {names} and sizes {sizes} do not match")
        world = device_count()
        if int(np.prod(sizes)) != world:
            raise ValueError(f"a mesh of {dict(zip(names, sizes))} needs {int(np.prod(sizes))} ranks; "
                             f"the run has {world}")
        self.shape: Dict[str, int] = dict(zip(names, sizes))
        self.axis_names = names
        grid = np.arange(world).reshape(sizes)
        here = np.argwhere(grid == process_index())[0]
        self.coords: Dict[str, int] = {n: int(c) for n, c in zip(names, here)}
        self._groups: Dict[tuple, Optional[object]] = {}
        if world == 1:
            return
        # every rank creates every group, in the same order (torch.distributed's rule)
        for r in range(1, len(names) + 1):
            for axes in itertools.combinations(range(len(names)), r):
                key = tuple(names[a] for a in axes)
                if len(axes) == len(names):
                    self._groups[key] = dist.group.WORLD
                    continue
                moved = np.moveaxis(grid, axes, tuple(range(len(names) - len(axes), len(names))))
                for ranks in moved.reshape(-1, int(np.prod([sizes[a] for a in axes]))):
                    g = dist.new_group([int(x) for x in ranks])
                    if process_index() in ranks:
                        self._groups[key] = g

    def group(self, axes) -> Optional[object]:
        """The process group over ``axes`` (a name or names, in mesh order)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        key = tuple(n for n in self.axis_names if n in axes)
        if len(key) != len(axes):
            raise KeyError(f"axes {axes} not all in the mesh {self.axis_names}")
        return self._groups.get(key)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, coords={self.coords})"


def make_mesh(axis_sizes: Optional[Sequence[int]] = None, axis_names: Sequence[str] = ("dp",)) -> Mesh:
    """A mesh of the run's ranks; defaults to all of them on one data-parallel axis."""
    if axis_sizes is None:
        axis_sizes = (device_count(),)
    return Mesh(axis_sizes, axis_names)
