"""Parallel execution on ``torch.distributed``, one process per device.

Port of ``nequip_tpu/parallel``: data-parallel training (``DataParallel``,
``Trainer(devices=N)``), sharded-graph serving and training with an
in-graph ghost exchange (``ShardedGraphEvaluator``), and both at once on a
2-D mesh (``SpatialTrainModule``).  JAX's ``stack_microbatches`` and
``shard_batch_for_dp`` have no counterpart (``parallel/dp.py`` says why).
"""

from .distributed import init_distributed
from .dp import DataParallel
from .ghost import (
    ShardedGraphEvaluator,
    disable_MeshGhostExchange,
    enable_MeshGhostExchange,
    spatial_partition,
)
from .mesh import device_count, make_mesh
from .spatial_train import (
    EMASpatialTrainModule,
    SpatialFrameDataModule,
    SpatialFrameLoader,
    SpatialTrainModule,
    make_2d_mesh,
    prepare_spatial_batch,
)

__all__ = [
    "make_mesh",
    "init_distributed",
    "device_count",
    "DataParallel",
    "ShardedGraphEvaluator",
    "spatial_partition",
    "enable_MeshGhostExchange",
    "disable_MeshGhostExchange",
    "SpatialTrainModule",
    "EMASpatialTrainModule",
    "SpatialFrameLoader",
    "SpatialFrameDataModule",
    "make_2d_mesh",
    "prepare_spatial_batch",
]
