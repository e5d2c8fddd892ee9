"""Data parallelism over processes, and point-sharded ops over devices.

Counterpart of ``pointnet2_tpu/parallel``: ``mesh`` (the devices a batch is
split over), ``multihost`` (the process group, its collectives, the rows of a
rank) and ``sharded_ops`` (kNN, 3-NN and densify with the points split over
devices). The sharded ops are loaded on first use: ``nn.layers`` imports
this package, and the sharded ops import the model's modules.
"""

from pointnet2_tpu_torch.parallel.mesh import create_mesh, pad_batch_to_devices, shard_batch
from pointnet2_tpu_torch.parallel.multihost import local_rows, maybe_initialize_distributed

_SHARDED = ("densify_labels_sharded", "knn_sharded", "three_nn_sharded")

__all__ = [
    "create_mesh",
    "pad_batch_to_devices",
    "shard_batch",
    "local_rows",
    "maybe_initialize_distributed",
    *_SHARDED,
]


def __getattr__(name: str):
    if name in _SHARDED:
        from pointnet2_tpu_torch.parallel import sharded_ops

        return getattr(sharded_ops, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
