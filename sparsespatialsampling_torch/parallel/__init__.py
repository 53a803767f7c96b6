"""The multi-device layer: a 1-D mesh of devices along the cell axis and
the sharded kNN index, interpolation and randomized SVD over it (the JAX
package's ``parallel/``)."""
from .mesh import (CELL_AXIS, Mesh, default_mesh, make_mesh,
                   sharding_enabled)
from .interpolate import sharded_interpolate
from .svd import distributed_rsvd, distributed_rsvd_device
from .knn import ShardedKNNIndex, sharded_index_from_reference

__all__ = ["CELL_AXIS", "Mesh", "make_mesh", "default_mesh",
           "sharding_enabled", "sharded_interpolate", "distributed_rsvd",
           "distributed_rsvd_device",
           "ShardedKNNIndex", "sharded_index_from_reference"]
